"""GPLVM — Gaussian-process latent-variable model (counterpart of
``fvgp_tpu/models/gplvm.py``).

The latent coordinates are parameters: the objective — kernel assembly over
the latent X, Cholesky, the multi-output marginal likelihood and a
standard-normal prior on X — is differentiated by autograd over
(X, log hyperparameters, log noise).

* ``train(method=...)`` dispatches ``adam`` (joint latents + hps, the
  default; optax's ``adam(lr)`` written out in ``gp_training.adam_step``),
  ``local`` (joint L-BFGS-B on the same value and gradient), ``mcmc``
  (adaptive Metropolis over the hyperparameter vector through the port's
  ``gpMCMC``; ``sample_latent=True`` appends the flattened latents), or a
  user callable.
* ``hyperparameter_bounds`` boxes the vector ``[kernel hps..., noise]``.
* The posterior suite — mean / covariance and their latent gradients, the
  joint prior, entropy, KL divergence, mutual information — evaluates at
  new latent coordinates, with autograd off, so on the card the default
  kernel's covariances run on the K3 kernel.  The latent gradients are
  forward-mode AD, one latent direction at a time (K3 sees the tangent and
  stays out); the joint-prior family's (N+n)² log-determinants run on the
  model's device in float64.

Model: Y (N, Q) observed; X (N, L) latent;  KV = k(X, X) + noise·I;
LML = -0.5 [ Q·log|KV| + tr(KV⁻¹ Y Yᵀ) + N·Q·log 2π ] - 0.5‖X‖².
"""

import math
import warnings

import numpy as np
import torch
from torch.autograd import forward_ad

from .. import config
from ..kernels import default_matern_ard
from .gp_posterior import GPposterior
from .gp_training import adam_step
from .gpm import multi_output_neg_lml

__all__ = ["GPLVM"]

_JITTER = 1e-9


def _entropy(S):
    """Differential entropy of N(·, S); S a float64 device tensor."""
    d = S.shape[0]
    ldet = float(torch.linalg.slogdet(S)[1])
    return d / 2.0 + (d / 2.0) * math.log(2.0 * math.pi) + 0.5 * ldet


def _jittered(S):
    return S + _JITTER * torch.eye(S.shape[0], dtype=S.dtype,
                                   device=S.device)


class GPLVM:
    """Latent-variable GP: learns an (N, latent_dim) embedding of
    high-dimensional observations by maximizing the multi-output marginal
    likelihood.

    Parameters
    ----------
    y_data : (N, Q) observations.
    latent_dim : dimensionality L of the latent space.
    kernel_function : torch kernel k(x1, x2, hps); default anisotropic
        Matérn-3/2 ARD over the latent space (hps = [var, l_1..l_L]).
    init_latent : (N, L) initial embedding; default PCA of y_data.
    init_hyperparameters : default ones(L+1).
    noise : observation noise variance (learned in log space).
    args : optional dict; ``args["dtype"]`` sets the dtype as in ``GP``.
    compute_device : ``"cuda"`` (the default) or ``"cpu"``; float32 on the
        card, float64 on the CPU, unless ``args["dtype"]`` says otherwise.
    """

    def __init__(self, y_data, latent_dim=2, kernel_function=None,
                 init_latent=None, init_hyperparameters=None, noise=1e-2,
                 args=None, compute_device="cuda"):
        y = np.asarray(y_data, dtype=np.float64)
        if y.ndim != 2:
            raise AssertionError("y_data must be (N, Q)")
        self.args = dict(args) if args else {}
        self.device = config.resolve_device(compute_device)
        self.dtype = config.linalg_dtype(self.args, self.device)
        self.n, self.q = y.shape
        self.latent_dim = int(latent_dim)
        self.kernel = kernel_function or default_matern_ard
        self._y_mean = y.mean(axis=0)
        self._y = self._tensor(y - self._y_mean)

        if init_latent is None:
            # PCA initialization (the standard GPLVM seed)
            yc = y - self._y_mean
            _, _, vt = np.linalg.svd(yc, full_matrices=False)
            init_latent = yc @ vt[: self.latent_dim].T
            init_latent /= max(init_latent.std(), 1e-12)
        if init_hyperparameters is None:
            init_hyperparameters = np.ones(self.latent_dim + 1)
        self.X = self._tensor(init_latent)
        self.hyperparameters = np.asarray(init_hyperparameters,
                                          dtype=np.float64)
        self.log_noise = float(np.log(noise))
        self._mcmc_info = None

    def _tensor(self, a):
        return config.to_tensor(a, self.device, self.dtype)

    # ------------------------------------------------------------------
    def _neg_lml(self, X, log_hps, log_noise):
        K = self.kernel(X, X, torch.exp(log_hps))
        # a standard-normal prior on X regularizes the embedding scale
        return multi_output_neg_lml(K, log_noise, self._y) \
            + 0.5 * torch.sum(X * X)

    def _value_and_grad(self, params, wrt):
        """(-LML, its gradients with respect to ``params[i]`` for i in
        ``wrt``)."""
        params = [p.detach().clone().requires_grad_(i in wrt)
                  for i, p in enumerate(params)]
        with torch.enable_grad():
            val = self._neg_lml(*params)
            grads = torch.autograd.grad(val, [params[i] for i in wrt])
        return val.detach(), grads

    def _params(self):
        return (self.X, self._tensor(np.log(self.hyperparameters)),
                self._tensor(self.log_noise))

    # -- hyperparameter-vector convention: [kernel hps..., noise variance] --
    def get_hyperparameters(self):
        """The committed vector ``[kernel hps..., noise variance]``."""
        return np.append(self.hyperparameters, np.exp(self.log_noise))

    def set_hyperparameters(self, hps):
        """Commit a ``[kernel hps..., noise variance]`` vector."""
        hps = np.asarray(hps, dtype=np.float64)
        if len(hps) != len(self.hyperparameters) + 1:
            raise AssertionError(
                f"expected {len(self.hyperparameters) + 1} entries "
                "([kernel hps..., noise variance])")
        if np.any(hps <= 0.0):
            raise AssertionError("hyperparameters must be positive")
        self.hyperparameters = hps[:-1]
        self.log_noise = float(np.log(hps[-1]))

    def _params_from_theta(self, theta, X=None):
        theta = np.asarray(theta, dtype=np.float64)
        X = self.X if X is None else self._tensor(X)
        return (X, self._tensor(np.log(theta[:-1])),
                self._tensor(np.log(theta[-1])))

    def log_likelihood(self, hyperparameters=None):
        """Multi-output marginal log-likelihood; optional
        ``[kernel hps..., noise]`` override."""
        params = (self._params() if hyperparameters is None
                  else self._params_from_theta(hyperparameters))
        with torch.no_grad():
            return -float(self._neg_lml(*params))

    def neg_log_likelihood_gradient(self, hyperparameters=None):
        """Gradient of the negative LML w.r.t. ``[kernel hps..., noise]``
        at fixed latents, chained through the log-space parameterization."""
        theta = (self.get_hyperparameters() if hyperparameters is None
                 else np.asarray(hyperparameters, dtype=np.float64))
        _, (g_lh, g_ln) = self._value_and_grad(
            self._params_from_theta(theta), (1, 2))
        return np.append(config.to_numpy(g_lh), float(g_ln)) / theta

    def test_log_likelihood_gradient(self, hyperparameters=None,
                                     epsilon=1e-6):
        """FD-vs-analytic self-test: ``(analytic, finite differences)``."""
        theta = (self.get_hyperparameters() if hyperparameters is None
                 else np.asarray(hyperparameters, dtype=np.float64))
        analytic = self.neg_log_likelihood_gradient(theta)
        fd = np.zeros_like(theta)
        for i in range(len(theta)):
            up, dn = theta.copy(), theta.copy()
            up[i] += epsilon
            dn[i] -= epsilon
            fd[i] = (-self.log_likelihood(up)
                     + self.log_likelihood(dn)) / (2.0 * epsilon)
        return analytic, fd

    @property
    def mcmc_info(self):
        """Convergence/distribution record of the last ``method='mcmc'``
        training."""
        return self._mcmc_info

    def _get_default_hyperparameter_bounds(self):
        """Data-derived box for ``[kernel hps..., noise]``: signal variance
        from the output variance, length scales around the unit-scaled
        latent embedding, noise between 1e-6 and the output variance."""
        y_var = max(float(np.var(config.to_numpy(self._y))), 1e-8)
        n_hps = len(self.hyperparameters)
        bounds = np.empty((n_hps + 1, 2))
        bounds[0] = [y_var * 1e-2, y_var * 1e2]
        bounds[1:n_hps] = [1e-2, 1e2]
        bounds[-1] = [1e-6, y_var]
        return bounds

    # ------------------------------------------------------------------
    def train(self, method="adam", hyperparameter_bounds=None, max_iter=None,
              tolerance=1e-4, learning_rate=1e-2, info=False,
              sample_latent=False, n_chains=1):
        """Train the latent embedding and/or hyperparameters.

        ``method``: ``adam`` (default; joint Adam over latents, kernel hps
        and noise), ``local`` (joint L-BFGS-B over the flattened
        (X, log hps, log noise); the hyperparameter box applies in log
        space, latents unbounded), ``mcmc`` (adaptive Metropolis over
        ``[kernel hps..., noise]`` at fixed latents, or with
        ``sample_latent=True`` over the latents too; commits the MAP
        sample; chains after the first start from numpy's global RNG), or a
        callable receiving this GPLVM and returning a ``[kernel hps...,
        noise]`` vector to commit.  ``max_iter`` defaults to 500 adam /
        200 local / 2000 mcmc.

        Returns the learned (N, L) latents for ``adam`` / ``local``, the
        committed ``[kernel hps..., noise]`` vector for ``mcmc`` and
        callables.
        """
        if isinstance(method, (int, float)) and not isinstance(method, bool):
            # legacy positional call train(max_iter[, learning_rate])
            if max_iter is None:
                max_iter = int(method)
            if isinstance(hyperparameter_bounds, float):
                learning_rate = hyperparameter_bounds
                hyperparameter_bounds = None
            method = "adam"
        if callable(method):
            result = method(self)
            if result is not None:
                self.set_hyperparameters(np.asarray(result))
            return self.get_hyperparameters()
        if method == "adam":
            return self._train_adam(
                max_iter=500 if max_iter is None else int(max_iter),
                learning_rate=learning_rate, info=info)
        if method == "local":
            return self._train_local(
                hyperparameter_bounds,
                max_iter=200 if max_iter is None else int(max_iter),
                tolerance=tolerance, info=info)
        if method == "mcmc":
            return self._train_mcmc(
                hyperparameter_bounds,
                max_iter=2000 if max_iter is None else int(max_iter),
                sample_latent=sample_latent, n_chains=n_chains, info=info)
        raise ValueError(f"unknown training method '{method}' "
                         "(adam | local | mcmc | callable)")

    def _commit(self, X, log_hps, log_noise):
        self.X = X.detach()
        self.hyperparameters = np.exp(config.to_numpy(log_hps))
        self.log_noise = float(log_noise)
        return config.to_numpy(self.X)

    def _train_adam(self, max_iter, learning_rate, info):
        params = list(self._params())
        moments = [(torch.zeros_like(p), torch.zeros_like(p))
                   for p in params]
        for it in range(int(max_iter)):
            loss, grads = self._value_and_grad(params, (0, 1, 2))
            with torch.no_grad():
                stepped = [adam_step(p, g, m, v, it + 1, learning_rate)
                           for p, g, (m, v) in zip(params, grads, moments)]
            params = [s[0] for s in stepped]
            moments = [(s[1], s[2]) for s in stepped]
            if info and (it % 50 == 0):
                print(f"GPLVM iter {it}: loss {float(loss):.4f}")
        return self._commit(*params)

    def _check_bounds(self, hyperparameter_bounds):
        if hyperparameter_bounds is None:
            hyperparameter_bounds = self._get_default_hyperparameter_bounds()
        bounds = np.asarray(hyperparameter_bounds, dtype=np.float64)
        n_hps = len(self.hyperparameters)
        if bounds.shape != (n_hps + 1, 2):
            raise AssertionError(
                f"hyperparameter_bounds must be ({n_hps + 1}, 2) "
                "([kernel hps..., noise])")
        return bounds

    def _train_local(self, hyperparameter_bounds, max_iter, tolerance, info):
        """Joint L-BFGS-B on the flattened (X, log hps, log noise) vector;
        the autograd value and gradient is the oracle."""
        from scipy.optimize import minimize

        hyperparameter_bounds = self._check_bounds(hyperparameter_bounds)
        n_lat = self.n * self.latent_dim
        x0 = np.concatenate([config.to_numpy(self.X).ravel(),
                             np.log(self.hyperparameters),
                             [self.log_noise]])
        bounds = ([(None, None)] * n_lat
                  + list(np.log(hyperparameter_bounds)))

        def split(v):
            return (self._tensor(v[:n_lat].reshape(self.n, self.latent_dim)),
                    self._tensor(v[n_lat:-1]), self._tensor(v[-1]))

        def fun(v):
            val, (gX, gh, gn) = self._value_and_grad(split(v), (0, 1, 2))
            grad = np.concatenate([config.to_numpy(gX).ravel(),
                                   config.to_numpy(gh), [float(gn)]])
            return float(val), grad

        res = minimize(fun, x0, jac=True, method="L-BFGS-B", bounds=bounds,
                       tol=tolerance, options={"maxiter": int(max_iter)})
        if info:
            print(f"GPLVM local training: {res.message}, "
                  f"loss {res.fun:.4f}, nit {res.nit}")
        return self._commit(*split(res.x))

    def _train_mcmc(self, hyperparameter_bounds, max_iter, sample_latent,
                    n_chains, info):
        """Adaptive Metropolis over the hyperparameter vector via gpMCMC;
        commits the MAP sample."""
        from .gp_mcmc import gpMCMC

        bounds = self._check_bounds(hyperparameter_bounds)
        theta0 = np.clip(self.get_hyperparameters(),
                         bounds[:, 0], bounds[:, 1])
        n_lat = self.n * self.latent_dim
        if sample_latent:
            # latents inside the sampled vector; the standard-normal latent
            # prior bounds them at ±5 sigma
            bounds = np.vstack([np.tile([-5.0, 5.0], (n_lat, 1)), bounds])
            theta0 = np.concatenate([config.to_numpy(self.X).ravel(),
                                     theta0])

        def loglik(theta, args=None):
            if sample_latent:
                X = theta[:n_lat].reshape(self.n, self.latent_dim)
                params = self._params_from_theta(theta[n_lat:], X=X)
            else:
                params = self._params_from_theta(theta)
            with torch.no_grad():
                return -float(self._neg_lml(*params))

        best_theta, best_f, last_info = None, -np.inf, None
        for chain in range(max(1, int(n_chains))):
            sampler = gpMCMC(loglik, bounds=bounds)
            x0 = theta0 if chain == 0 else np.random.uniform(
                bounds[:, 0], bounds[:, 1])
            out = sampler.run_mcmc(x0=np.asarray(x0, dtype=np.float64),
                                   n_updates=int(max_iter), info=info)
            last_info = out
            if float(out["MAP"]) > best_f:
                best_f = float(out["MAP"])
                best_theta = np.asarray(out["max x"], dtype=np.float64)
        self._mcmc_info = last_info
        if sample_latent:
            self.X = self._tensor(
                best_theta[:n_lat].reshape(self.n, self.latent_dim))
            best_theta = best_theta[n_lat:]
        self.set_hyperparameters(best_theta)
        return self.get_hyperparameters()

    # ------------------------------------------------------------------
    def __getstate__(self):
        """Host arrays and the device's name (the JAX ``GPLVM``'s state
        plus ``device``)."""
        state = dict(self.__dict__)
        state["X"] = config.to_numpy(self.X)
        state["_y"] = config.to_numpy(self._y)
        state["device"] = str(self.device)
        state.pop("dtype")
        return state

    def __setstate__(self, state):
        state = dict(state)
        self.device = config.resolve_device(state.pop("device"))
        self.dtype = config.linalg_dtype(state.get("args"), self.device)
        self.__dict__.update(state)
        self.X = self._tensor(np.asarray(state["X"]))
        self._y = self._tensor(np.asarray(state["_y"]))

    # ------------------------------------------------------------------
    @property
    def latent_coordinates(self):
        return config.to_numpy(self.X)

    def _latents(self, x_latent):
        Xq = (self.X if x_latent is None else self._tensor(
            np.asarray(x_latent, dtype=np.float64)))
        if Xq.dim() != 2 or Xq.shape[1] != self.latent_dim:
            raise AssertionError(
                f"x_latent must be (n, {self.latent_dim})")
        return Xq

    @torch.no_grad()
    def _committed(self, x_latent=None):
        """(Xq, k(X, Xq), KV Cholesky, alpha, hps) at the committed state,
        autograd off."""
        Xq = self._latents(x_latent)
        hps = self._tensor(self.hyperparameters)
        KV = self.kernel(self.X, self.X, hps) + math.exp(self.log_noise) \
            * torch.eye(self.n, dtype=self.dtype, device=self.device)
        ks = self.kernel(self.X, Xq, hps)
        L = torch.linalg.cholesky(KV)
        return Xq, ks, L, torch.cholesky_solve(self._y, L), hps

    def _latent_jacobian(self, fn, Xq, direction):
        """d fn(Xq)/d Xq[i, l] of a row-wise map (row i of the output
        depends on row i of Xq alone) by forward-mode AD, one latent
        direction at a time: (n, ..., L), or (n, ...) for one direction."""
        dirs = range(self.latent_dim) if direction is None \
            else [int(direction)]
        out = []
        with torch.no_grad():
            for l in dirs:
                e = torch.zeros_like(Xq)
                e[:, l] = 1.0
                with forward_ad.dual_level():
                    out.append(forward_ad.unpack_dual(
                        fn(forward_ad.make_dual(Xq, e))).tangent)
        return out[0] if direction is not None else torch.stack(out, -1)

    # -- posterior suite at latent coordinates --
    def posterior_mean(self, x_pred=None):
        """Posterior mean of all Q outputs at latent positions; default =
        the training embedding."""
        Xq, ks, _, alpha, _ = self._committed(x_pred)
        m = config.to_numpy(ks.T @ alpha) + self._y_mean
        return {"x": config.to_numpy(Xq), "m(x)": m}

    def posterior_mean_grad(self, x_pred, direction=None):
        """d posterior-mean / d latent coordinate, by forward-mode AD."""
        Xq, _, _, alpha, hps = self._committed(x_pred)
        jac = config.to_numpy(self._latent_jacobian(
            lambda xq: self.kernel(self.X, xq, hps).T @ alpha, Xq,
            direction))
        if direction is not None:
            return {"x": config.to_numpy(Xq), "direction": direction,
                    "dm/dx": jac}
        return {"x": config.to_numpy(Xq), "direction": "ALL", "dm/dx": jac}

    def posterior_covariance(self, x_pred, variance_only=False,
                             add_noise=False):
        """Posterior covariance at latent positions, shared across the Q
        outputs."""
        Xq, ks, L, _, hps = self._committed(x_pred)
        with torch.no_grad():
            sol = torch.cholesky_solve(ks, L)
            kss = self.kernel(Xq, Xq, hps)
            if variance_only:
                v = config.to_numpy(torch.diagonal(kss)
                                    - torch.sum(ks * sol, dim=0))
                S = None
            else:
                S = config.to_numpy(kss - ks.T @ sol)
                v = np.diag(S).copy()
        if np.any(v < -1e-6):
            warnings.warn("Negative posterior variances encountered and "
                          "clipped; the latent model may be misspecified.")
        v = np.clip(v, 0.0, None)
        if add_noise:
            v = v + np.exp(self.log_noise)
            if S is not None:
                S = S + np.exp(self.log_noise) * np.eye(len(S))
        return {"x": config.to_numpy(Xq), "v(x)": v, "S": S}

    def posterior_covariance_grad(self, x_pred, direction=None):
        """d posterior-variance / d latent coordinate, by forward-mode AD."""
        Xq, _, L, _, hps = self._committed(x_pred)

        def variance(xq):
            k = self.kernel(self.X, xq, hps)
            kk = torch.diagonal(self.kernel(xq, xq, hps))
            return kk - torch.sum(k * torch.cholesky_solve(k, L), dim=0)

        grad = config.to_numpy(self._latent_jacobian(variance, Xq,
                                                     direction))
        if direction is not None:
            return {"x": config.to_numpy(Xq), "direction": direction,
                    "dv/dx": grad}
        return {"x": config.to_numpy(Xq), "dv/dx": grad}

    @torch.no_grad()
    def _joint_prior(self, x_pred):
        """(K, k, kappa, S) of the joint prior over (training latents, new
        latents) as float64 device tensors; S carries 1e-9 on its
        diagonal."""
        Xq = self._latents(x_pred)
        hps = self._tensor(self.hyperparameters)
        f64 = torch.float64
        K = self.kernel(self.X, self.X, hps).to(f64)
        k = self.kernel(self.X, Xq, hps).to(f64)
        kk = self.kernel(Xq, Xq, hps).to(f64)
        S = torch.cat([torch.cat([K, k], dim=1),
                       torch.cat([k.T, kk], dim=1)])
        return Xq, K, k, kk, _jittered(S)

    def joint_gp_prior(self, x_pred):
        """Joint prior over (training latents, new latents)."""
        Xq, K, k, kk, S = self._joint_prior(x_pred)
        return {"x": config.to_numpy(Xq), "K": config.to_numpy(K),
                "k": config.to_numpy(k), "kappa": config.to_numpy(kk),
                "S": config.to_numpy(S)}

    def gp_entropy(self, x_pred):
        """Differential entropy of the joint prior at latent positions."""
        return _entropy(self._joint_prior(x_pred)[-1])

    def gp_kl_div(self, x_pred, comp_mean, comp_cov):
        """KL(posterior-at-latents || given Gaussian), output-averaged
        mean."""
        mean = self.posterior_mean(x_pred)["m(x)"].mean(axis=1)
        cov = self.posterior_covariance(x_pred)["S"]
        cov = cov + np.identity(len(cov)) * _JITTER
        comp_cov = np.asarray(comp_cov) + np.identity(len(comp_cov)) * _JITTER
        f64 = dict(dtype=torch.float64, device=self.device)
        kld = GPposterior.kl_div(
            torch.as_tensor(mean, **f64),
            torch.as_tensor(np.asarray(comp_mean, np.float64), **f64),
            torch.as_tensor(cov, **f64), torch.as_tensor(comp_cov, **f64))
        return {"x": np.asarray(x_pred),
                "gp posterior mean": mean,
                "gp posterior covariance": cov,
                "given mean": comp_mean,
                "given covariance": comp_cov,
                "kl-div": kld}

    def gp_mutual_information(self, x_pred):
        """MI between the training set and new latent positions."""
        _, K, _, kk, S = self._joint_prior(x_pred)
        return {"x": np.asarray(x_pred),
                "mutual information": _entropy(_jittered(K))
                + _entropy(_jittered(kk)) - _entropy(S)}

    # -- legacy/decoder aliases ----------------------------------------
    def reconstruct(self, x_latent=None):
        """Posterior mean of Y at latent positions (default: the training
        embedding) — the decoder direction."""
        return self.posterior_mean(x_latent)["m(x)"]

    def predict_variance(self, x_latent):
        """Posterior variance at latent positions (shared across outputs)."""
        return self.posterior_covariance(x_latent, variance_only=True)["v(x)"]
