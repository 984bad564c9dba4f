"""Posterior mean and covariance (counterpart of
``fvgp_tpu/models/gp_posterior.py``).  Returned dicts carry host numpy
arrays with the JAX package's keys and task-major ``x_out`` layouts.

* Dense models: solves against the committed factorization; the variance
  comes from one einsum against the stored inverse (``CholInv``/``Inv``)
  when only the variance is asked for.  ``posterior_mean(hyperparameters=
  ...)`` solves a trial K+V without committing it.
* gp2Scale: solves go through the committed-state fast solver where it
  applies, else against the stored K+V; the mean's kᵀ(K+V)⁻¹(y-m) product
  is fused into the chunked kernel sweep at scale, and so is its gradient's
  (∂k/∂x)ᵀ(K+V)⁻¹(y-m).  A cross covariance too large for a dense sweep
  arrives as a rectangular ``BlockSparseMatrix`` and is densified one column
  chunk at a time.
* Posterior gradients: ∂k/∂x by forward-mode AD (``GPprior.d_kernel_dx``);
  the derivative of k(x*, x*) is a difference quotient at step 1e-6, as in
  the JAX package, but evaluated in float64 whatever the linalg dtype (in
  float32 the shifted points round at ~6e-8 of their magnitude, a few
  percent of the quotient).
* The information-theory suite (entropy, KL divergence, mutual
  information, total correlation, relative information entropy, the
  posterior probability) builds its joint covariances on the device; the
  joint-prior family densifies K (with a warning under gp2Scale) and adds
  1e-9 to the diagonal, as the JAX package does.

Multi-task models (``fvGP``) take ``x_out``, a 1-d array of task indices:
the prediction set is the task-major product ``[x, task]`` and results are
reshaped task-major (``m(x)[i, t]``, ``S[i, j, t, u]``).  On a
non-Euclidean input space ``x_pred`` is a list of objects (pairs
``[object, task]`` under ``x_out``); its cross covariances come from the
host kernel and skip the memo.
"""

import math
import warnings

import numpy as np
import torch

from .. import config
from ..ops import dense as dops
from ..parallel.block_sparse import is_block_sparse
from ..utils.trace import span

_JITTER = 1e-9          # the JAX package's diagonal shift of joint covariances
_FD_STEP = 1e-6         # its step of the k(x*, x*) difference quotients


def _block(K, k, kk):
    """The joint covariance [[K, k], [kᵀ, kk]] on the device."""
    return torch.cat([torch.cat([K, k], dim=1), torch.cat([k.T, kk], dim=1)])


def _jitter(S):
    return dops.add_diagonal(S, torch.full((S.shape[0],), _JITTER,
                                           dtype=S.dtype, device=S.device))


def _host_blocks(out):
    """A joint-prior dict with its device blocks as host arrays."""
    return {key: val if key == "x" else config.to_numpy(val)
            for key, val in out.items()}


def _like(a, ref):
    """``a`` (array or tensor) as a tensor of ``ref``'s dtype and device."""
    return torch.as_tensor(np.asarray(a, np.float64) if not torch.is_tensor(a)
                           else a).to(ref.device, ref.dtype)


class GPposterior:
    def __init__(self, data, prior, trainer, kv, likelihood):
        self.data = data
        self.prior = prior
        self.trainer = trainer
        self.kv = kv
        self.likelihood = likelihood
        self.noise_function_available = likelihood._mode == "callable"
        self._cross_cov_memo = None

    @property
    def args(self):
        return self.data.args

    @property
    def hyperparameters(self):
        return self.trainer.hyperparameters

    @property
    def x_data(self):
        return self.data.x_data

    @property
    def y_data(self):
        return self.data.y_data

    @property
    def x_out(self):
        return self.data.x_out

    @property
    def KVinvY(self):
        return self.kv.KVinvY

    @property
    def KVinv(self):
        return self.kv.KVinv

    @property
    def input_set_dim(self):
        return self.data.input_set_dim

    @property
    def K(self):
        return self.prior.K

    @property
    def m(self):
        return self.prior.m

    @property
    def gp2Scale(self):
        return self.data.gp2Scale

    def _tensor(self, a):
        """What a prior callable returned (a tensor, or the host array of a
        host replacement) as a tensor on the model's device in its
        dtype."""
        return config.tensor_operand(a, self.data.device, self.kv.dtype)

    @staticmethod
    def _cross_cov_key(data, x_pred, hyperparameters):
        hps = np.asarray(hyperparameters)
        return (data.point_number, data.generation, hps.tobytes(),
                x_pred.shape, x_pred.tobytes())

    def _cross_cov(self, x_pred, hyperparameters):
        """k(x_data, x_pred), memoizing the LAST (data, hps, x_pred) triple
        (posterior_mean then posterior_covariance assemble the same k); a
        list of objects skips the memo."""
        with span("fvgp.posterior.cross_cov"):
            if not isinstance(x_pred, np.ndarray):
                return self._tensor(self.prior.compute_data_cross_covariance(
                    x_pred, hyperparameters))
            key = self._cross_cov_key(self.data, x_pred, hyperparameters)
            memo = self._cross_cov_memo
            if memo is not None and memo[0] == key:
                return memo[1]
            k = self._tensor(self.prior.compute_data_cross_covariance(
                x_pred, hyperparameters))
            self._cross_cov_memo = (key, k)
            return k

    def _mean_product(self, x_pred, hyperparameters, KVinvY):
        """kᵀ·KVinvY for the posterior mean: under gp2Scale at scale fused
        into the chunked kernel sweep, unless the memo already holds k for
        this query."""
        if self.gp2Scale and len(self.x_data) > self.prior.batch_size:
            memo = self._cross_cov_memo
            hit = (memo is not None and memo[0] ==
                   self._cross_cov_key(self.data, x_pred, hyperparameters))
            if not hit:
                with span("fvgp.posterior.cross_cov"):
                    prod = self.prior.cross_covariance_product_or_none(
                        x_pred, hyperparameters, KVinvY)
                if prod is not None:
                    return config.to_numpy(prod)
        k = self._cross_cov(x_pred, hyperparameters)
        with span("fvgp.posterior.solve"):
            prod = k.rmatmat(KVinvY) if is_block_sparse(k) else k.T @ KVinvY
        return config.to_numpy(prod)

    def _dense_K(self):
        """Dense K for the joint-covariance methods."""
        K = self.prior.K
        if not is_block_sparse(K):
            return K
        warnings.warn(
            "This method assembles a joint covariance over data and "
            "prediction points, which is dense in the number of data points. "
            "Under the scale path that discards the sparse representation; "
            "it is only usable on small problems. Consider "
            "posterior_covariance instead.")
        return K.to_dense()

    def _cross_solve_product(self, k, diag=False):
        """kᵀ (K+V)⁻¹ k in column chunks; ``diag=True`` returns only its
        diagonal (the variance path).  One chunk on the dense path; under
        gp2Scale the fast solver's column budget, or — against the stored
        K+V — the batch size bounded by the memory of the block-sparse
        product where it is the plain one
        (``BlockSparseMatrix.square_col_chunk``).  A block-sparse ``k`` is
        densified one chunk at a time, so the (N, n_pred) dense array never
        exists."""
        n_pred = k.shape[1]
        chunk_size = n_pred
        if self.gp2Scale:
            chunk_size = self.kv.fast_solve_col_budget()
            if chunk_size is None:
                # the stored K+V serves the solve (touching it is what
                # materializes it, so only off the fast path)
                chunk_size = self.prior.batch_size
                KV = self.kv.KV
                if is_block_sparse(KV):
                    chunk_size = min(int(chunk_size), KV.square_col_chunk(
                        n_pred, self.kv.dtype))
        chunk_size = max(1, min(int(chunk_size), n_pred))
        sparse_k = is_block_sparse(k)
        parts = []
        for start in range(0, n_pred, chunk_size):
            end = min(start + chunk_size, n_pred)
            cols = k.dense_columns(start, end) if sparse_k \
                else k[:, start:end]
            solved = self.kv.solve(cols)
            if diag:
                parts.append(torch.sum(cols * solved, dim=0))
            elif sparse_k:
                parts.append(k.rmatmat(solved))
            else:
                parts.append(k.T @ solved)
        return torch.cat(parts, dim=0 if diag else 1)

    def _perform_input_checks(self, x_pred, x_out):
        if not isinstance(x_pred, (np.ndarray, list)):
            raise AssertionError("wrong format in x_pred")
        if isinstance(x_pred, np.ndarray):
            if x_pred.ndim != 2:
                raise AssertionError("wrong dim in x_pred, has to be 2-d")
            if x_pred.shape[1] != self.data.input_set_dim:
                raise AssertionError("wrong number of columns in x_pred")
        if not (isinstance(x_out, np.ndarray) or x_out is None
                or isinstance(x_out, list)):
            raise AssertionError("wrong format in x_out")
        if isinstance(x_out, np.ndarray) and x_out.ndim != 1:
            raise AssertionError("wrong dim in x_out, has to be 1-d")
        if isinstance(x_out, np.ndarray) and self.y_data.shape[1] > 1:
            raise Exception("multi-column y_data cannot be combined with "
                            "x_out")

    @staticmethod
    def cartesian_product(x, y):
        """Task-major product-space points (``[object, task]`` pairs for a
        list of objects)."""
        if not (isinstance(y, np.ndarray) and y.ndim == 1):
            raise AssertionError("x_out must be a 1-d np.ndarray")
        if isinstance(x, list):
            return [[xi, yj] for yj in y for xi in x]
        n, d = x.shape
        out = np.empty((len(y) * n, d + 1))
        out[:, :d] = np.tile(x, (len(y), 1))
        out[:, d] = np.repeat(y, n)
        return out

    def _product_space(self, x_pred, x_out):
        """(x_orig, x_pred in product space, x_out) after the checks."""
        with span("fvgp.posterior.inputs"):
            if x_out is None:
                x_out = self.x_out
            self._perform_input_checks(x_pred, x_out)
            x_orig = x_pred.copy() if isinstance(x_pred, np.ndarray) \
                else list(x_pred)
            if isinstance(x_out, np.ndarray):
                x_pred = self.cartesian_product(x_pred, x_out)
            return x_orig, x_pred, x_out

    # ------------------------------------------------------------------
    def _hps_and_KVinvY(self, hyperparameters):
        """(hyperparameters, (K+V)⁻¹(y-m)): the committed pair, or a one-off
        trial at ``hyperparameters`` that commits nothing."""
        if hyperparameters is None:
            return self.hyperparameters, self.kv.KVinvY
        prior = self.prior
        K = self._tensor(prior.compute_prior_covariance_matrix(
            self.x_data, hyperparameters))
        V = self.likelihood.calculate_V(self.x_data, hyperparameters)
        m = prior.compute_mean(self.x_data, hyperparameters)
        return hyperparameters, self.kv.compute_new_KVinvY(self.kv.addKV(K, V),
                                                           m)

    def posterior_mean(self, x_pred, hyperparameters=None, x_out=None):
        """m(x*) + k*ᵀ(K+V)⁻¹(y-m), at the committed hyperparameters or —
        dense models — at a one-off trial vector."""
        hyperparameters, KVinvY = self._hps_and_KVinvY(hyperparameters)
        x_orig, x_pred, x_out = self._product_space(x_pred, x_out)
        A = self._mean_product(x_pred, hyperparameters, KVinvY)
        with span("fvgp.posterior.prior"):
            prior_mean = self._tensor(self.prior.compute_mean(
                x_pred, hyperparameters))
        prior_mean = config.to_numpy(prior_mean)
        posterior_mean = prior_mean[:, None] + A
        if isinstance(x_out, np.ndarray):
            return {"x": x_orig,
                    "m(x)": posterior_mean.reshape(len(x_orig), len(x_out),
                                                   order="F"),
                    "m(x)_flat": np.squeeze(posterior_mean),
                    "x_pred": x_pred}
        if KVinvY.shape[1] == 1:
            posterior_mean = np.squeeze(posterior_mean)
        return {"x": x_orig, "m(x)": posterior_mean,
                "m(x)_flat": posterior_mean, "x_pred": x_pred}

    def posterior_mean_grad(self, x_pred, hyperparameters=None, x_out=None,
                            direction=None, component=0):
        """∂m(x*)/∂x*: ``dm_dx`` plus (∂k/∂x*)ᵀ(K+V)⁻¹(y-m), the product
        summed over row chunks of the data; one ``direction`` or all."""
        hyperparameters, KVinvY = self._hps_and_KVinvY(hyperparameters)
        KVinvY = KVinvY[:, component]
        x_orig, x_pred, x_out = self._product_space(x_pred, x_out)
        prior = self.prior
        dims = range(x_orig.shape[1]) if direction is None else [direction]
        cols = [config.to_numpy(prior.dm_dx(x_pred, hyperparameters, d))
                + config.to_numpy(prior.kernel_dx_product(
                    x_pred, d, hyperparameters, KVinvY)) for d in dims]
        tasks = isinstance(x_out, np.ndarray)
        if direction is not None:
            grad = cols[0]
            if tasks:
                grad = grad.reshape(len(x_orig), len(x_out), order="F")
            return {"x": x_orig, "direction": direction, "dm/dx": grad}
        grad = np.stack(cols, axis=1)
        if tasks:
            grad = grad.reshape(len(x_orig), x_orig.shape[1], len(x_out),
                                order="F")
        return {"x": x_orig, "direction": "ALL", "dm/dx": grad}

    def posterior_covariance(self, x_pred, x_out=None, variance_only=False,
                             add_noise=False):
        """S = k(x*,x*) − k*ᵀ(K+V)⁻¹k* and its diagonal; with the explicit
        inverse stored and ``variance_only``, the variances come from one
        einsum."""
        x_orig, x_pred, x_out = self._product_space(x_pred, x_out)
        k = self._cross_cov(x_pred, self.hyperparameters)
        with span("fvgp.posterior.prior"):
            kk = self._tensor(self.prior.compute_covariances(
                x_pred, x_pred, self.hyperparameters))
        single = self.y_data.shape[1] == 1
        S = None
        with span("fvgp.posterior.solve"):
            if self.kv.KVinv is not None and variance_only and single:
                kd = k.to_dense() if is_block_sparse(k) else k
                v = torch.diagonal(kk) - torch.einsum(
                    "ji,jk,ki->i", kd, self.kv.KVinv, kd)
            elif variance_only and self.gp2Scale and single:
                v = torch.diagonal(kk) - self._cross_solve_product(k,
                                                                   diag=True)
            else:
                S = kk - self._cross_solve_product(k)
        if S is None:
            v = config.to_numpy(v)
        else:
            S = config.to_numpy(S)
            v = np.diag(S).copy()
        if np.any(v < -0.0001):
            warnings.warn(
                "Negative variances encountered. That normally means the "
                "model is unstable. Rethink the kernel definition, add more "
                "noise, or double check the hyperparameter optimization "
                "bounds.")
        if np.any(v < 0.0):
            v[v < 0.0] = 0.0
            if S is not None:
                np.fill_diagonal(S, v)
        if add_noise:
            v, S = self.add_noise(x_pred, v, S)
        if isinstance(x_out, np.ndarray):
            v_re = v.reshape(len(x_orig), len(x_out), order="F")
            S_re = None if S is None else S.reshape(
                len(x_orig), len(x_out), len(x_orig), len(x_out),
                order="F").transpose(0, 2, 1, 3)
        else:
            v_re, S_re = v, S
            if not single:
                v = np.tile(v[:, None], (1, self.y_data.shape[1]))
                v_re = np.tile(v_re[:, None], (1, self.y_data.shape[1]))
        return {"x": x_orig, "x_pred": x_pred, "v(x)": v_re, "S": S_re,
                "S_flat": S, "v_flat": v}

    def posterior_covariance_grad(self, x_pred, x_out=None, direction=None):
        """∂S/∂x* = ∂k(x*, x*)/∂x* − 2 (∂k/∂x*)ᵀ(K+V)⁻¹k: "dv/dx" (its
        diagonal) for one ``direction`` or all, and "dS/dx" for one.  The
        solve goes through the committed state (under gp2Scale the fast
        solver); ∂k(x*, x*)/∂x* is a forward difference evaluated in
        float64."""
        x_orig, x_pred, x_out = self._product_space(x_pred, x_out)
        hps = self.hyperparameters
        k = self._cross_cov(x_pred, hps)
        solved = self.kv.solve(k.to_dense() if is_block_sparse(k) else k)
        kk = config.to_numpy(self.prior.compute_covariances(
            x_pred, x_pred, hps, torch.float64))

        def dS(d):
            xs = np.array(x_pred)
            xs[:, d] += _FD_STEP
            kk_g = (config.to_numpy(self.prior.compute_covariances(
                xs, xs, hps, torch.float64)) - kk) / _FD_STEP
            return kk_g - 2.0 * config.to_numpy(
                self.prior.kernel_dx_product(x_pred, d, hps, solved))

        tasks = isinstance(x_out, np.ndarray)
        if direction is not None:
            dSdx = dS(direction)
            a = np.diag(dSdx).copy()
            if tasks:
                a = a.reshape(len(x_orig), len(x_out), order="F")
                dSdx = dSdx.reshape(len(x_orig), len(x_orig), len(x_out),
                                    len(x_out), order="F")
            return {"x": x_orig, "dv/dx": a, "dS/dx": dSdx}
        grad_v = np.stack([np.diag(dS(d)) for d in range(x_orig.shape[1])],
                          axis=1)
        if tasks:
            grad_v = grad_v.reshape(len(x_orig), x_orig.shape[1], len(x_out),
                                    order="F")
        return {"x": x_orig, "dv/dx": grad_v}

    # ------------------------------------------------------------------
    # the joint prior over data and prediction points
    # ------------------------------------------------------------------
    def _joint_blocks(self, x_pred, x_out):
        """(x_orig, x_pred in product space, K + 1e-9·I, k, kappa) as
        device tensors."""
        K = _jitter(self._dense_K())
        x_orig, x_pred, _ = self._product_space(x_pred, x_out)
        hps = self.hyperparameters
        k = self._tensor(self.prior.compute_covariances(self.prior._x_dev,
                                                        x_pred, hps))
        kk = self._tensor(self.prior.compute_covariances(x_pred, x_pred, hps))
        return x_orig, x_pred, K, k, kk

    def _joint_prior(self, x_pred, x_out):
        x_orig, x_pred, K, k, kk = self._joint_blocks(x_pred, x_out)
        mean = torch.cat([self.prior.m.to(K.dtype), self._tensor(
            self.prior.compute_mean(x_pred, self.hyperparameters))])
        return {"x": x_pred, "K": K, "k": k, "kappa": kk,
                "prior mean": mean, "S": _jitter(_block(K, k, kk))}

    def joint_gp_prior(self, x_pred, x_out=None):
        """The joint prior over data and prediction points: blocks K, k,
        kappa, the joint mean and covariance (1e-9 on the diagonals)."""
        return _host_blocks(self._joint_prior(x_pred, x_out))

    def _joint_prior_grad(self, x_pred, direction, x_out):
        K = _jitter(self._dense_K())
        _, x_pred, _ = self._product_space(x_pred, x_out)
        hps = self.hyperparameters
        prior = self.prior
        k_g = prior.d_kernel_dx(x_pred, prior._x_dev, direction, hps).T
        x1, x2 = np.array(x_pred), np.array(x_pred)
        x1[:, direction] += _FD_STEP
        x2[:, direction] -= _FD_STEP
        f64 = torch.float64
        kk_g = (prior.compute_covariances(x1, x1, hps, f64)
                - prior.compute_covariances(x2, x2, hps, f64)) / (2 * _FD_STEP)
        mean_der = (prior.compute_mean(x1, hps, f64)
                    - prior.compute_mean(x2, hps, f64)) / (2 * _FD_STEP)
        kk_g, mean_der = kk_g.to(K.dtype), mean_der.to(K.dtype)
        return {"x": x_pred, "K": K, "dk/dx": k_g, "d kappa/dx": kk_g,
                "d prior mean/x": torch.cat([torch.zeros_like(K[0]),
                                             mean_der]),
                "dS/dx": _block(torch.zeros_like(K), k_g, kk_g)}

    def joint_gp_prior_grad(self, x_pred, direction, x_out=None):
        """∂/∂x*[:, direction] of the joint prior's blocks: "dk/dx" (exact),
        "d kappa/dx" and "d prior mean/x" (central differences at 1e-6,
        evaluated in float64) and the joint "dS/dx"."""
        return _host_blocks(self._joint_prior_grad(x_pred, direction, x_out))

    # ------------------------------------------------------------------
    # information theory
    # ------------------------------------------------------------------
    @staticmethod
    def entropy(S):
        """Differential entropy of a Gaussian with covariance ``S`` (a
        tensor, or an array on the CPU)."""
        S = torch.as_tensor(S)
        dim = S.shape[0]
        ldet = float(dops.calculate_logdet(S))
        return (dim / 2.0) + ((dim / 2.0) * math.log(2.0 * math.pi)) \
            + 0.5 * ldet

    def gp_entropy(self, x_pred, x_out=None):
        """Entropy of the joint prior over data and prediction points."""
        return self.entropy(self._joint_prior(x_pred, x_out)["S"])

    def gp_entropy_grad(self, x_pred, direction, x_out=None):
        """½ tr(S⁻¹ ∂S/∂x*[:, direction]) of the joint prior."""
        S1 = self._joint_prior(x_pred, x_out)["S"]
        S2 = self._joint_prior_grad(x_pred, direction, x_out)["dS/dx"]
        # tr(A B) as the sum of A ∘ Bᵀ: no (n, n) product
        return 0.5 * float(torch.sum(dops.calculate_inv(S1) * S2.T))

    @staticmethod
    def kl_div(mu1, mu2, S1, S2):
        """KL(N(mu1, S1) ‖ N(mu2, S2)); tensors (the others follow S1's
        dtype and device) or arrays.  Warns on a negative value and returns
        its magnitude, as the JAX package does."""
        S1 = torch.as_tensor(S1)
        S2, mu1, mu2 = (_like(a, S1) for a in (S2, mu1, mu2))
        logdet1 = float(dops.calculate_logdet(S1))
        logdet2 = float(dops.calculate_logdet(S2))
        mu = mu2 - mu1
        # one LU factor of S2 for both solves; like jnp.linalg.solve it
        # does not raise on a singular S2
        lu, piv, _ = torch.linalg.lu_factor_ex(S2)
        sol = torch.linalg.lu_solve(lu, piv, torch.cat([S1, mu[:, None]], 1))
        x1, x2 = sol[:, :-1], sol[:, -1]
        dim = len(mu)
        kld = 0.5 * (float(torch.trace(x1)) + float(x2 @ mu) - dim
                     + (logdet2 - logdet1))
        if kld < -1e-4:
            warnings.warn("Negative KL divergence encountered; returning "
                          "abs(KLD).")
        return abs(kld)

    def _device_posterior(self, x_pred, x_out, add_noise=False):
        """(flat posterior mean, flat posterior covariance) as device
        tensors in the linalg dtype; the covariance first, so the mean
        reuses its cross covariance."""
        cov = self.prior._tensor(self.posterior_covariance(
            x_pred, x_out=x_out, add_noise=add_noise)["S_flat"])
        mean = self.prior._tensor(self.posterior_mean(
            x_pred, x_out=x_out)["m(x)_flat"])
        return mean, cov

    def gp_kl_div(self, x_pred, comp_mean, comp_cov, x_out=None):
        """KL divergence of N(comp_mean, comp_cov) from the posterior at
        x_pred (1e-9 on both covariances' diagonals)."""
        if x_out is None:
            x_out = self.x_out
        gp_mean, gp_cov = self._device_posterior(x_pred, x_out)
        gp_cov = _jitter(gp_cov)
        comp_cov = comp_cov + np.identity(len(comp_cov)) * _JITTER
        return {"x": x_pred,
                "gp posterior mean": config.to_numpy(gp_mean),
                "gp posterior covariance": config.to_numpy(gp_cov),
                "given mean": comp_mean,
                "given covariance": comp_cov,
                "kl-div": self.kl_div(gp_mean, comp_mean, gp_cov, comp_cov)}

    def mutual_information(self, joint, m1, m2):
        return self.entropy(m1) + self.entropy(m2) - self.entropy(joint)

    def _joint_and_noisy_kappa(self, x_pred, x_out, add_noise):
        x_orig, x_pred, K, k, kk = self._joint_blocks(x_pred, x_out)
        kk = _jitter(kk)
        if add_noise:
            _, kk = self.add_noise(x_pred, torch.diagonal(kk), kk)
        return x_orig, K, k, kk

    def gp_mutual_information(self, x_pred, x_out=None, add_noise=False):
        """Mutual information between the data and the prediction points
        under the joint prior."""
        x_orig, K, k, kk = self._joint_and_noisy_kappa(x_pred, x_out,
                                                       add_noise)
        return {"x": x_orig, "mutual information": self.mutual_information(
            _block(K, k, kk), kk, K)}

    def gp_total_correlation(self, x_pred, x_out=None, add_noise=False):
        """Total correlation of data and prediction points: the KL
        divergence of the joint prior from its product of the data block
        and the independent prediction marginals."""
        x_orig, K, k, kk = self._joint_and_noisy_kappa(x_pred, x_out,
                                                       add_noise)
        joint = _block(K, k, kk)
        product = _block(K, torch.zeros_like(k), torch.diag(torch.diagonal(
            kk)))
        zeros = torch.zeros(len(joint), dtype=joint.dtype,
                            device=joint.device)
        return {"x": x_orig, "total correlation": self.kl_div(
            zeros, zeros, joint, product)}

    def gp_relative_information_entropy(self, x_pred, x_out=None,
                                        add_noise=False):
        """KL divergence of the posterior from the prior at x_pred."""
        if x_out is None:
            x_out = self.x_out
        x_orig, x_aux, _ = self._product_space(x_pred, x_out)
        hps = self.hyperparameters
        kk = _jitter(self._tensor(self.prior.compute_covariances(x_aux, x_aux,
                                                                 hps)))
        post_mean, post_cov = self._device_posterior(x_pred, x_out,
                                                     add_noise=add_noise)
        prio_mean = self._tensor(self.prior.compute_mean(x_aux, hps))
        return {"x": x_orig, "RIE": self.kl_div(prio_mean, post_mean, kk,
                                                _jitter(post_cov))}

    def gp_relative_information_entropy_set(self, x_pred, x_out=None,
                                            add_noise=False):
        """The relative information entropy of each point on its own."""
        if x_out is None:
            x_out = self.x_out
        RIE = np.zeros(len(x_pred))
        for i in range(len(x_pred)):
            RIE[i] = self.gp_relative_information_entropy(
                x_pred[i].reshape(1, len(x_pred[i])), x_out=x_out,
                add_noise=add_noise)["RIE"]
        return {"x": x_pred.copy(), "RIE": RIE}

    def posterior_probability(self, x_pred, comp_mean, comp_cov, x_out=None):
        """Probability that the posterior (with noise) and N(comp_mean,
        comp_cov) describe the same function values, with the fused mean
        and covariance — all from one Cholesky factor of S_gp + S_c:

            fused covariance   S  = S_gp T⁻¹ S_c
            fused mean         mu = S_c T⁻¹ m_gp + S_gp T⁻¹ m_c
            probability        p  = N(m_gp − m_c | 0, T)

        The density is exponentiated on the host in float64: over a
        hundred or more points it can exceed float32's range (e^98 at 200
        points of variance ~0.05)."""
        if x_out is None:
            x_out = self.x_out
        self._perform_input_checks(x_pred, x_out)
        m_gp, S_gp = self._device_posterior(x_pred, x_out, add_noise=True)
        m_c, S_c = _like(comp_mean, S_gp), _like(comp_cov, S_gp)
        L = dops.cholesky_factor(S_gp + S_c)
        fused_cov = S_gp @ dops.cholesky_solve(L, S_c)
        fused_mean = (S_c @ dops.cholesky_solve(L, m_gp)
                      + S_gp @ dops.cholesky_solve(L, m_c))
        diff = m_gp - m_c
        maha = diff @ dops.cholesky_solve(L, diff)
        log_p = -0.5 * (maha + dops.cholesky_logdet(L)
                        + diff.shape[0] * math.log(2.0 * math.pi))
        return {"mu": config.to_numpy(fused_mean),
                "covariance": config.to_numpy(fused_cov),
                "probability": float(np.exp(float(log_p)))}

    # ------------------------------------------------------------------
    def add_noise(self, x_pred, v, S):
        """Add a noise callable's noise at x_pred to the variances ``v`` and
        covariance ``S`` (numpy arrays, or device tensors); the measured and
        default noise have no value away from the data, so they add
        nothing.  Structured (``scipy.sparse`` / block-sparse) noise is
        densified at the prediction size."""
        if self.noise_function_available:
            from scipy.sparse import issparse
            noise = self.likelihood.calculate_V(x_pred, self.hyperparameters)
            if issparse(noise):
                noise = noise.toarray()
            elif is_block_sparse(noise):
                noise = noise.to_dense()
            noise = self._tensor(noise)
            diag = torch.diag
            if torch.is_tensor(v):
                noise = noise.to(v.device, v.dtype)
            else:
                noise, diag = config.to_numpy(noise), np.diag
            if noise.ndim == 1:
                v = v + noise
                if S is not None:
                    S = S + diag(noise)
            elif noise.ndim == 2:
                v = v + diag(noise)
                if S is not None:
                    S = S + noise
            else:
                warnings.warn("Noise could not be added: wrong noise format.")
        return v, S

    # ------------------------------------------------------------------
    def __getstate__(self):
        state = dict(self.__dict__)
        state["_cross_cov_memo"] = None      # device arrays; recomputed
        return state
