"""Posterior mean and covariance (counterpart of
``fvgp_tpu/models/gp_posterior.py``).  Returned dicts carry host numpy
arrays with the JAX package's keys and task-major ``x_out`` layouts.

* Dense models: solves against the committed factorization; the variance
  comes from one einsum against the stored inverse (``CholInv``/``Inv``)
  when only the variance is asked for.  ``posterior_mean(hyperparameters=
  ...)`` solves a trial K+V without committing it.
* gp2Scale: solves go through the committed-state fast solver; the mean's
  kᵀ(K+V)⁻¹(y-m) product is fused into the chunked kernel sweep at scale,
  and only the variance (``variance_only=True``) is served.

Posterior gradients and the information-theory suite are not ported yet
(ROADMAP item 1.2); multi-task ``x_out`` models (fvGP) wait for item 1.6.
"""

import warnings

import numpy as np
import torch

from .. import config


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
    def gp2Scale(self):
        return self.data.gp2Scale

    @staticmethod
    def _cross_cov_key(data, x_pred, hyperparameters):
        hps = np.asarray(hyperparameters)
        return (data.point_number, data.generation, hps.tobytes(),
                x_pred.shape, x_pred.tobytes())

    def _cross_cov(self, x_pred, hyperparameters):
        """k(x_data, x_pred), memoizing the LAST (data, hps, x_pred) triple
        (posterior_mean then posterior_covariance assemble the same k)."""
        key = self._cross_cov_key(self.data, x_pred, hyperparameters)
        memo = self._cross_cov_memo
        if memo is not None and memo[0] == key:
            return memo[1]
        k = self.prior.compute_data_cross_covariance(x_pred, hyperparameters)
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
                prod = self.prior.cross_covariance_product_or_none(
                    x_pred, hyperparameters, KVinvY)
                if prod is not None:
                    return config.to_numpy(prod)
        k = self._cross_cov(x_pred, hyperparameters)
        return config.to_numpy(k.T @ KVinvY)

    def _cross_solve_product(self, k, diag=False):
        """kᵀ (K+V)⁻¹ k in column chunks (one chunk on the dense path, the
        fast solver's column budget under gp2Scale); ``diag=True`` returns
        only its diagonal (the variance path)."""
        n_pred = k.shape[1]
        chunk_size = n_pred
        if self.gp2Scale:
            chunk_size = self.kv.fast_solve_col_budget() \
                or self.prior.batch_size
        chunk_size = max(1, min(int(chunk_size), n_pred))
        parts = []
        for start in range(0, n_pred, chunk_size):
            cols = k[:, start:start + chunk_size]
            solved = self.kv.solve(cols)
            if diag:
                parts.append(torch.sum(cols * solved, dim=0))
            else:
                parts.append(k.T @ solved)
        return torch.cat(parts, dim=0 if diag else 1)

    def _perform_input_checks(self, x_pred, x_out):
        if not isinstance(x_pred, np.ndarray):
            raise AssertionError("wrong format in x_pred")
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
        """Task-major product-space points."""
        if not (isinstance(y, np.ndarray) and y.ndim == 1):
            raise AssertionError("x_out must be a 1-d np.ndarray")
        n, d = x.shape
        out = np.empty((len(y) * n, d + 1))
        out[:, :d] = np.tile(x, (len(y), 1))
        out[:, d] = np.repeat(y, n)
        return out

    def _product_space(self, x_pred, x_out):
        """(x_orig, x_pred in product space, x_out) after the checks."""
        if x_out is None:
            x_out = self.x_out
        self._perform_input_checks(x_pred, x_out)
        x_orig = x_pred.copy()
        if isinstance(x_out, np.ndarray):
            x_pred = self.cartesian_product(x_pred, x_out)
        return x_orig, x_pred, x_out

    # ------------------------------------------------------------------
    def posterior_mean(self, x_pred, hyperparameters=None, x_out=None):
        """m(x*) + k*ᵀ(K+V)⁻¹(y-m), at the committed hyperparameters or —
        dense models — at a one-off trial vector."""
        if hyperparameters is not None:
            prior = self.prior
            K = prior.compute_prior_covariance_matrix(self.x_data,
                                                      hyperparameters)
            V = self.likelihood.calculate_V(self.x_data, hyperparameters)
            m = prior.compute_mean(self.x_data, hyperparameters)
            KVinvY = self.kv.compute_new_KVinvY(self.kv.addKV(K, V), m)
        else:
            hyperparameters = self.hyperparameters
            KVinvY = self.kv.KVinvY
        x_orig, x_pred, x_out = self._product_space(x_pred, x_out)
        A = self._mean_product(x_pred, hyperparameters, KVinvY)
        prior_mean = config.to_numpy(self.prior.compute_mean(
            x_pred, hyperparameters))
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

    def posterior_covariance(self, x_pred, x_out=None, variance_only=False,
                             add_noise=False):
        """S = k(x*,x*) − k*ᵀ(K+V)⁻¹k* and its diagonal; with the explicit
        inverse stored and ``variance_only``, the variances come from one
        einsum."""
        if self.gp2Scale and not variance_only:
            raise NotImplementedError(
                "fvgp_tpu_torch: the full posterior covariance under "
                "gp2Scale is not ported yet (ROADMAP item 1.3)")
        x_orig, x_pred, x_out = self._product_space(x_pred, x_out)
        k = self._cross_cov(x_pred, self.hyperparameters)
        kk = self.prior.compute_covariances(x_pred, x_pred,
                                            self.hyperparameters)
        single = self.y_data.shape[1] == 1
        S = None
        if self.kv.KVinv is not None and variance_only and single:
            v = config.to_numpy(torch.diagonal(kk) - torch.einsum(
                "ji,jk,ki->i", k, self.kv.KVinv, k))
        elif variance_only and self.gp2Scale and single:
            v = config.to_numpy(torch.diagonal(kk)
                                - self._cross_solve_product(k, diag=True))
        else:
            S = config.to_numpy(kk - self._cross_solve_product(k))
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

    def joint_gp_prior(self, x_pred, x_out=None):
        """The joint prior over data and prediction points: blocks K, k,
        kappa, the joint mean and covariance (1e-9 on the diagonals)."""
        K = config.to_numpy(self.prior.K) + np.identity(len(self.x_data)) \
            * 1e-9
        prior_mean_vec = config.to_numpy(self.prior.m)
        _, x_pred, _ = self._product_space(x_pred, x_out)
        k = config.to_numpy(self.prior.compute_covariances(
            self.prior._x_dev, x_pred, self.hyperparameters))
        kk = config.to_numpy(self.prior.compute_covariances(
            x_pred, x_pred, self.hyperparameters))
        post_mean = config.to_numpy(self.prior.compute_mean(
            x_pred, self.hyperparameters))
        joint_cov = np.block([[K, k], [k.T, kk]])
        return {"x": x_pred, "K": K, "k": k, "kappa": kk,
                "prior mean": np.append(prior_mean_vec, post_mean),
                "S": joint_cov + np.identity(len(joint_cov)) * 1e-9}

    def add_noise(self, x_pred, v, S):
        """Add a noise callable's noise at x_pred (the measured and default
        noise have no value away from the data, so they add nothing)."""
        if self.noise_function_available:
            noise = config.to_numpy(self.likelihood.calculate_V(
                x_pred, self.hyperparameters))
            if noise.ndim == 1:
                v = v + noise
                if S is not None:
                    S = S + np.diag(noise)
            elif noise.ndim == 2:
                v = v + np.diag(noise)
                if S is not None:
                    S = S + noise
            else:
                warnings.warn("Noise could not be added: wrong noise format.")
        return v, S
