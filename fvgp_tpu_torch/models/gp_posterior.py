"""Posterior mean and variance under gp2Scale (counterpart of
``fvgp_tpu/models/gp_posterior.py``): solves go through the committed-state
fast solver; the mean's kᵀ(K+V)⁻¹(y-m) product is fused into the chunked
kernel sweep at scale.  Returned dicts carry host numpy arrays with the
JAX package's keys.  Gradients, joint priors, the full covariance and the
information-theory suite are not ported yet (ROADMAP item 1.2).
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
        self._cross_cov_memo = None

    @property
    def hyperparameters(self):
        return self.trainer.hyperparameters

    @property
    def x_data(self):
        return self.data.x_data

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
        """kᵀ·KVinvY for the posterior mean: fused into the chunked kernel
        sweep at scale, unless the memo already holds k for this query."""
        if len(self.x_data) > self.prior.batch_size:
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
        """kᵀ (K+V)⁻¹ k in column chunks of the fast solver's budget;
        ``diag=True`` returns only its diagonal (the variance path)."""
        n_pred = k.shape[1]
        chunk_size = self.kv.fast_solve_col_budget()
        if chunk_size is None:
            chunk_size = self.prior.batch_size
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
        if x_out is not None:
            raise NotImplementedError(
                "fvgp_tpu_torch: x_out (multi-task output coordinates) is "
                "not ported yet (ROADMAP item 1.6, fvGP)")

    # ------------------------------------------------------------------
    def posterior_mean(self, x_pred, hyperparameters=None, x_out=None):
        """m(x*) + k*ᵀ(K+V)⁻¹(y-m) at the committed hyperparameters."""
        if hyperparameters is not None:
            raise NotImplementedError(
                "fvgp_tpu_torch: posterior_mean(hyperparameters=...) needs "
                "the stored trial K+V, which is not ported yet (ROADMAP item "
                "1.4)")
        self._perform_input_checks(x_pred, x_out)
        hyperparameters = self.hyperparameters
        KVinvY = self.kv.KVinvY
        A = self._mean_product(x_pred, hyperparameters, KVinvY)
        prior_mean = config.to_numpy(self.prior.compute_mean(
            x_pred, hyperparameters))
        posterior_mean = prior_mean[:, None] + A
        return {"x": x_pred.copy(), "m(x)": np.squeeze(posterior_mean),
                "m(x)_flat": np.squeeze(posterior_mean), "x_pred": x_pred}

    def posterior_covariance(self, x_pred, x_out=None, variance_only=False,
                             add_noise=False):
        """Posterior variances k(x*,x*) - diag(k*ᵀ(K+V)⁻¹k*) (the
        ``variance_only=True`` path)."""
        if not variance_only or add_noise:
            raise NotImplementedError(
                "fvgp_tpu_torch: only posterior_covariance(variance_only=True"
                ", add_noise=False) is ported so far (ROADMAP item 1.2)")
        self._perform_input_checks(x_pred, x_out)
        k = self._cross_cov(x_pred, self.hyperparameters)
        kk = self.prior.compute_covariances(x_pred, x_pred,
                                            self.hyperparameters)
        v = config.to_numpy(torch.diagonal(kk)
                            - self._cross_solve_product(k, diag=True))
        if np.any(v < -0.0001):
            warnings.warn(
                "Negative variances encountered. That normally means the "
                "model is unstable. Rethink the kernel definition, add more "
                "noise, or double check the hyperparameter optimization "
                "bounds.")
        v[v < 0.0] = 0.0
        return {"x": x_pred.copy(), "x_pred": x_pred, "v(x)": v, "S": None,
                "S_flat": None, "v_flat": v}
