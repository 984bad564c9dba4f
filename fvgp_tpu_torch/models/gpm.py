"""GPm — multi-output GP regression on a learned linear manifold
(counterpart of ``fvgp_tpu/models/gpm.py``).

The manifold is a trainable linear embedding ``z = x @ W`` (D → L); the GP
lives on the L-dimensional manifold coordinates and all outputs share one
kernel there.  The objective is the multi-output trace-form marginal
likelihood ``-(0.5·tr(KV⁻¹YYᵀ)) - (Q/2)·log|KV| - (NQ/2)·log 2π``,
differentiated by autograd over (W, log hyperparameters, log noise) and
optimized with Adam (optax's ``adam(lr)``, written out in
``gp_training.adam_step``).  The posterior runs on the committed tensors
with autograd off, so on the card the default kernel's covariances come
from the K3 kernel.
"""

import math

import numpy as np
import torch

from .. import config
from ..kernels import default_matern_ard
from .gp_training import adam_step

__all__ = ["GPm"]

_LOG_2PI = math.log(2.0 * math.pi)


def cholesky_or_nan(KV):
    """The lower Cholesky factor of KV, or all NaN where KV is not positive
    definite (``jnp.linalg.cholesky``'s contract; no host sync)."""
    L, info = torch.linalg.cholesky_ex(KV)
    return torch.where(info == 0, L, torch.full_like(L, float("nan")))


def multi_output_neg_lml(K, log_noise, y):
    """0.5·(Q·log|KV| + tr(KV⁻¹YYᵀ) + NQ·log 2π) with KV = K + e^noise·I."""
    n, q = y.shape
    KV = K + torch.exp(log_noise) * torch.eye(n, dtype=K.dtype,
                                              device=K.device)
    L = cholesky_or_nan(KV)
    alpha = torch.cholesky_solve(y, L)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L)))
    return 0.5 * (q * logdet + torch.sum(y * alpha) + n * q * _LOG_2PI)


class GPm:
    """Multi-output GP on a learned linear manifold of the input space.

    Parameters
    ----------
    x_data : (N, D) inputs.
    y_data : (N, Q) outputs — all share the kernel on the manifold.
    manifold_dim : L, dimensionality of the manifold (default min(D, 2)).
    kernel_function : torch kernel k(z1, z2, hps) on manifold coordinates;
        default anisotropic Matérn-3/2 ARD (hps = [var, l_1..l_L]).
    init_hyperparameters : default ones(L+1).
    noise : initial observation noise variance (learned in log space).
    train_embedding : if False, W stays at its (PCA-seeded) initial value.
    args : optional dict; ``args["dtype"]`` sets the dtype as in ``GP``.
    compute_device : ``"cuda"`` (the default) or ``"cpu"``; float32 on the
        card, float64 on the CPU, unless ``args["dtype"]`` says otherwise.
    """

    def __init__(self, x_data, y_data, manifold_dim=None,
                 kernel_function=None, init_hyperparameters=None,
                 noise=1e-2, train_embedding=True, args=None,
                 compute_device="cuda"):
        x = np.asarray(x_data, dtype=np.float64)
        y = np.asarray(y_data, dtype=np.float64)
        if x.ndim != 2:
            raise AssertionError("x_data must be (N, D)")
        if y.ndim == 1:
            y = y[:, None]
        if y.ndim != 2 or len(y) != len(x):
            raise AssertionError("y_data must be (N, Q) matching x_data")
        self.args = dict(args) if args else {}
        self.device = config.resolve_device(compute_device)
        self.dtype = config.linalg_dtype(self.args, self.device)
        self.n, self.input_dim = x.shape
        self.q = y.shape[1]
        self.manifold_dim = int(manifold_dim or min(self.input_dim, 2))
        self.kernel = kernel_function or default_matern_ard
        self.train_embedding = bool(train_embedding)
        self._x = self._tensor(x)
        self._y_mean = y.mean(axis=0)
        self._y = self._tensor(y - self._y_mean)

        # PCA seed for the embedding: the leading input directions
        xc = x - x.mean(axis=0)
        _, _, vt = np.linalg.svd(xc, full_matrices=False)
        if init_hyperparameters is None:
            init_hyperparameters = np.ones(self.manifold_dim + 1)
        self.W = self._tensor(vt[: self.manifold_dim].T)      # (D, L)
        self.hyperparameters = np.asarray(init_hyperparameters,
                                          dtype=np.float64)
        self.log_noise = float(np.log(noise))

    def _tensor(self, a):
        return config.to_tensor(a, self.device, self.dtype)

    # ------------------------------------------------------------------
    def _neg_lml(self, W, log_hps, log_noise):
        z = self._x @ W
        return multi_output_neg_lml(self.kernel(z, z, torch.exp(log_hps)),
                                    log_noise, self._y)

    def _params(self):
        return (self.W, self._tensor(np.log(self.hyperparameters)),
                self._tensor(self.log_noise))

    def embed(self, x):
        """Manifold coordinates z = x @ W."""
        return config.to_numpy(self._tensor(x) @ self.W)

    def log_likelihood(self):
        """Multi-output marginal log-likelihood at the current state."""
        with torch.no_grad():
            return -float(self._neg_lml(*self._params()))

    # ------------------------------------------------------------------
    def train(self, max_iter=500, learning_rate=1e-2, info=False):
        """Adam over (W, log hps, log noise); with ``train_embedding``
        False, W is put back after every step."""
        params = [p.detach().clone() for p in self._params()]
        frozen_W = params[0]
        moments = [(torch.zeros_like(p), torch.zeros_like(p))
                   for p in params]
        for it in range(int(max_iter)):
            leaves = [p.requires_grad_(True) for p in params]
            with torch.enable_grad():
                loss = self._neg_lml(*leaves)
                grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                stepped = [adam_step(p.detach(), g, m, v, it + 1,
                                     learning_rate)
                           for p, g, (m, v) in zip(params, grads, moments)]
            params = [s[0] for s in stepped]
            moments = [(s[1], s[2]) for s in stepped]
            if not self.train_embedding:
                params[0] = frozen_W
            if info and it % 50 == 0:
                print(f"GPm iter {it}: loss {float(loss):.4f}")
        W, log_hps, log_noise = (p.detach() for p in params)
        self.W = W
        self.hyperparameters = np.exp(config.to_numpy(log_hps))
        self.log_noise = float(log_noise)
        return self.hyperparameters

    # ------------------------------------------------------------------
    def _factor(self, x_pred):
        """(k(z, z*), KV's Cholesky factor, hps, z*) at the committed
        state; autograd off, so the default kernel runs on K3 on the
        card."""
        hps = self._tensor(self.hyperparameters)
        z = self._x @ self.W
        zq = self._tensor(x_pred) @ self.W
        K = self.kernel(z, z, hps)
        KV = K + math.exp(self.log_noise) * torch.eye(
            self.n, dtype=self.dtype, device=self.device)
        return self.kernel(z, zq, hps), torch.linalg.cholesky(KV), hps, zq

    @torch.no_grad()
    def posterior_mean(self, x_pred):
        """(n_pred, Q) posterior mean — one shared multi-RHS solve."""
        ks, L, _, _ = self._factor(x_pred)
        alpha = torch.cholesky_solve(self._y, L)
        return config.to_numpy(ks.T @ alpha) + self._y_mean

    @torch.no_grad()
    def posterior_variance(self, x_pred):
        """(n_pred,) posterior variance, shared across outputs."""
        ks, L, hps, zq = self._factor(x_pred)
        kss = torch.diagonal(self.kernel(zq, zq, hps))
        sol = torch.cholesky_solve(ks, L)
        v = kss - torch.sum(ks * sol, dim=0)
        return config.to_numpy(torch.clamp(v, min=0.0))

    # ------------------------------------------------------------------
    def __getstate__(self):
        """Host arrays and the device's name (the JAX ``GPm``'s state plus
        ``device``); the kernel callable must itself be picklable."""
        state = dict(self.__dict__)
        for key in ("W", "_x", "_y"):
            state[key] = config.to_numpy(state[key])
        state["device"] = str(self.device)
        state.pop("dtype")
        return state

    def __setstate__(self, state):
        state = dict(state)
        self.device = config.resolve_device(state.pop("device"))
        self.args = state.pop("args", {})
        self.dtype = config.linalg_dtype(self.args, self.device)
        self.__dict__.update(state)
        for key in ("W", "_x", "_y"):
            setattr(self, key, self._tensor(np.asarray(state[key])))
