"""Noise model V (counterpart of ``fvgp_tpu/models/gp_likelihood.py``):
measured per-point variances, the default ``(0.01·mean|y|)²`` floor, or a
user noise callable ``noise(x, hps)`` / ``noise(x, hps, args)`` (arity
sniffed) returning a per-point variance vector, a dense covariance matrix,
or a structured matrix (``scipy.sparse`` or a ``BlockSparseMatrix``).

* A callable that runs on torch tensors is "traceable": it takes the
  points and hyperparameters as tensors on the model's device, autograd
  differentiates it inside the traced dense LML, and its dV/dh is
  forward-mode AD (the JAX package's ``jacfwd``).
* A host (numpy) callable takes numpy points (a list on a non-Euclidean
  input space) and numpy hyperparameters; its dV/dh is a central
  difference at step 1e-6, evaluated in float64 — structured returns are
  densified for it.  A structured V itself stays structured: ``GPkv.addKV``
  folds it into K+V (densified on a dense K, merged tile by tile on a
  block-sparse K).
* ``noise_function_grad(x, hps)`` (or ``(x, hps, direction)`` with
  ``ram_economy=True``) takes numpy and returns dV/dh as numpy or a tensor;
  it wins over every other rule.
"""

import inspect
import warnings

import numpy as np
import torch

from .. import config


def _is_structured(obj):
    """scipy.sparse or BlockSparseMatrix noise (structured, host-built)."""
    from scipy.sparse import issparse

    from ..parallel.block_sparse import is_block_sparse
    return issparse(obj) or is_block_sparse(obj)


def _densify(obj):
    """A structured matrix (or anything array-like) as a dense float64 host
    array."""
    from scipy.sparse import issparse

    from ..parallel.block_sparse import is_block_sparse
    if issparse(obj):
        return obj.toarray()
    if is_block_sparse(obj):
        return config.to_numpy(obj.to_dense())
    if torch.is_tensor(obj):
        return config.to_numpy(obj)
    return np.asarray(obj, dtype=np.float64)


class GPlikelihood:
    def __init__(self, data, trainer, noise_function=None,
                 noise_function_grad=None):
        self.data = data
        self.trainer = trainer
        nv = self.noise_variances
        if nv is not None:
            if not (isinstance(nv, np.ndarray) and nv.ndim == 1):
                raise AssertionError("noise_variances must be a 1-d np.ndarray")
            if not np.all(nv > 0.0):
                raise AssertionError("all noise_variances must be positive")
            if callable(noise_function):
                raise Exception("Noise function and measurement noise "
                                "provided. Decide which one to use.")
        self.v_n_params = 2
        self._mode = "default"
        if callable(noise_function):
            self.noise_function = noise_function
            self.v_n_params = len(inspect.signature(noise_function).parameters)
            self._mode = "callable"
        elif nv is not None:
            self.noise_function = self._measured_noise_function
            self._mode = "measured"
        else:
            warnings.warn("No noise function or measurement noise provided. "
                          "Noise variances will be set to "
                          "(0.01*mean(|y_data|))**2.", stacklevel=2)
            self.noise_function = self._default_noise_function
        self._user_noise_grad = noise_function_grad \
            if callable(noise_function_grad) else None

        self.noise_traceable = self._mode != "callable"
        if self._mode == "callable" and self.data.Euclidean:
            x2 = self._tensor(np.asarray(self.x_data[:2], dtype=np.float64))
            h = self._tensor(self.hyperparameters)
            self.noise_traceable = config.returns_tensor(self.call_noise, x2, h)
        self.V = self.calculate_V(self.x_data, self.hyperparameters)

    # -- plumbing ----------------------------------------------------------
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
    def noise_variances(self):
        return self.data.noise_variances

    @property
    def ram_economy(self):
        return self.data.ram_economy

    @property
    def dtype(self):
        return config.linalg_dtype(self.args, self.data.device)

    def _tensor(self, a, dtype=None):
        return config.to_tensor(a, self.data.device, dtype or self.dtype)

    @staticmethod
    def _host_x(x):
        """Points for a host callable: a list stays a list."""
        if isinstance(x, list):
            return x
        return config.to_numpy(x) if torch.is_tensor(x) else np.asarray(x)

    # ------------------------------------------------------------------
    def update_state(self):
        self.V = self.calculate_V(self.x_data, self.hyperparameters)

    def call_noise(self, x, hps):
        """The noise callable by its arity: ``(x, hps)`` or
        ``(x, hps, args)``."""
        if self.v_n_params == 2:
            return self.noise_function(x, hps)
        if self.v_n_params == 3:
            return self.noise_function(x, hps, self.args)
        raise Exception("No valid noise function signature.")

    def _host_noise(self, x_data, hyperparameters):
        """The host callable's return at (x, hps): numpy or structured."""
        return self.call_noise(self._host_x(x_data),
                               np.asarray(hyperparameters, dtype=np.float64))

    def calculate_V(self, x_data, hyperparameters):
        """The noise: a tensor on the model's device (a per-point variance
        vector, or a dense matrix from a matrix-valued callable), or — for
        a host callable returning ``scipy.sparse`` / ``BlockSparseMatrix`` —
        that structured matrix itself."""
        if self._mode == "callable":
            if self.noise_traceable:
                noise = self.call_noise(self._tensor(x_data),
                                        self._tensor(hyperparameters))
                return noise.to(self.dtype)
            noise = self._host_noise(x_data, hyperparameters)
            if _is_structured(noise):
                return noise
            return self._tensor(noise)
        return self._tensor(self.calculate_V_host(x_data, hyperparameters))

    def calculate_V_grad(self, x, hyperparameters, direction=None):
        """dV/dh on the model's device: (H, n) or (H, n, n), or the one
        ``direction`` (n,) / (n, n).  The user's gradient callable, else
        forward-mode AD of a traceable callable, else central differences
        of a host callable (in float64), else zeros: the measured and
        default noise carry no hyperparameters."""
        H = len(hyperparameters)
        if self._user_noise_grad is not None:
            hps = np.asarray(hyperparameters, dtype=np.float64)
            x_in = self._host_x(x)
            g = self._user_noise_grad(x_in, hps, direction) \
                if self.ram_economy else self._user_noise_grad(x_in, hps)
            return self._tensor(g)
        if self._mode != "callable":
            shape = (len(x),) if self.ram_economy else (H, len(x))
            return torch.zeros(shape, dtype=self.dtype,
                               device=self.data.device)
        if self.noise_traceable:
            xt = self._tensor(x)
            return config.hps_jacobian(
                lambda h: self.call_noise(xt, h),
                self._tensor(hyperparameters), direction).to(self.dtype)
        if direction is not None:
            return self._fd(x, hyperparameters, direction)
        return torch.stack([self._fd(x, hyperparameters, i)
                            for i in range(H)])

    def _fd(self, x, hyperparameters, i):
        """Central difference of a host noise callable in direction ``i``
        (step 1e-6, as in the JAX package), taken in float64; a structured
        return is densified."""
        h1 = np.array(hyperparameters, dtype=np.float64)
        h2 = np.array(hyperparameters, dtype=np.float64)
        h1[i] += 1e-6
        h2[i] -= 1e-6
        V1 = _densify(self._host_noise(x, h1))
        V2 = _densify(self._host_noise(x, h2))
        return self._tensor((V1 - V2) / 2e-6)

    def calculate_V_host(self, x_data, hyperparameters):
        """Host (numpy float64) noise diagonal, or None where there is none
        without a device round trip (a traceable callable) or none at all
        (structured or matrix-valued noise).  The scale paths pad and block
        it on the host before one transfer to the device."""
        if self._mode != "callable":
            return np.asarray(self.noise_function(x_data, hyperparameters),
                              dtype=np.float64)
        if not self.noise_traceable:
            noise = self._host_noise(x_data, hyperparameters)
            if _is_structured(noise):
                return None
            noise = np.asarray(noise, dtype=np.float64)
            return noise if noise.ndim == 1 else None
        return None

    # ------------------------------------------------------------------
    def _default_noise_function(self, x, hyperparameters):
        """(0.01 mean|y|)² per point."""
        level = (float(np.mean(np.abs(np.asarray(self.y_data)))) / 100.0) ** 2
        return np.full((len(x),), level)

    def _measured_noise_function(self, x, hyperparameters):
        """Measured variances; mean level for prediction points."""
        if len(x) == len(self.noise_variances):
            return self.noise_variances
        return np.full((len(x),), float(np.mean(self.noise_variances)))

    # ------------------------------------------------------------------
    def __getstate__(self):
        return config.host_state(dict(self.__dict__))

    def __setstate__(self, state):
        self.__dict__.update(config.device_state(state))
