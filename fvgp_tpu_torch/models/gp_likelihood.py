"""Noise model V (counterpart of ``fvgp_tpu/models/gp_likelihood.py``):
measured per-point variances, the default ``(0.01·mean|y|)²`` floor, or a
user noise callable ``noise(x, hps)`` / ``noise(x, hps, args)`` (arity
sniffed) returning a per-point variance vector or a dense covariance
matrix.  A callable that runs on torch tensors is differentiable by
autograd and enters the traced dense LML; a host (numpy) callable gives V
but its gradient engine, ``calculate_V_grad`` and structured (sparse)
noise wait for ROADMAP item 1.6.
"""

import inspect
import warnings

import numpy as np
import torch

from .. import config


def _returns_tensor(fn, x, hps):
    """The "differentiable by autograd" probe: True when ``fn(x, hps)``
    (or ``fn(x, x, hps)`` via a wrapper) runs on torch tensors while
    autograd records ``hps`` and returns a tensor.  A host (numpy) callable
    fails here: numpy refuses a tensor that requires grad."""
    try:
        with torch.enable_grad():
            return isinstance(fn(x, hps.detach().clone().requires_grad_(True)),
                              torch.Tensor)
    except Exception:
        return False


class GPlikelihood:
    def __init__(self, data, trainer, noise_function=None,
                 noise_function_grad=None):
        if callable(noise_function_grad):
            raise NotImplementedError(
                "fvgp_tpu_torch: noise_function_grad is not ported yet "
                "(ROADMAP item 1.6, the formula gradient engine)")
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
            if data.gp2Scale:
                raise NotImplementedError(
                    "fvgp_tpu_torch: noise callables under gp2Scale are not "
                    "ported yet (ROADMAP item 1.6)")
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

        self.noise_traceable = self._mode != "callable"
        if self._mode == "callable" and self.data.Euclidean:
            x2 = self._tensor(np.asarray(self.x_data[:2], dtype=np.float64))
            h = self._tensor(self.hyperparameters)
            self.noise_traceable = _returns_tensor(self.call_noise, x2, h)
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
    def dtype(self):
        return config.linalg_dtype(self.args, self.data.device)

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64),
                               dtype=self.dtype).to(self.data.device)

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

    def calculate_V(self, x_data, hyperparameters):
        """The noise as a tensor on the model's device: a per-point variance
        vector, or a dense matrix from a matrix-valued callable."""
        if self._mode == "callable":
            if self.noise_traceable:
                noise = self.call_noise(self._tensor(x_data),
                                        self._tensor(hyperparameters))
                return noise.to(self.dtype)
            noise = self.call_noise(
                x_data if isinstance(x_data, list) else np.asarray(x_data),
                np.asarray(hyperparameters))
            if not isinstance(noise, (np.ndarray, list, float, int)):
                raise NotImplementedError(
                    "fvgp_tpu_torch: structured (sparse) noise is not ported "
                    "yet (ROADMAP item 1.6)")
            return self._tensor(noise)
        return self._tensor(self.calculate_V_host(x_data, hyperparameters))

    def calculate_V_host(self, x_data, hyperparameters):
        """Host (numpy float64) noise diagonal of the measured or default
        noise — the scale paths pad and block it on the host before one
        transfer to the device."""
        return np.asarray(self.noise_function(x_data, hyperparameters),
                          dtype=np.float64)

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
