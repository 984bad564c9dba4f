"""Noise model V (counterpart of ``fvgp_tpu/models/gp_likelihood.py``):
measured per-point variances or the default ``(0.01·mean|y|)²`` floor, as
a diagonal.  User noise callables are not ported yet (ROADMAP item 1.6).
"""

import warnings

import numpy as np
import torch

from .. import config


class GPlikelihood:
    def __init__(self, data, trainer, noise_function=None,
                 noise_function_grad=None):
        if callable(noise_function) or callable(noise_function_grad):
            raise NotImplementedError(
                "fvgp_tpu_torch: noise_function callables are not ported yet "
                "(ROADMAP item 1.6, host callables and structured noise)")
        self.data = data
        self.trainer = trainer
        nv = self.noise_variances
        if nv is not None:
            if not (isinstance(nv, np.ndarray) and nv.ndim == 1):
                raise AssertionError("noise_variances must be a 1-d np.ndarray")
            if not np.all(nv > 0.0):
                raise AssertionError("all noise_variances must be positive")
            self.noise_function = self._measured_noise_function
            self._mode = "measured"
        else:
            warnings.warn("No noise function or measurement noise provided. "
                          "Noise variances will be set to "
                          "(0.01*mean(|y_data|))**2.", stacklevel=2)
            self.noise_function = self._default_noise_function
            self._mode = "default"
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

    # ------------------------------------------------------------------
    def update_state(self):
        self.V = self.calculate_V(self.x_data, self.hyperparameters)

    def calculate_V(self, x_data, hyperparameters):
        """The noise diagonal as a tensor on the model's device."""
        return torch.as_tensor(
            self.calculate_V_host(x_data, hyperparameters),
            dtype=config.linalg_dtype(self.args, self.data.device)
        ).to(self.data.device)

    def calculate_V_host(self, x_data, hyperparameters):
        """Host (numpy float64) noise diagonal — the scale paths pad and
        block it on the host before one transfer to the device."""
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
