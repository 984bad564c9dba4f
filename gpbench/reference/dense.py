"""Plain reference of the dense family: the exact GP with the Matérn-3/2
ARD kernel, in float64 on whole matrices.  The request kinds' answers are
worked out in ``dense_<op>.py`` from what is here.

It imports nothing of the program and takes only the benchmark's inputs:

    K_ij = h₀ · (1 + √3 d_ij) exp(−√3 d_ij),  d_ij = ‖(x_i − x_j) / h₁..D‖
    A = K + diag(noise),  m = mean(y)

In ``tf32`` precision (the control) every matrix that enters a product or
a factorization is float32 rounded to TF32 first.
"""

import math

import numpy as np
import torch

from .precision import dtype_of, operand

_SQRT3 = math.sqrt(3.0)


def matern32_ard(x1, x2, h):
    """h₀ · Matérn-3/2 of the anisotropic distance; the gradient is 0 where
    two points coincide."""
    d2 = (((x1[:, None, :] - x2[None, :, :]) / h[1:]) ** 2).sum(-1)
    off = d2 > 0
    d = torch.sqrt(torch.where(off, d2, torch.ones_like(d2)))
    a = _SQRT3 * d
    return h[0] * torch.where(off, (1.0 + a) * torch.exp(-a),
                              torch.ones_like(a))


class DenseData:
    """One configuration's data as float64 tensors on ``device``."""

    def __init__(self, config, data, device, precision="exact"):
        self.precision = precision
        self.dtype = dtype_of(precision)
        self.device = device
        f64 = dict(dtype=torch.float64, device=device)
        self.x = torch.as_tensor(np.asarray(data["x"], np.float64), **f64)
        y = torch.as_tensor(np.asarray(data["y"], np.float64), **f64)
        self.m = float(y.mean())
        self.ym = y - self.m
        self.noise = torch.as_tensor(np.asarray(data["noise"], np.float64),
                                     **f64)
        self.h0 = np.asarray(config["gp"]["init_hyperparameters"], np.float64)

    def _op(self, t):
        return operand(t.to(self.dtype), self.precision)

    def factor(self, h):
        """(A(h), its Cholesky factor in the reference's precision)."""
        A = matern32_ard(self.x, self.x, h) + torch.diag(self.noise)
        return A, torch.linalg.cholesky(self._op(A))
