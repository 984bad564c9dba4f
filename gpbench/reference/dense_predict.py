"""The dense family's answer to ``predict``: at the committed h₀, the mean
m + k*ᵀ A⁻¹ (y − m) and the variance k(x*, x*) − k*ᵀ A⁻¹ k*, clamped at 0
as the public API clamps it."""

import numpy as np
import torch

from .dense import DenseData, matern32_ard


class DensePredict(DenseData):
    _committed = None

    def _commit(self):
        if self._committed is None:
            h = torch.as_tensor(self.h0, dtype=torch.float64,
                                device=self.device)
            _, L = self.factor(h)
            alpha = torch.cholesky_solve(self._op(self.ym)[:, None], L)
            self._committed = (h, L, alpha)
        return self._committed

    def predict(self, xq):
        """(mean, variance) at the committed h for the points ``xq``."""
        with torch.no_grad():
            h, L, alpha = self._commit()
            q = torch.as_tensor(np.asarray(xq, np.float64),
                                dtype=torch.float64, device=self.device)
            ks = self._op(matern32_ard(self.x, q, h))
            mean = self.m + (ks.T @ self._op(alpha))[:, 0]
            w = torch.linalg.solve_triangular(L, ks, upper=False)
            var = torch.clamp(h[0] - torch.sum(w.double() ** 2, dim=0),
                              min=0.0)
        return mean.double().cpu().numpy(), var.cpu().numpy()

    def answers(self, reqs, outs):
        res = []
        for r in reqs:
            mean, var = self.predict(r["xq"])
            res.append({"mean": mean, "var": var})
        return res


def make(config, data, device, precision="exact"):
    return DensePredict(config, data, device, precision)
