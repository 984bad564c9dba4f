"""The dense family's answer to ``lml_grad``:

    L(h) = −½ [(y − m)ᵀ A⁻¹ (y − m) + log|A| + N log 2π]

and its gradient, autograd's through the Cholesky factor."""

import math

import numpy as np
import torch

from .dense import DenseData


class DenseLmlGrad(DenseData):
    def _lml(self, h):
        _, L = self.factor(h)
        ym = self._op(self.ym)[:, None]
        alpha = torch.cholesky_solve(ym, L)
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L)))
        quad = torch.sum(ym * alpha)
        return -0.5 * (quad + logdet + len(self.x) * math.log(2.0 * math.pi))

    def lml_grad(self, h):
        hv = torch.as_tensor(np.asarray(h, np.float64), dtype=torch.float64,
                             device=self.device).requires_grad_(True)
        with torch.enable_grad():
            val = self._lml(hv)
            g, = torch.autograd.grad(val, hv)
        return float(val.detach()), g.cpu().numpy()

    def answers(self, reqs, outs):
        res = []
        for r in reqs:
            value, grad = self.lml_grad(r["h"])
            res.append({"value": value, "grad": grad})
        return res


def make(config, data, device, precision="exact"):
    return DenseLmlGrad(config, data, device, precision)
