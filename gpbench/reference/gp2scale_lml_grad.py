"""The gp2Scale family's answer to ``lml_grad``: the value and gradient of
the mBCG estimator (``gp2scale.py``) at h, for the model's ``index``-th
evaluation, whose probes it draws."""

import math

import numpy as np
import torch

from .gp2scale import _PAIR_CHUNK, Gp2Scale, _quadrature, rademacher
from .precision import operand


class Gp2ScaleLmlGrad(Gp2Scale):
    def lml_grad(self, h, call_index):
        """(L, dL/dh) at ``h`` for the model's ``call_index``-th evaluation."""
        return self.lml_grads([h], [call_index])[0]

    def lml_grads(self, hs, calls):
        I, J, crow = self._structure(hs)
        out = []
        for h, call in zip(hs, calls):
            out.append(self._one(np.asarray(h, np.float64), call, I, J, crow))
        return out

    def _one(self, h, call, I, J, crow):
        dt, dev = self.dtype, self.device
        n_pad = self.nb * self.B
        hl = torch.as_tensor(h, dtype=torch.float64, device=dev)
        with torch.no_grad():
            vals = self._kvals(hl, I, J)
            A = torch.sparse_csr_tensor(
                crow, J, operand(vals.to(dt), self.precision),
                size=(n_pad, n_pad))
            noise = self.noise.to(dt)
            Lm, Minv = self._precond(h)
            U = rademacher(n_pad, self.probes, call, dt, dev) \
                * self.mask.to(dt)[:, None]
            Z = self._block(Lm, U)
            RHS = torch.cat([self.ym[:, None], Z], dim=1)
            X, alphas, betas = self._pcg(A, noise, Minv, RHS)
            x, S = X[:, 0], X[:, 1:]
            quad = torch.dot(self.ym, x)
            u2 = torch.sum(U * U, dim=0)
            ld = 2.0 * torch.sum(torch.log(torch.diagonal(
                Lm, dim1=1, dim2=2))) + _quadrature(alphas, betas, u2)
            value = -0.5 * (quad + ld + self.n * math.log(2.0 * math.pi))
            P = S.shape[1]
            Xp = torch.cat([x[:, None], self._block(Minv, Z)], dim=1)
            Cot = torch.cat([0.5 * x[:, None], (-0.5 / P) * S], dim=1)
        grad = torch.zeros(len(h), dtype=torch.float64, device=dev)
        for s in range(0, len(I), _PAIR_CHUNK):
            i, j = I[s:s + _PAIR_CHUNK], J[s:s + _PAIR_CHUNK]
            G = torch.sum(Cot[i].double() * Xp[j].double(), dim=1)
            hv = hl.clone().requires_grad_(True)
            with torch.enable_grad():
                k = self._kvals(hv, i, j)
                g, = torch.autograd.grad(torch.dot(k, G), hv)
            grad += g
        return float(value), grad.cpu().numpy()

    def answers(self, reqs, outs):
        res = self.lml_grads([r["h"] for r in reqs], [o["index"] for o in outs])
        return [{"value": v, "grad": g} for v, g in res]


def make(config, data, device, precision="exact"):
    return Gp2ScaleLmlGrad(config, data, device, precision)
