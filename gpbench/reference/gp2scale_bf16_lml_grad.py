"""The gp2scale_bf16 family's answer to ``lml_grad``: ``gp2scale_lml_grad``'s
estimator, value and gradient, at h for the model's ``index``-th
evaluation.  ``exact`` is that reference unchanged; the control
(``gp2scale_bf16.py``) stores the tiles and takes every product operand
in E4M3, and stops the CG at the configuration's exit floor."""

import torch

from .gp2scale_bf16 import exit_floor_sq, round_e4m3
from .gp2scale_lml_grad import Gp2ScaleLmlGrad


class Gp2ScaleBf16LmlGrad(Gp2ScaleLmlGrad):
    def __init__(self, config, data, device, precision="exact"):
        super().__init__(config, data, device, precision)
        self.control = precision != "exact"
        if self.control:
            self.tol_sq = exit_floor_sq(config)

    def _low(self, t):
        return round_e4m3(t) if self.control else t

    def _kvals(self, h, I, J):
        # the stored tiles' values (computed without a gradient) are
        # rounded; the gradient's ∂K/∂h is taken of the values themselves
        vals = super()._kvals(h, I, J)
        return vals if torch.is_grad_enabled() else self._low(vals)

    def _block(self, mats, X):
        return super()._block(self._low(mats), self._low(X))

    def _pcg(self, A, noise, Minv, RHS):
        """``Gp2Scale._pcg`` with the direction rounded before each product
        with the tiles (the control's); the same as it in ``exact``."""
        if not self.control:
            return super()._pcg(A, noise, Minv, RHS)

        def mv(D):
            return torch.sparse.mm(A, round_e4m3(D)) + noise[:, None] * D

        X = torch.zeros_like(RHS)
        R = RHS.clone()
        D = self._block(Minv, R)
        rz = torch.sum(R * D, dim=0)
        floor = rz * 1e-10
        exit_floor = rz * self.tol_sq
        one, zero = torch.ones_like(rz[0]), torch.zeros_like(rz[0])
        alphas, betas = [], []
        it = 0
        while it < self.iters and bool((rz > exit_floor).any()):
            active = rz > floor
            AD = mv(D)
            dAd = torch.sum(D * AD, dim=0)
            alpha = torch.where(active, rz / torch.where(active, dAd, one),
                                zero)
            X = X + D * alpha
            R = R - AD * alpha
            Z2 = self._block(Minv, R)
            rz2 = torch.sum(R * Z2, dim=0)
            beta = torch.where(active, rz2 / torch.where(active, rz, one),
                               zero)
            D = Z2 + D * beta
            alphas.append(torch.where(active, alpha, one)[1:])
            betas.append(torch.where(active, beta, zero)[1:])
            rz = rz2
            it += 1
        if not alphas:          # a run that never started: one frozen trip
            alphas.append(torch.ones_like(rz[1:]))
            betas.append(torch.zeros_like(rz[1:]))
        return X, torch.stack(alphas).double(), torch.stack(betas).double()


def make(config, data, device, precision="exact"):
    return Gp2ScaleBf16LmlGrad(config, data, device, precision)
