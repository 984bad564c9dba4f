"""The gp2Scale family's answer to ``predict``: at the committed h₀, the
posterior mean and variance at the request's points x*,

    m(x*) = ȳ + k*ᵀ (K+V)⁻¹ (y − ȳ),
    v(x*) = k(x*, x*) − diag(k*ᵀ (K+V)⁻¹ k*), clamped at 0,

with k* = k(X, x*) the anisotropic Wendland cross covariance worked out
element by element in float64 (``gp2scale.py``), K on ``gp2scale.py``'s
Morton order, pairs and structure, and every solve ``gp2scale.py``'s
block-Jacobi PCG (``_pcg``).  It imports nothing of the program.

Departures from fvGP's posterior (``fvgp/gp_posterior.py``,
``posterior_mean`` and ``posterior_covariance(variance_only=True)``):

* fvGP's gp2Scale solves K+V with scipy's sparse solvers on the host; here
  every solve is a block-Jacobi preconditioned CG on the card, whose
  answer is the same linear solve to the precision below.
* The prior mean is fvGP's default, the constant mean of y; k(x*, x*) is
  the signal variance h₀[0] (the Wendland kernel at distance 0).
* A variance below 0 is set to 0, as fvGP and the program do, without
  fvGP's warning.

In ``exact`` precision everything is float64 and the CG runs until every
column's preconditioned residual has fallen by 1e-11 (squared, 1e-22):
the exact posterior, free of the program's trip cap and rounding.  In
``tf32`` precision (the control) the CG runs as the program's committed
solver is configured (a cap of max(96, 3 · sparse_cg_maxiter) trips and
float32's exit floor, a squared relative residual of 1e-8; the weights
(K+V)⁻¹(y − ȳ) refined once against their residual, as the program refines
them below float64), in float32 with every product's operands rounded to
TF32.

The variance's columns are solved together, in column blocks sized to the
card's free memory (the program's state is freed before the check).
"""

import numpy as np
import torch

from .gp2scale import Gp2Scale, wendland
from .precision import operand

POSTERIOR_CG_CAP = 96       # the committed solver's least trip cap
FLOAT32_EXIT_SQ = 1e-8      # float32's squared relative exit floor
_ROWS = 1 << 16             # data rows per chunk of k(X, x*)
_BUFFERS = 16               # (n_pad, columns) float64 arrays a CG block holds


class Gp2ScalePredict(Gp2Scale):
    def __init__(self, config, data, device, precision="exact"):
        super().__init__(config, data, device, precision)
        if precision != "exact":
            train = int(config["gp"]["args"].get("sparse_cg_maxiter", 0))
            self.iters = max(POSTERIOR_CG_CAP, 3 * train)
            self.tol_sq = FLOAT32_EXIT_SQ
        self.h0 = np.asarray(config["gp"]["init_hyperparameters"],
                             np.float64)
        self.ybar = float(np.mean(np.asarray(data["y"], np.float64)))
        self._state = None
        self.trips = []             # CG trips of each solve, in order

    def _op(self, t):
        return operand(t.to(self.dtype), self.precision)

    def _solve(self, A, noise, Minv, RHS):
        X, alphas, _ = self._pcg(A, noise, Minv, RHS.to(self.dtype))
        self.trips.append(int(alphas.shape[0]))
        return X

    def commit(self):
        """(h₀, K+V's parts, (K+V)⁻¹(y − ȳ)) at the committed h₀."""
        if self._state is None:
            h = torch.as_tensor(self.h0, dtype=torch.float64,
                                device=self.device)
            I, J, crow = self._structure([self.h0])
            n_pad = self.nb * self.B
            A = torch.sparse_csr_tensor(crow, J,
                                        self._op(self._kvals(h, I, J)),
                                        size=(n_pad, n_pad))
            noise = self.noise.to(self.dtype)
            _, Minv = self._precond(self.h0)
            alpha = self._solve(A, noise, Minv, self.ym[:, None])
            if self.precision != "exact":
                # the program refines its committed weights once
                r = self.ym[:, None] - (torch.sparse.mm(A, self._op(alpha))
                                        + noise[:, None] * alpha)
                alpha = alpha + self._solve(A, noise, Minv, r)
            self._state = (h, A, noise, Minv, alpha)
        return self._state

    def cross(self, h, q):
        """k(X, x*) in the storage order, float64; padding rows are 0."""
        qw = q / h[1:]
        out = torch.empty((self.nb * self.B, len(q)), dtype=torch.float64,
                          device=q.device)
        for s in range(0, len(out), _ROWS):
            d = torch.cdist(self.x[s:s + _ROWS] / h[1:], qw,
                            compute_mode="donot_use_mm_for_euclid_dist")
            out[s:s + _ROWS] = h[0] * wendland(d) \
                * self.mask[s:s + _ROWS, None]
        return out

    def live_tiles(self, h):
        """``Gp2Scale.live_tiles``, from the committed pairs where ``h`` is
        the committed h."""
        h = np.asarray(h, np.float64)
        if self._pairs is None or not np.array_equal(self._pairs[0], h[1:]):
            return super().live_tiles(h)
        I, J = self._pairs[1], self._pairs[2]
        return int(torch.unique((I // self.B) * self.nb
                                + J // self.B).numel())

    def _columns(self, total):
        """Columns per variance solve: all of them off the card, else what
        ``_BUFFERS`` float64 arrays of them leave of 70% of free memory."""
        if torch.device(self.device).type != "cuda":
            return total
        free = torch.cuda.mem_get_info(torch.device(self.device))[0]
        per = _BUFFERS * self.nb * self.B * 8
        return max(1, min(total, int(0.7 * free) // per))

    def predict(self, queries):
        """[(mean, variance)] at the committed h₀ for each point set of
        ``queries``."""
        with torch.no_grad():
            h, A, noise, Minv, alpha = self.commit()
            q = torch.cat([torch.as_tensor(np.asarray(x, np.float64),
                                           dtype=torch.float64,
                                           device=self.device)
                           for x in queries])
            means, variances = [], []
            step = self._columns(len(q))
            for s in range(0, len(q), step):
                ks = self.cross(h, q[s:s + step])
                means.append(self.ybar + (self._op(ks).T @ self._op(alpha))
                             [:, 0].double())
                X = self._solve(A, noise, Minv, ks)
                quad = torch.sum(self._op(ks) * self._op(X), dim=0)
                variances.append(torch.clamp(h[0] - quad.double(), min=0.0))
                del ks, X
            mean = torch.cat(means).cpu().numpy()
            var = torch.cat(variances).cpu().numpy()
        ends = np.cumsum([len(x) for x in queries])[:-1]
        return list(zip(np.split(mean, ends), np.split(var, ends)))

    def answers(self, reqs, outs):
        return [{"mean": m, "var": v}
                for m, v in self.predict([r["xq"] for r in reqs])]


def make(config, data, device, precision="exact"):
    # float32 products in full float32: the control rounds its operands
    # to TF32 itself, and nothing else may round them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return Gp2ScalePredict(config, data, device, precision)
