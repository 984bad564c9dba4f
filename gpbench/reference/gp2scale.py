"""Plain reference of the gp2Scale family: a compactly supported
(anisotropic Wendland) kernel, element by element, in float64.  The request
kinds' answers are worked out in ``gp2scale_<op>.py`` from what is here.

It imports nothing of the program.  From the benchmark's inputs (points,
values, noise) it works out again everything the estimator is defined by:

* the storage order: points sorted along a Morton (Z-order) curve of 16-bit
  cells per axis, ties in input order, blocked by ``block_size`` with the
  last block padded (padding carries noise 1 and no covariance);
* the covariance: every pair of points whose whitened distance is below 1,
  found from the blocks' bounding boxes and then point by point;
* the estimator, the fused mBCG recipe (Gardner et al. 2018): one
  block-Jacobi preconditioned CG over ``[y - mean(y) | L_M u]`` gives the
  solve and, from its coefficients, a Lanczos quadrature of
  log|M⁻¹(K+V)| on Rademacher probes u; log|M| is exact.  The probes follow
  the law the program documents: ±1 from ``torch.randint`` on a CPU
  generator seeded ``42 + i`` for the model's i-th evaluation.
* the gradient estimator: dL/dh = Σ_ij ∂K_ij/∂h · G_ij with
  G = ½ x xᵀ − (½/P) Σ_j s_j (M⁻¹z_j)ᵀ, x = (K+V)⁻¹(y - m), s_j = (K+V)⁻¹z_j.

In ``exact`` precision the CG runs in float64 until every column's
preconditioned residual has fallen by ``1e-11``; the result is what the
estimator gives at these probes, free of the program's iteration cap and
rounding.  In ``tf32`` precision (the control) it runs as the configuration
states (its iteration cap, float32's exit floor), in float32 with every
product's operands rounded to TF32.
"""

import math

import numpy as np
import torch

from .precision import dtype_of, operand

# pairs evaluated per chunk (bounds the reference's working memory)
_PAIR_CHUNK = 1 << 23
_TILE_CHUNK = 2048


def morton_order(x):
    """Stable permutation of x (n, d) along a Morton curve: each of the
    first min(d, 8) axes quantised to 16 bits over its range, the bits
    interleaved (axis 0 lowest), at most 64 bits in all."""
    x = np.asarray(x, dtype=np.float64)
    use = min(x.shape[1], 8)
    lo = x.min(axis=0)
    span = np.maximum(x.max(axis=0) - lo, 1e-300)
    q = ((x[:, :use] - lo[:use]) / span[:use] * 65535.0).astype(np.uint64)
    bits = min(16, 64 // use)
    code = np.zeros(len(x), dtype=np.uint64)
    for dim in range(use):
        v = q[:, dim]
        for bit in range(bits):
            code |= ((v >> np.uint64(bit)) & np.uint64(1)) \
                << np.uint64(bit * use + dim)
    return np.argsort(code, kind="stable")


def rademacher(n, p, call_index, dtype, device):
    g = torch.Generator().manual_seed(42 + int(call_index))
    bits = torch.randint(0, 2, (n, p), generator=g, dtype=torch.int8)
    return (2.0 * bits.to(dtype) - 1.0).to(device)


def wendland(d):
    d = torch.clamp(d, max=1.0)
    return (1.0 - d) ** 8 * (32.0 * d ** 3 + 25.0 * d ** 2 + 8.0 * d + 1.0)


class Gp2Scale:
    """One configuration's data in the reference's own layout, its
    structure, preconditioner and CG."""

    def __init__(self, config, data, device, precision="exact"):
        gp = config["gp"]
        args = gp["args"]
        self.precision = precision
        self.dtype = dtype_of(precision)
        self.device = device
        self.B = int(args["gp2Scale_block_size"])
        self.probes = int(args["random_logdet_fixed_probes"])
        if precision == "exact":
            self.iters, self.tol_sq = 20000, 1e-22
        else:
            self.iters, self.tol_sq = int(args["sparse_cg_maxiter"]), 1e-8
        x, y = np.asarray(data["x"], np.float64), np.asarray(data["y"])
        noise = np.asarray(data["noise"], np.float64)
        perm = morton_order(x)
        self.n, self.D = x.shape
        self.nb = -(-self.n // self.B)
        n_pad = self.nb * self.B
        f64 = dict(dtype=torch.float64, device=device)
        xs = np.zeros((n_pad, self.D))
        xs[:self.n] = x[perm]
        self.x = torch.as_tensor(xs, **f64)
        mask = np.zeros(n_pad)
        mask[:self.n] = 1.0
        self.mask = torch.as_tensor(mask, **f64)
        ys = np.zeros(n_pad)
        ys[:self.n] = y[perm]
        ym = (ys - ys[:self.n].mean()) * mask
        self.ym = torch.as_tensor(ym, dtype=self.dtype, device=device)
        nz = np.ones(n_pad)
        nz[:self.n] = noise[perm]
        self.noise = torch.as_tensor(nz, **f64)
        self._pairs = None

    # -- structure -------------------------------------------------------
    def candidate_blocks(self, ls):
        """Block pairs (r, c) whose whitened bounding boxes lie within 1."""
        ls = torch.as_tensor(ls, dtype=torch.float64, device=self.device)
        xw = (self.x / ls).reshape(self.nb, self.B, self.D)
        valid = self.mask.reshape(self.nb, self.B, 1) > 0
        lo = torch.where(valid, xw, torch.full_like(xw, math.inf)).amin(1)
        hi = torch.where(valid, xw, torch.full_like(xw, -math.inf)).amax(1)
        rows, cols = [], []
        step = max(1, (1 << 24) // max(self.nb, 1))
        for r0 in range(0, self.nb, step):
            gap = torch.clamp(torch.maximum(lo[None] - hi[r0:r0 + step, None],
                                            lo[r0:r0 + step, None] - hi[None]),
                              min=0.0)
            r, c = torch.nonzero((gap ** 2).sum(-1) <= 1.0, as_tuple=True)
            rows.append(r + r0)
            cols.append(c)
        return torch.cat(rows), torch.cat(cols)

    def pairs(self, ls):
        """Point pairs (I, J), I-major sorted, whitened distance < 1 at
        lengthscales ``ls``; the diagonal included."""
        ls_t = torch.as_tensor(ls, dtype=torch.float64, device=self.device)
        br, bc = self.candidate_blocks(ls)
        xw = (self.x / ls_t).reshape(self.nb, self.B, self.D)
        mb = self.mask.reshape(self.nb, self.B) > 0
        Is, Js = [], []
        ar = torch.arange(self.B, device=self.device)
        for s in range(0, len(br), _TILE_CHUNK):
            r, c = br[s:s + _TILE_CHUNK], bc[s:s + _TILE_CHUNK]
            d2 = ((xw[r][:, :, None, :] - xw[c][:, None, :, :]) ** 2).sum(-1)
            keep = (d2 < 1.0) & mb[r][:, :, None] & mb[c][:, None, :]
            t, i, j = torch.nonzero(keep, as_tuple=True)
            Is.append(r[t] * self.B + ar[i])
            Js.append(c[t] * self.B + ar[j])
        I, J = torch.cat(Is), torch.cat(Js)
        order = torch.argsort(I * (self.nb * self.B) + J)
        return I[order], J[order]

    def live_tiles(self, h):
        """Tiles (block pairs) holding at least one nonzero of K at h."""
        I, J = self.pairs(np.asarray(h, np.float64)[1:])
        key = torch.unique((I // self.B) * self.nb + J // self.B)
        return int(key.numel())

    def _kvals(self, h, I, J):
        """K_IJ(h), float64, differentiable in h (zero gradient on the
        diagonal, where the distance is 0)."""
        out = []
        for s in range(0, len(I), _PAIR_CHUNK):
            i, j = I[s:s + _PAIR_CHUNK], J[s:s + _PAIR_CHUNK]
            diff = (self.x[i] - self.x[j]) / h[1:]
            d2 = (diff ** 2).sum(-1)
            off = d2 > 0
            d = torch.sqrt(torch.where(off, d2, torch.ones_like(d2)))
            out.append(h[0] * torch.where(off, wendland(d),
                                          torch.ones_like(d)))
        return torch.cat(out)

    def _structure(self, hs):
        """Pairs for every h in ``hs`` at once: a superset at the largest
        lengthscales, exact zeros beyond each h's support."""
        ls = np.max(np.asarray(hs, np.float64)[:, 1:], axis=0)
        if self._pairs is None or np.any(ls > self._pairs[0]):
            I, J = self.pairs(ls)
            n_pad = self.nb * self.B
            crow = torch.zeros(n_pad + 1, dtype=torch.int64,
                               device=self.device)
            crow[1:] = torch.cumsum(torch.bincount(I, minlength=n_pad), 0)
            self._pairs = (ls, I, J, crow)
        return self._pairs[1:]

    # -- estimator -------------------------------------------------------
    def _precond(self, h):
        """Block-Jacobi blocks of K+V on the storage blocks: the factor
        L_M and M⁻¹, in the reference's dtype."""
        hl = torch.as_tensor(h, dtype=torch.float64, device=self.device)
        xb = (self.x / hl[1:]).reshape(self.nb, self.B, self.D)
        mb = self.mask.reshape(self.nb, self.B)
        Ls, Minvs = [], []
        for s in range(0, self.nb, _TILE_CHUNK):
            xw = xb[s:s + _TILE_CHUNK]
            d = torch.cdist(xw, xw, compute_mode="donot_use_mm_for_euclid_dist")
            blk = hl[0] * wendland(d) * (mb[s:s + _TILE_CHUNK, :, None]
                                         * mb[s:s + _TILE_CHUNK, None, :])
            blk = blk + torch.diag_embed(
                self.noise.reshape(self.nb, self.B)[s:s + _TILE_CHUNK])
            blk = operand(blk.to(self.dtype), self.precision)
            L = torch.linalg.cholesky(blk)
            Ls.append(L)
            Minvs.append(torch.cholesky_inverse(L))
        return torch.cat(Ls), torch.cat(Minvs)

    def _block(self, mats, X):
        Xb = operand(X, self.precision).reshape(self.nb, self.B, -1)
        return torch.bmm(operand(mats, self.precision), Xb).reshape(
            self.nb * self.B, -1)

    def _pcg(self, A, noise, Minv, RHS):
        """Block-Jacobi PCG over every column, recording the coefficients;
        a column whose residual has collapsed is frozen (α = 1, β = 0),
        and the run ends once every column is below the exit floor."""
        def mv(D):
            return torch.sparse.mm(A, operand(D, self.precision)) \
                + noise[:, None] * D

        X = torch.zeros_like(RHS)
        R = RHS.clone()
        Zp = self._block(Minv, R)
        D = Zp
        rz = torch.sum(R * Zp, dim=0)
        floor = rz * (1e-28 if self.dtype == torch.float64 else 1e-10)
        exit_floor = rz * self.tol_sq
        one, zero = torch.ones((), dtype=RHS.dtype, device=RHS.device), \
            torch.zeros((), dtype=RHS.dtype, device=RHS.device)
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
        return X, torch.stack(alphas).double(), torch.stack(betas).double()


def _quadrature(alphas, betas, u2):
    """Mean over probes of ‖u‖² e₁ᵀ log(T) e₁, T the Lanczos tridiagonal
    of each probe's CG coefficients (T_ii = 1/α_i + β_{i-1}/α_{i-1},
    T_i,i+1 = √β_i / α_i)."""
    a, b = alphas.T, betas.T
    P = a.shape[0]
    prev = torch.cat([torch.zeros((P, 1), dtype=a.dtype, device=a.device),
                      b[:, :-1] / a[:, :-1]], dim=1)
    diag = 1.0 / a + prev
    off = torch.sqrt(torch.clamp(b[:, :-1], min=0.0)) / a[:, :-1]
    T = (torch.diag_embed(diag) + torch.diag_embed(off, offset=1)
         + torch.diag_embed(off, offset=-1))
    theta, Q = torch.linalg.eigh(T)
    theta = torch.clamp(theta, min=1e-30)
    vals = u2.double() * torch.sum(Q[:, 0, :] ** 2 * torch.log(theta), dim=1)
    return torch.mean(vals)
