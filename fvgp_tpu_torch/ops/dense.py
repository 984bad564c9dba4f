"""Dense linear algebra on torch tensors (counterpart of
``fvgp_tpu/ops/dense.py``): Cholesky factor, solve, log-determinant and
inverse, the general solve with its least-squares fallback, and the blocked
rank-n appends of the ``update_gp_data(append=True)`` path.

These are library calls (``torch.linalg``: cuSOLVER/cuBLAS on the card,
LAPACK on the CPU), as the JAX package left them to XLA.  The compute dtype
is whatever the caller hands in (``config.linalg_dtype`` decides upstream).
A failed Cholesky raises :class:`NonPositiveDefiniteError`; nothing shifts
the diagonal behind the caller's back.
"""

import numpy as np
import torch

__all__ = [
    "NonPositiveDefiniteError", "cholesky_factor", "cholesky_solve",
    "cholesky_logdet", "inv_from_chol", "calculate_inv", "calculate_logdet",
    "solve", "update_chol_factor", "update_inv", "update_logdet",
    "add_diagonal", "check_factor",
]


class NonPositiveDefiniteError(np.linalg.LinAlgError):
    """Raised when a Cholesky factorization meets a non-PD matrix."""


_NON_PD_GUIDANCE = (
    "Cholesky factorization failed: K + V is not positive definite. "
    "Common causes and remedies: (1) duplicate or near-duplicate data points "
    "-> add measurement noise / jitter; (2) hyperparameters at extreme values "
    "-> tighten the training bounds; (3) a user kernel that is not positive "
    "semi-definite -> verify the kernel; (4) too little noise -> increase "
    "noise_variances or use a noise function."
)


def check_factor(L, info=None):
    """Raise :class:`NonPositiveDefiniteError` when a factorization failed:
    ``info`` (from ``torch.linalg.cholesky_ex``) is non-zero, or the factor's
    diagonal is not finite.  One scalar transfer."""
    ok = torch.all(torch.isfinite(torch.diagonal(L, dim1=-2, dim2=-1)))
    if info is not None:
        ok = ok & torch.all(info == 0)
    if not bool(ok):
        raise NonPositiveDefiniteError(_NON_PD_GUIDANCE)
    return L


def cholesky_factor(KV, check=True):
    """Lower-triangular Cholesky factor of KV."""
    L, info = torch.linalg.cholesky_ex(KV)
    if check:
        check_factor(L, info)
    return L


def cholesky_solve(L, b):
    """Solve (L Lᵀ) x = b given the lower factor."""
    squeeze = b.dim() == 1
    if squeeze:
        b = b[:, None]
    x = torch.cholesky_solve(b, L)
    return x[:, 0] if squeeze else x


def cholesky_logdet(L):
    """log|KV| = 2 Σ log diag(L)."""
    return 2.0 * torch.sum(torch.log(torch.abs(torch.diagonal(L))))


def inv_from_chol(L):
    """Explicit inverse (L Lᵀ)⁻¹ from a Cholesky factor."""
    return torch.cholesky_inverse(L)


def calculate_inv(A):
    """Explicit inverse: through Cholesky (the SPD fast path), else LU."""
    L, info = torch.linalg.cholesky_ex(A)
    if int(info) == 0:
        return inv_from_chol(L)
    return torch.linalg.inv(A)


def calculate_logdet(A):
    """log|A| via slogdet."""
    return torch.linalg.slogdet(A)[1]


def solve(A, b):
    """General solve, with a least-squares fallback for singular systems."""
    x, info = torch.linalg.solve_ex(A, b)
    if int(info) == 0 and bool(torch.all(torch.isfinite(x))):
        return x
    return torch.linalg.lstsq(A, b).solution


def add_diagonal(K, v):
    """K + diag(v) as a new matrix (autograd-safe: K is left untouched)."""
    out = K.clone()
    out.diagonal().add_(v)
    return out


# ---------------------------------------------------------------------------
# blocked rank-n updates (append path)
# ---------------------------------------------------------------------------

def _chol_append(L11, B, C):
    """Extend the factor of A to the factor of [[A, B], [Bᵀ, C]]:
    L21 = (L11⁻¹ B)ᵀ, L22 = chol(C − L21 L21ᵀ) — two triangular solves and
    a small Cholesky.  Returns (factor, info of the new block)."""
    S = torch.linalg.solve_triangular(L11, B, upper=False)
    L21 = S.T
    L22, info = torch.linalg.cholesky_ex(C - L21 @ L21.T)
    n_old, n_new = B.shape
    top = torch.cat([L11, torch.zeros((n_old, n_new), dtype=L11.dtype,
                                      device=L11.device)], dim=1)
    bot = torch.cat([L21, L22], dim=1)
    return torch.cat([top, bot], dim=0), info


def update_chol_factor(old_factor, new_matrix):
    """Rank-n update of a Cholesky factor after appending data."""
    n_old = old_factor.shape[0]
    L, info = _chol_append(old_factor, new_matrix[:n_old, n_old:],
                           new_matrix[n_old:, n_old:])
    return check_factor(L, info)


def _inv_append(Ainv, B, C):
    """Block inverse of [[A, B], [Bᵀ, C]] given A⁻¹ (Schur complement)."""
    AinvB = Ainv @ B
    S = C - B.T @ AinvB
    Sl, info = torch.linalg.cholesky_ex(S)
    check_factor(Sl, info)
    Sinv = torch.cholesky_inverse(Sl)
    top_left = Ainv + AinvB @ Sinv @ AinvB.T
    top_right = -AinvB @ Sinv
    top = torch.cat([top_left, top_right], dim=1)
    bot = torch.cat([top_right.T, Sinv], dim=1)
    return torch.cat([top, bot], dim=0)


def update_inv(old_inv, new_matrix):
    """Extend an explicit inverse after appending data."""
    n_old = old_inv.shape[0]
    return _inv_append(old_inv, new_matrix[:n_old, n_old:],
                       new_matrix[n_old:, n_old:])


def update_logdet(old_logdet, old_inv, new_matrix):
    """log|[[A, B], [Bᵀ, C]]| = log|A| + log|C − Bᵀ A⁻¹ B|."""
    n_old = old_inv.shape[0]
    B = new_matrix[:n_old, n_old:]
    C = new_matrix[n_old:, n_old:]
    return old_logdet + calculate_logdet(C - B.T @ (old_inv @ B))
