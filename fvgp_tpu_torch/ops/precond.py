"""Batched preconditioners for the stored-operator Krylov solves
(counterpart of ``fvgp_tpu/ops/precond.py``).

Three operators, in increasing strength, each built from one batched
Cholesky and applied with one batched matmul:

* **block-Jacobi** — explicit inverses of the (nb, B, B) diagonal blocks.
* **overlapping additive Schwarz** (every IC/ILU-family alias) — exact
  factorizations of overlapping 2B×2B windows [[D_w, C_w], [C_wᵀ, D_{w+1}]]
  along the block tridiagonal: M⁻¹ = Σ_w R_wᵀ W_w⁻¹ R_w, symmetric PSD.
* **two-level** (``amg``) — the block-Jacobi smoother plus an additive
  coarse-grid correction P A_c⁻¹ Pᵀ with block-constant prolongation P and
  the Galerkin coarse matrix A_c = PᵀAP (one dense nb×nb Cholesky).

Every ``build_*_op`` returns ``(apply_fn, data)`` for the operator
convention of ``ops.krylov``: ``apply_fn(data, X)``.  Blocks that are not
positive definite go through a diagonal-shift retry ladder: shift, grow,
retry.
"""

import torch

from ..parallel.block_sparse import is_block_sparse

__all__ = ["build_block_jacobi", "build_block_jacobi_op",
           "block_jacobi_apply_factory", "build_preconditioner_op",
           "build_schwarz_op", "build_two_level_op", "normalize_type",
           "schwarz_apply_factory", "two_level_apply_factory"]


def _pad_rows(X, rows):
    """X (n, k) zero-padded to ``rows`` rows."""
    Xp = torch.zeros((rows, X.shape[1]), dtype=X.dtype, device=X.device)
    Xp[:X.shape[0]] = X
    return Xp


def _apply_block_jacobi(Minv, X, nb, p, n):
    """The batched explicit block inverse applied with one bmm."""
    k = X.shape[1]
    Xb = _pad_rows(X, nb * p).reshape(nb, p, k)
    return torch.bmm(Minv.to(X.dtype), Xb).reshape(nb * p, k)[:n]


def _invert_from_chol(L):
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    Linv = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    return torch.bmm(Linv.transpose(1, 2), Linv)


def _pad_identity(blocks, n, p):
    """Unit diagonal on the padded (all-zero) trailing rows, so the batched
    Cholesky stays positive definite."""
    nb = blocks.shape[0]
    if nb * p == n:
        return blocks
    pad = (torch.arange(nb * p, device=blocks.device) >= n).reshape(nb, p)
    blocks = blocks.clone()
    d = torch.diagonal(blocks, dim1=1, dim2=2)
    d.copy_(torch.where(pad, torch.ones((), dtype=d.dtype, device=d.device),
                        d))
    return blocks


def block_jacobi_apply_factory(nb, p, n):
    """``apply(Minv, X)`` for the block inverses of an (nb, p) grid over n
    rows."""
    def apply(Minv, X):
        return _apply_block_jacobi(Minv, X, nb, p, n)

    return apply


def build_block_jacobi_op(KV, args=None):
    """Operator-convention block-Jacobi: ``(apply_fn, Minv)``."""
    L, nb, p, n = _factor_blocks(KV, args)
    return block_jacobi_apply_factory(nb, p, n), _invert_from_chol(L)


def build_block_jacobi(KV, args=None):
    """M ≈ (K+V)⁻¹ as a callable X -> M X (closure convention).

    For a BlockSparseMatrix the blocks are its diagonal tiles; a dense
    matrix's diagonal is partitioned into
    ``args['sparse_preconditioner_block_size']`` (default 128) blocks.
    """
    fn, Minv = build_block_jacobi_op(KV, args)

    def apply(X):
        X = torch.as_tensor(X, device=Minv.device)
        if X.dim() == 1:
            return fn(Minv, X[:, None])[:, 0]
        return fn(Minv, X)

    return apply


# ---------------------------------------------------------------------------
# overlapping additive Schwarz
# ---------------------------------------------------------------------------

def _window_index(nb, p, device):
    return (torch.arange(nb, device=device)[:, None] * p
            + torch.arange(2 * p, device=device)[None, :])


def _apply_schwarz(Winv, X, nb, p, n):
    """M⁻¹X = Σ_w R_wᵀ W_w⁻¹ R_w X over windows of rows [w·p, w·p+2p): one
    batched bmm, then the overlap is added as the even and the odd windows
    in turn (each set is disjoint, so the sum has one order)."""
    k = X.shape[1]
    Xp = _pad_rows(X, nb * p + p)
    idx = _window_index(nb, p, X.device)
    Zw = torch.bmm(Winv.to(X.dtype), Xp[idx])               # (nb, 2p, k)
    out = torch.zeros_like(Xp)
    for parity in (0, 1):
        sel = idx[parity::2].reshape(-1)
        out[sel] += Zw[parity::2].reshape(-1, k)
    return out[:n]


def _window_blocks(KV, args=None):
    """(nb, 2p, 2p) overlapping windows along the block tridiagonal."""
    args = args or {}
    if is_block_sparse(KV):
        D = KV.diagonal_tiles()
        C = KV.off_diagonal_tiles(1).to(D.dtype)
        n, p, nb = KV.n, KV.block_size, D.shape[0]
        W = torch.zeros((nb, 2 * p, 2 * p), dtype=D.dtype, device=D.device)
        W[:, :p, :p] = D
        W[:, :p, p:] = C
        W[:, p:, :p] = C.transpose(1, 2)
        W[:-1, p:, p:] = D[1:]
    else:
        n = KV.shape[0]
        p = min(int(args.get("sparse_preconditioner_block_size", 128)), n)
        nb = -(-n // p)
        n_pad = nb * p
        KVp = torch.zeros((n_pad + p, n_pad + p), dtype=KV.dtype,
                          device=KV.device)
        KVp[:n, :n] = KV
        idx = _window_index(nb, p, KV.device)
        W = KVp[idx[:, :, None], idx[:, None, :]]
    # padded and overhanging rows become decoupled unit rows, so the window
    # factorization stays exact and positive definite
    pad = _window_index(nb, p, W.device) >= n
    W = torch.where(pad[:, :, None] | pad[:, None, :], torch.zeros_like(W),
                    W)
    d = torch.diagonal(W, dim1=1, dim2=2)
    d.copy_(torch.where(pad, torch.ones((), dtype=d.dtype, device=d.device),
                        d))
    return W, nb, p, n


def schwarz_apply_factory(nb, p, n):
    """``apply(Winv, X)`` for the window inverses of an (nb, 2p) overlapping
    grid over n rows."""
    def apply(Winv, X):
        return _apply_schwarz(Winv, X, nb, p, n)

    return apply


def build_schwarz_op(KV, args=None):
    """Operator-convention overlapping additive Schwarz."""
    args = args or {}
    W, nb, p, n = _window_blocks(KV, args)
    L = _shifted_cholesky(W, args)
    return schwarz_apply_factory(nb, p, n), _invert_from_chol(L)


# ---------------------------------------------------------------------------
# two-level: block-Jacobi smoother + coarse-grid correction
# ---------------------------------------------------------------------------

def _apply_two_level(data, X, nb, p, n):
    Minv, Lc = data
    z = _apply_block_jacobi(Minv, X, nb, p, n)
    k = X.shape[1]
    r_c = torch.sum(_pad_rows(X, nb * p).reshape(nb, p, k), dim=1)   # Pᵀ X
    y_c = torch.cholesky_solve(r_c, Lc.to(X.dtype))                  # A_c⁻¹
    corr = y_c[:, None, :].expand(nb, p, k).reshape(nb * p, k)
    return z + corr[:n]


def two_level_apply_factory(nb, p, n):
    """``apply((Minv, Lc), X)``: the block-Jacobi smoother of an (nb, p)
    grid over n rows plus the coarse correction of the Cholesky factor
    ``Lc``."""
    def apply(data, X):
        return _apply_two_level(data, X, nb, p, n)

    return apply


def build_two_level_op(KV, args=None):
    """Operator-convention two-level preconditioner."""
    args = args or {}
    L, nb, p, n, Ac = _factor_blocks(KV, args, want_coarse=True)
    Minv = _invert_from_chol(L)
    # a padded trailing block may leave a deficient coarse row; the shift
    # ladder covers it along with any near-singular aggregate
    Lc = _shifted_cholesky(Ac[None], args)[0]
    return two_level_apply_factory(nb, p, n), (Minv, Lc)


_SCHWARZ_ALIASES = frozenset((
    "schwarz", "additive_schwarz", "ic", "ichol", "ichol0",
    "incomplete_cholesky", "native_ic", "native_ichol",
    "native_incomplete_cholesky", "legacy_ic", "legacy_ichol",
    "legacy_incomplete_cholesky", "ilu"))


def normalize_type(name):
    """Canonical preconditioner name: every IC/ILU-family name ->
    'schwarz', AMG names -> 'amg', jacobi names -> 'block_jacobi'.  Unknown
    names raise: a typo must not hand back block-Jacobi where the user
    chose otherwise."""
    n = str(name).lower()
    if n in _SCHWARZ_ALIASES:
        return "schwarz"
    if "amg" in n:
        return "amg"
    if n in ("block_jacobi", "jacobi", "bj", "diag", "diagonal"):
        return "block_jacobi"
    raise Exception(f"Unknown sparse preconditioner type: {name!r}. "
                    f"Known: block_jacobi, schwarz (+ IC/ILU aliases), amg.")


def build_preconditioner_op(KV, args=None):
    """Dispatch on ``args['sparse_preconditioner_type']``: block-Jacobi
    (default), overlapping Schwarz (every IC/ILU-family alias), or
    two-level ('amg').  Unknown names raise."""
    args = args or {}
    ptype = normalize_type(args.get("sparse_preconditioner_type",
                                    "block_jacobi"))
    if ptype == "schwarz":
        return build_schwarz_op(KV, args)
    if ptype == "amg":
        return build_two_level_op(KV, args)
    return build_block_jacobi_op(KV, args)


def _shifted_cholesky(blocks, args):
    """Batched Cholesky with a diagonal-shift retry ladder; a failed
    factorization is read from ``cholesky_ex``'s info."""
    args = args or {}
    shift0 = float(args.get("sparse_preconditioner_shift", 0.0))
    growth = float(args.get("sparse_preconditioner_shift_growth", 10.0))
    attempts = int(args.get("sparse_preconditioner_shift_attempts", 5))
    eye = torch.eye(blocks.shape[-1], dtype=blocks.dtype,
                    device=blocks.device)
    shift = shift0
    for _ in range(max(attempts, 1)):
        L, info = torch.linalg.cholesky_ex(blocks + shift * eye[None])
        if not bool(info.any()) and bool(torch.isfinite(L).all()):
            return L
        shift = max(shift, 1e-12 * float(blocks.abs().max())) * growth
    raise RuntimeError("preconditioner setup failed: non-PD blocks after "
                       "shift retries")


def _factor_blocks(KV, args=None, want_coarse=False):
    """(L, nb, p, n[, Ac]): the batched Cholesky of the diagonal blocks.
    ``want_coarse=True`` also returns the coarse aggregate matrix
    ``Ac[i, j] = sum of KV block (i, j)``, from the same padded copy the
    dense path builds."""
    args = args or {}
    Ac = None
    if is_block_sparse(KV):
        blocks = KV.diagonal_tiles()
        n = KV.n
        p = KV.block_size
        if want_coarse:
            Ac = KV.coarse_matrix().to(blocks.dtype)
    else:
        n = KV.shape[0]
        p = min(int(args.get("sparse_preconditioner_block_size", 128)), n)
        nb = -(-n // p)
        n_pad = nb * p
        KVp = torch.zeros((n_pad, n_pad), dtype=KV.dtype, device=KV.device)
        KVp[:n, :n] = KV
        K4 = KVp.reshape(nb, p, nb, p)
        i = torch.arange(nb, device=KV.device)
        blocks = K4[i, :, i, :]
        if want_coarse:
            Ac = torch.sum(K4, dim=(1, 3))
    nb = blocks.shape[0]
    blocks = _pad_identity(blocks, n, p)
    L = _shifted_cholesky(blocks, args)
    if want_coarse:
        return L, nb, p, n, Ac
    return L, nb, p, n
