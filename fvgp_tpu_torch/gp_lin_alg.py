"""Reference-name linear-algebra layer (counterpart of
``fvgp_tpu/gp_lin_alg.py``).

fvGP exposes its numerics as free functions (``calculate_Chol_factor``,
``calculate_sparse_conj_grad``, ``calculate_random_logdet``, ...) that power
users import directly.  This module has the same names, call signatures and
numpy in/out conventions, and delegates to the port's ``ops/dense``,
``ops/krylov``, ``ops/slq``, ``ops/precond`` and
``parallel/block_sparse``; the stored operator's product is the K1 kernel on
the card.

Conventions:

* outputs are numpy; 1-d right-hand sides are accepted everywhere and come
  back 2-d ``(n, 1)`` from the solve family;
* ``compute_device`` is honoured, and defaults to the card as ``GP``'s does
  (the JAX package accepts and ignores it): ``"cuda"`` / ``"gpu"`` or
  ``"cpu"``;
* functions without ``compute_device`` run on the operator's device where it
  has one (a torch tensor or a ``BlockSparseMatrix``) and on the card
  otherwise (numpy arrays, scipy matrices);
* ``args`` honours the reference's key families (``sparse_cg_*``,
  ``sparse_minres_*``, ``random_logdet_*``, ``sparse_preconditioner_type``).

The sparse *direct* family (``calculate_sparse_LU_*``,
``calculate_sparse_solve``) is served, as in the JAX package, by a dense
Cholesky below ``args['sparse_direct_dense_cutoff']`` and by tightly
converged preconditioned CG above it.
"""

import numpy as np
import torch
from scipy import sparse as _sp

from . import config
from .ops import dense as _dense
from .ops import krylov as _krylov
from .ops import slq as _slq
from .ops.dense import NonPositiveDefiniteError  # noqa: F401
from .ops.precond import build_preconditioner_op, normalize_type
from .parallel.block_sparse import (BlockSparseMatrix, bsm_matvec_factory,
                                    from_scipy, is_block_sparse)

__all__ = [
    "NonPositiveDefiniteError",
    "calculate_Chol_factor", "update_Chol_factor", "calculate_Chol_solve",
    "calculate_Chol_logdet", "cholesky_update_rank_n",
    "cholesky_update_rank_1", "cholesky_update_rank_1_numpy",
    "cholesky_update_rank_1_torch", "cholesky_update_rank_1_cupy",
    "calculate_inv_from_chol", "calculate_logdet", "update_logdet",
    "calculate_inv", "update_inv", "solve", "matmul", "matmul3",
    "is_sparse", "how_sparse_is",
    "calculate_sparse_conj_grad", "calculate_sparse_minres",
    "calculate_sparse_solve", "calculate_random_logdet",
    "calculate_sparse_preconditioner", "normalize_sparse_preconditioner_type",
    "calculate_sparse_LU_factor", "calculate_LU_solve", "calculate_LU_logdet",
    "get_gpu_engine", "gpu_engine_unavailable_reason", "spai",
    "sparse_preconditioner_failure_guidance", "resolve_gp2scale_linalg_mode",
]


def _np(x):
    return config.to_numpy(x) if torch.is_tensor(x) else np.asarray(x)


def _device_of(A):
    """The operator's device, or the card for a host (numpy/scipy)
    operand."""
    if torch.is_tensor(A) or is_block_sparse(A):
        return A.device
    return config.resolve_device("cuda")


def _t(A, device):
    """``A`` as a floating tensor on ``device`` (float64 from the host)."""
    if torch.is_tensor(A):
        return A.to(device)
    return torch.as_tensor(np.asarray(A, dtype=np.float64)).to(device)


def _rhs_2d(vec, device):
    vec = _t(vec, device)
    return vec.reshape(len(vec), 1) if vec.dim() == 1 else vec


# ---------------------------------------------------------------------------
# dense Cholesky family
# ---------------------------------------------------------------------------

def calculate_Chol_factor(M, compute_device="cuda", args=None):
    """Lower-triangular Cholesky factor of the SPD matrix ``M``."""
    dev = config.resolve_device(compute_device)
    return _np(_dense.cholesky_factor(_t(M, dev)))


def update_Chol_factor(old_chol_factor, new_matrix, compute_device="cuda",
                       args=None):
    """Extend a factor to cover appended rows and columns (one blocked
    update)."""
    dev = config.resolve_device(compute_device)
    return _np(_dense.update_chol_factor(_t(old_chol_factor, dev),
                                         _t(new_matrix, dev)))


def calculate_Chol_solve(factor, vec, compute_device="cuda", args=None):
    """Solve ``A x = vec`` from the Cholesky factor of A."""
    dev = config.resolve_device(compute_device)
    return _np(_dense.cholesky_solve(_t(factor, dev), _rhs_2d(vec, dev)))


def calculate_Chol_logdet(factor, compute_device="cuda", args=None):
    """log|A| = 2 Σ log diag(L)."""
    dev = config.resolve_device(compute_device)
    return float(_dense.cholesky_logdet(_t(factor, dev)))


def cholesky_update_rank_n(L, b, c, compute_device="cuda", args=None):
    """Extend ``L`` (factor of A) to the factor of ``[[A, b], [bᵀ, c]]``
    in one blocked update."""
    dev = config.resolve_device(compute_device)
    return _np(_dense._chol_append(_t(L, dev), _t(b, dev), _t(c, dev))[0])


def calculate_inv_from_chol(L, compute_device="cuda", args=None):
    """A⁻¹ from the Cholesky factor of A."""
    dev = config.resolve_device(compute_device)
    return _np(_dense.inv_from_chol(_t(L, dev)))


# ---------------------------------------------------------------------------
# dense general family
# ---------------------------------------------------------------------------

def calculate_logdet(A, compute_device="cuda", args=None):
    """log|A| via slogdet."""
    dev = config.resolve_device(compute_device)
    return float(_dense.calculate_logdet(_t(A, dev)))


def update_logdet(old_logdet, old_inv, new_matrix, compute_device="cuda",
                  args=None):
    """Appended-block log-determinant through the Schur complement."""
    dev = config.resolve_device(compute_device)
    return float(_dense.update_logdet(float(old_logdet), _t(old_inv, dev),
                                      _t(new_matrix, dev)))


def calculate_inv(A, compute_device="cuda", args=None):
    """Explicit inverse."""
    dev = config.resolve_device(compute_device)
    return _np(_dense.calculate_inv(_t(A, dev)))


def update_inv(old_inv, new_matrix, compute_device="cuda", args=None):
    """Appended-block inverse update."""
    dev = config.resolve_device(compute_device)
    return _np(_dense.update_inv(_t(old_inv, dev), _t(new_matrix, dev)))


def solve(A, b, compute_device="cuda", args=None):
    """General solve with a least-squares fallback for singular systems."""
    dev = config.resolve_device(compute_device)
    return _np(_dense.solve(_t(A, dev), _rhs_2d(b, dev)))


def matmul(A, B, compute_device="cuda", args=None):
    """A @ B; sparse operands stay sparse."""
    return A @ B


def matmul3(A, B, C, compute_device="cuda", args=None):
    """A @ B @ C."""
    return (A @ B) @ C


def is_sparse(A):
    """True when fewer than 1% of the entries are non-zero."""
    return how_sparse_is(A) < 0.01


def how_sparse_is(A):
    """Non-zero fraction of ``A``."""
    if _sp.issparse(A):
        return float(A.nnz) / float(A.shape[0] * A.shape[1])
    if is_block_sparse(A):
        return A.sparsity()
    if torch.is_tensor(A):
        return float(torch.count_nonzero(A)) / float(A.numel())
    A = np.asarray(A)
    return float(np.count_nonzero(A)) / float(A.shape[0] * A.shape[1])


# ---------------------------------------------------------------------------
# sparse family
# ---------------------------------------------------------------------------

def _as_operator(KV, args, device=None):
    """A scipy matrix tile-ified onto the ``gp2Scale_block_size`` grid, a
    ``BlockSparseMatrix`` or a dense tensor, on ``device`` (default: the
    operator's own, the card for a host operand)."""
    dev = _device_of(KV) if device is None else device
    if _sp.issparse(KV):
        block = int((args or {}).get("gp2Scale_block_size",
                                     min(256, KV.shape[0])))
        return from_scipy(KV.tocsr(), block, device=dev)
    if is_block_sparse(KV):
        if KV.device == dev:
            return KV
        return BlockSparseMatrix(KV.n, KV.n_cols, KV.block_size,
                                 KV.rows, KV.cols, KV.tiles.to(dev),
                                 diag=KV.diag, device=dev, mesh=KV.mesh)
    return _t(KV, dev)


def _sparse_operator(KV, args, device=None):
    """(matvec fn, operator data, n) in the solvers' operator convention."""
    A = _as_operator(KV, args, device)
    if is_block_sparse(A):
        return (bsm_matvec_factory(A.nb, A.block_size, A.n,
                                   A.diag is not None), A, A.shape[0])
    return _krylov.dense_matvec, A, A.shape[0]


def _precond_pair(M):
    """The ``M=`` slot: a ``calculate_sparse_preconditioner`` result, an
    (fn, data) pair, or a plain callable X -> M X."""
    if M is None:
        return None, None
    if isinstance(M, tuple) and len(M) == 2 and callable(M[0]) \
            and not callable(M[1]):
        return M
    if callable(M):
        return M, None
    raise Exception("Unrecognized preconditioner object for M=; pass the "
                    "result of calculate_sparse_preconditioner or a callable.")


def _operand_dtype(A):
    dt = A.dtype
    return torch.float32 if torch.finfo(dt).bits < 32 else dt


def calculate_sparse_conj_grad(KV, vec, x0=None, M=None, args=None):
    """CG solve of the sparse SPD system.  Honours ``sparse_cg_tol`` /
    ``sparse_cg_maxiter``."""
    args = args or {}
    fn, data, _ = _sparse_operator(KV, args)
    m_fn, m_data = _precond_pair(M)
    b = _rhs_2d(vec, data.device).to(_operand_dtype(data))
    x = _krylov.cg(fn, b,
                   x0=None if x0 is None else _rhs_2d(x0, data.device),
                   M=m_fn, m_operator=m_data,
                   tol=float(args.get("sparse_cg_tol",
                                      args.get("cg_minres_tol", 1e-8))),
                   maxiter=int(args.get(
                       "sparse_cg_maxiter",
                       args.get("sparse_krylov_maxiter", 10 * b.shape[0]))),
                   operator=data)
    return _np(x).reshape(b.shape)


def calculate_sparse_minres(KV, vec, x0=None, M=None, args=None):
    """MINRES solve of the sparse symmetric system.  Honours
    ``sparse_minres_tol`` / ``sparse_minres_maxiter``."""
    args = args or {}
    fn, data, _ = _sparse_operator(KV, args)
    m_fn, m_data = _precond_pair(M)
    b = _rhs_2d(vec, data.device).to(_operand_dtype(data))
    x = _krylov.minres(fn, b,
                       x0=None if x0 is None else _rhs_2d(x0, data.device),
                       M=m_fn, m_operator=m_data,
                       tol=float(args.get("sparse_minres_tol",
                                          args.get("cg_minres_tol", 1e-8))),
                       maxiter=int(args.get(
                           "sparse_minres_maxiter",
                           args.get("sparse_krylov_maxiter",
                                    10 * b.shape[0]))),
                       operator=data)
    return _np(x).reshape(b.shape)


def _dense_of(KV, device):
    if is_block_sparse(KV):
        return KV.to_dense().to(device)
    if _sp.issparse(KV):
        return _t(KV.toarray(), device)
    return _t(KV, device)


def calculate_sparse_solve(KV, vec, args=None):
    """Direct-solve semantics for a sparse system: a dense Cholesky below
    ``sparse_direct_dense_cutoff``, tight preconditioned CG above it."""
    args = args or {}
    cutoff = int(args.get("sparse_direct_dense_cutoff", 20000))
    dev = _device_of(KV)
    if KV.shape[0] <= cutoff:
        A = _dense_of(KV, dev)
        b = _rhs_2d(vec, dev).to(A.dtype)
        return _np(_dense.cholesky_solve(_dense.cholesky_factor(A), b))
    tight = dict(args)
    tight.setdefault("sparse_cg_tol", 1e-10)
    A = _as_operator(KV, tight)
    M = calculate_sparse_preconditioner(A, tight)[1]
    return calculate_sparse_conj_grad(A, vec, M=M, args=tight)


def calculate_sparse_LU_factor(KV, args=None):
    """Direct-factor semantics: the Cholesky factor of the densified
    matrix."""
    return _np(_dense.cholesky_factor(_dense_of(KV, _device_of(KV))))


def calculate_LU_solve(LU, vec, args=None):
    """Solve from the factor returned by ``calculate_sparse_LU_factor``."""
    dev = _device_of(LU)
    return _np(_dense.cholesky_solve(_t(LU, dev), _rhs_2d(vec, dev)))


def calculate_LU_logdet(LU, args=None):
    """log-determinant from the factor returned by
    ``calculate_sparse_LU_factor``."""
    return float(_dense.cholesky_logdet(_t(LU, _device_of(LU))))


def calculate_random_logdet(KV, compute_device="cuda", args=None,
                            info_out=None):
    """Stochastic Lanczos log-determinant with the reference's arg keys
    (``random_logdet_lanczos_degree``, ``random_logdet_error_rtol``,
    ``random_logdet_min/max_num_samples``) and its ``info_out`` contract
    (variance, num_samples_used, absolute / relative error)."""
    args = args or {}
    dev = config.resolve_device(compute_device)
    fn, data, n = _sparse_operator(KV, args, device=dev)
    raw = {}
    ld = float(_slq.slq_logdet(
        fn, n, dtype=config.linalg_dtype(args, dev), device=dev,
        operator=data,
        degree=int(args.get("random_logdet_lanczos_degree", 20)),
        min_num_samples=int(args.get("random_logdet_min_num_samples", 10)),
        max_num_samples=int(args.get("random_logdet_max_num_samples", 5000)),
        error_rtol=float(args.get("random_logdet_error_rtol", 0.01)),
        info_out=raw))
    if info_out is not None:
        var = raw.get("variance")
        info_out.update(raw)
        info_out["num_samples_used"] = raw.get("num_samples")
        info_out["absolute_error"] = (float(np.sqrt(var))
                                      if var is not None else None)
        info_out.setdefault("relative_error", None)
    return ld


def normalize_sparse_preconditioner_type(name):
    """Canonical preconditioner name: every IC/ILU-family name ->
    'schwarz' (overlapping additive Schwarz), AMG names -> 'amg'
    (two-level), jacobi names -> 'block_jacobi'; unknown names raise."""
    return normalize_type(name)


def calculate_sparse_preconditioner(KV, args=None):
    """Build the preconditioner selected by
    ``args['sparse_preconditioner_type']``.

    Returns ``(factor_data, operator)``; ``operator`` is an ``(apply_fn,
    data)`` pair ready for the ``M=`` argument of
    :func:`calculate_sparse_conj_grad` / :func:`calculate_sparse_minres`."""
    args = dict(args or {})
    args["sparse_preconditioner_type"] = normalize_sparse_preconditioner_type(
        args.get("sparse_preconditioner_type", "block_jacobi"))
    m_fn, m_data = build_preconditioner_op(_as_operator(KV, args), args=args)
    return m_data, (m_fn, m_data)


# ---------------------------------------------------------------------------
# remaining reference-name surface
# ---------------------------------------------------------------------------

def cholesky_update_rank_1(L, b, c, compute_device="cuda", args=None):
    """Extend ``L`` (factor of A) to the factor of ``[[A, b], [bᵀ, c]]`` for
    one new point: :func:`cholesky_update_rank_n` with a single column."""
    b = np.asarray(b, dtype=float).reshape(-1, 1)
    c = np.asarray(c, dtype=float).reshape(1, 1)
    return cholesky_update_rank_n(L, b, c, compute_device, args)


# fvGP splits this per GPU engine; here one torch path serves every device,
# so the engine-named variants are aliases kept for import compatibility
cholesky_update_rank_1_numpy = cholesky_update_rank_1
cholesky_update_rank_1_torch = cholesky_update_rank_1
cholesky_update_rank_1_cupy = cholesky_update_rank_1


def get_gpu_engine(args):
    """fvGP returns a torch/cupy module for its GPU branches; the port has no
    separate engine — every operation is torch on ``compute_device``.
    Returns ``None`` always."""
    return None


def gpu_engine_unavailable_reason(engine, args=None):
    """Why a requested GPU engine is not in play: the port has no
    per-engine branches."""
    return (f"GPU engine {engine!r} is not used by fvgp_tpu_torch: all linear "
            "algebra runs as torch on the device that compute_device names "
            "(the CUDA card by default, or the CPU); there are no separate "
            "torch/cupy engine branches. 'GPU_engine' args are accepted and "
            "ignored.")


def spai(A, m, args=None):
    """Sparse Approximate Inverse preconditioner, ``m`` refinement steps: a
    minimal-residual SPAI from ``M0 = 2 A / ||A Aᵀ||_1``, each step adding
    the optimally scaled residual direction

        ``M <- M + alpha G``,  ``G = I - A M``,
        ``alpha = tr(Gᵀ A G) / ||A G||_F^2``,

    which reduces ``||I - A M||_F`` monotonically for SPD ``A``.  A host
    scipy setup step."""
    from scipy.sparse.linalg import onenormest
    if not _sp.issparse(A):
        raise AssertionError("A must be sparse for SPAI")
    M = (2.0 / onenormest(A @ A.T)) * A
    eye = _sp.identity(A.shape[0], format="csr")
    for _ in range(max(int(m), 0)):
        G = eye - A @ M
        AG = A @ G
        denom = float(np.sum(AG.data ** 2))
        if denom == 0.0:
            break
        # tr(Gᵀ A G) is the Frobenius inner product <G, AG>
        alpha = float(G.multiply(AG).sum()) / denom
        M = M + alpha * G
    if not _sp.issparse(M):
        raise AssertionError("SPAI result must remain sparse")
    return M


def sparse_preconditioner_failure_guidance(args=None):
    """Actionable text for a failed preconditioner build, naming the
    operators that exist here."""
    raw = (args.get("sparse_preconditioner_type", "block_jacobi")
           if isinstance(args, dict) else args)
    try:
        ptype = normalize_sparse_preconditioner_type(raw)
    except Exception:
        ptype = str(raw)
    lines = [
        "A failed preconditioner build usually means the covariance is too "
        "dense for its block structure: check the compact-support kernel's "
        "length scales / support radius before tuning solver knobs.",
        "All preconditioners here are batched device operators "
        "(block-Jacobi, overlapping additive Schwarz behind every IC/ILU "
        "alias, two-level 'amg'); there is no optional package to install.",
    ]
    if ptype == "schwarz":
        lines.append("For Schwarz, the windows are exact 2B-size "
                     "factorizations: reduce 'gp2Scale_block_size' if the "
                     "batched Cholesky does not fit device memory.")
    elif ptype == "amg":
        lines.append("The two-level operator adds a tile-sum coarse solve "
                     "on top of block-Jacobi; if the coarse factor fails, "
                     "fall back to 'schwarz' or 'block_jacobi'.")
    else:
        lines.append("block-Jacobi always builds if the diagonal blocks are "
                     "positive definite; a failure there indicates a non-PD "
                     "K+V — grow the noise floor.")
    lines.append("The built operator is cached and reused until K+V drifts "
                 "past args['sparse_preconditioner_max_matrix_drift'] "
                 "(default 0.1).")
    return " ".join(lines)


def resolve_gp2scale_linalg_mode(mode, args=None):
    """``'sparseCGpre_amg'`` -> ``('sparseCGpre', args with the type)``:
    case-insensitive; an explicit ``args['sparse_preconditioner_type']``
    that conflicts with the mode's suffix raises ``ValueError``."""
    args = dict(args or {})
    if not isinstance(mode, str):
        return mode, args
    low = mode.lower()
    for prefix, canonical in (("sparsecgpre_", "sparseCGpre"),
                              ("sparseminrespre_", "sparseMINRESpre")):
        if not low.startswith(prefix):
            continue
        inferred = normalize_sparse_preconditioner_type(low[len(prefix):])
        explicit = args.get("sparse_preconditioner_type")
        if explicit is not None:
            explicit = normalize_sparse_preconditioner_type(explicit)
            if explicit != inferred:
                raise ValueError(
                    f"Conflicting sparse preconditioner specifications: "
                    f"mode {mode!r} implies {inferred!r}, but "
                    f"args['sparse_preconditioner_type'] is {explicit!r}.")
        args["sparse_preconditioner_type"] = inferred
        return canonical, args
    return mode, args
