"""Linear-algebra state (counterpart of ``fvgp_tpu/models/gp_kv.py``).

Owns the K+V factorization state and the reuse policy.  Modes:

* ``Chol`` / ``CholInv`` / ``Inv`` — dense factorizations through
  ``ops/dense`` (``torch.linalg``).  An append extends the factor or inverse
  by a blocked rank-n update unless the old-data block itself moved.
* ``sparseCG`` / ``sparseMINRES`` / ``sparseCGpre`` / ``sparseMINRESpre`` —
  matrix-free Krylov (``ops/krylov``) over a dense or block-sparse matvec
  (the stored ``BlockSparseMatrix`` product runs on the K1 kernel on the
  card), the log-determinant by stochastic Lanczos quadrature
  (``ops/slq``), preconditioners from ``ops/precond``
  (``sparseCGpre_<type>`` picks one).
* ``sparseLU`` / ``sparseSolve`` — direct semantics: below
  ``args['sparse_direct_dense_cutoff']`` (default 20000) they densify and
  use the exact Cholesky; above it, tight-tolerance preconditioned CG and
  an SLQ logdet.
* a custom ``[factor, solve, logdet]`` of callables: ``factor(KV)`` gives
  an object, ``solve(obj, b)`` the solution and ``logdet(obj)`` log|K+V|.
  ``KV`` and ``b`` are torch tensors on the model's device (a
  ``BlockSparseMatrix`` under gp2Scale); a solution may come back as a
  tensor or a numpy array.  A custom mode serves the LML value, the
  posterior and appends; its LML gradient is the formula gradient
  (``GPMarginalLikelihood._formula_gradient``).

Under gp2Scale everything is lazy: the stored K+V materializes on first
access, and committed solves go through the committed-state fast solver
(tiles assembled at the committed hyperparameters, the wide preconditioned
CG of ``ops/sparse_lml.make_committed_solver`` on the K2 kernel) wherever
that applies, without touching the stored K+V.  The O(nnz) matrix
fingerprint (trace + Frobenius norm) and the drift-based invalidation of
cached preconditioners and warm starts follow the JAX package, as does the
``sequential_linalg_state`` gate that restricts the reuse to MCMC.

Structured noise (``scipy.sparse`` or a ``BlockSparseMatrix`` from a noise
callable) is folded into K+V by ``addKV``: densified on a dense K, tiled
onto K's block grid (``from_scipy``, on K's device) and merged with K's tiles
on a block-sparse K.  The committed fast solver serves per-point (diagonal)
noise only; structured or matrix noise takes the stored K+V.
"""

import contextlib
import warnings

import numpy as np
import torch

from .. import config
from ..ops import dense as dops
from ..ops import krylov, slq
from ..ops.precond import build_preconditioner_op
from ..parallel.block_sparse import _dense_dtype, is_block_sparse
from ..parallel.mesh import all_agree, gather_rows
from ..utils.trace import span

# ---------------------------------------------------------------------------
# sequential-state gate
# ---------------------------------------------------------------------------
_SEQUENTIAL_STATE_DEFAULTS = {
    "sparse_krylov_warm_start": False,
    "sparse_preconditioner_refresh_interval": 1,
}
_SEQUENTIAL_STATE_METHODS = {"mcmc"}


@contextlib.contextmanager
def sequential_linalg_state(args, method):
    """Allow Krylov warm starts and preconditioner reuse only for
    ``method='mcmc'`` — the one training method whose successive
    evaluations are close enough for carried linalg state to be sound."""
    if not isinstance(args, dict) or method in _SEQUENTIAL_STATE_METHODS:
        yield
        return
    overridden = {k: args[k] for k, safe in _SEQUENTIAL_STATE_DEFAULTS.items()
                  if k in args and args[k] != safe}
    if overridden:
        warnings.warn(
            f"method={method!r} disables sequential linear-algebra state for "
            f"the duration of the run: {overridden}. Warm starts and "
            f"preconditioner reuse assume successive evaluations are close, "
            f"which holds for 'mcmc' but not for non-local methods. Settings "
            f"restored afterwards.")
    saved = {k: args[k] for k in _SEQUENTIAL_STATE_DEFAULTS if k in args}
    try:
        args.update(_SEQUENTIAL_STATE_DEFAULTS)
        yield
    finally:
        for k in _SEQUENTIAL_STATE_DEFAULTS:
            if k in saved:
                args[k] = saved[k]
            else:
                args.pop(k, None)


_FAST_MODES = {"sparseCG", "sparseCGpre", "sparseMINRES", "sparseMINRESpre",
               "sparseLU", "sparseSolve"}
_DENSE_MODES = {"Chol", "CholInv", "Inv"}
_ALLOWED_MODES = ["Chol", "CholInv", "Inv", "sparseMINRES", "sparseCG",
                  "sparseLU", "sparseMINRESpre", "sparseCGpre",
                  "sparseMINRESpre_<type>", "sparseCGpre_<type>",
                  "sparseSolve"]
_PRECOND_TYPES = ("block_jacobi", "ilu", "ichol", "ic", "incomplete_cholesky",
                  "ichol0", "native_ic", "native_ichol", "legacy_ic",
                  "legacy_ichol", "legacy_incomplete_cholesky", "schwarz",
                  "additive_schwarz", "amg", "native_incomplete_cholesky")
_PRECONDITIONED_MODES = {"sparseMINRESpre", "sparseCGpre"}


def resolve_linalg_mode(mode, args):
    """``sparseCGpre_amg`` → mode ``sparseCGpre`` with
    ``args['sparse_preconditioner_type'] = 'amg'`` (in a copy of args); a
    custom ``[factor, solve, logdet]`` mode and its args pass unchanged."""
    if not isinstance(mode, str):
        return mode, args
    for base in ("sparseCGpre", "sparseMINRESpre"):
        prefix = base + "_"
        if mode.startswith(prefix):
            ptype = mode[len(prefix):]
            if ptype not in _PRECOND_TYPES:
                raise Exception(f"Unknown preconditioner type alias: {ptype}")
            args = dict(args or {})
            args["sparse_preconditioner_type"] = ptype
            return base, args
    return mode, args


class GPkv:
    def __init__(self, data, prior, likelihood, linalg_mode=None):
        self.data = data
        self.prior = prior
        self.likelihood = likelihood
        if isinstance(linalg_mode, str):
            linalg_mode, self.data.args = resolve_linalg_mode(linalg_mode,
                                                              self.data.args)
            if linalg_mode not in _DENSE_MODES | _FAST_MODES:
                raise Exception(f"No Mode. Choose from: {_ALLOWED_MODES}")
        elif linalg_mode is not None and not callable(linalg_mode[0]):
            raise Exception(f"No Mode. Choose from: {_ALLOWED_MODES}")
        self.linalg_mode = linalg_mode
        self.last_solve_info = None
        self.last_logdet_variance = None
        self.last_logdet_info = {}
        self.Warm_start_fingerprint = None
        self._fast_solver_ctx = None
        self._KV = None
        self._KV_dirty = False
        self.KVinv = None
        self.Chol_factor = None
        self.custom_obj = None
        self._KVinvY = None
        self._logdet_KV = None
        self._x0_hint = None
        self._m_vec = None
        self._reset_sparse_preconditioner()
        # under gp2Scale the mode is resolved lazily, with the structure
        self.mode = None if data.gp2Scale else (linalg_mode or "Chol")
        self._refresh(rank_n_update=False)

    # ------------------------------------------------------------------
    # lazy KV materialization (gp2Scale): the traced sparse LML and the
    # committed fast solver assemble their own tiles, so the stored K / K+V
    # pair is built only when a consumer (a stored-operator solve, the
    # logdet, a fingerprint) touches it
    # ------------------------------------------------------------------
    @property
    def KV(self):
        if self._KV is None and self._KV_dirty:
            self._KV_dirty = False
            kv_mat = self.addKV(self.prior.K, self.likelihood.V)
            self._m_vec = self.prior.m
            if self.mode is None:
                self.mode = self._resolved_mode(kv_mat)
            self.set_KV(kv_mat)
        return self._KV

    @KV.setter
    def KV(self, value):
        self._KV = value

    @property
    def args(self):
        return self.data.args

    @property
    def x_data(self):
        return self.data.x_data

    @property
    def y_data(self):
        return self.data.y_data

    @property
    def K(self):
        return self.prior.K

    @property
    def m(self):
        return self.prior.m

    @property
    def V(self):
        return self.likelihood.V

    @property
    def gp2Scale(self):
        return self.data.gp2Scale

    @property
    def dtype(self):
        return config.linalg_dtype(self.args, self.data.device)

    def _operand(self, a):
        """A host input of a public method as a tensor on the model's
        device in its dtype (tensors and matrices pass as they are)."""
        return config.tensor_operand(a, self.data.device, self.dtype)

    @staticmethod
    def _is_custom(mode):
        return mode is not None and not isinstance(mode, str)

    def _custom_result(self, value):
        """A custom solve's result as a tensor on the model's device."""
        return torch.as_tensor(value).to(self.data.device, self.dtype)

    def _y_minus(self, m):
        y = torch.as_tensor(np.asarray(self.y_data, np.float64),
                            dtype=self.dtype).to(self.data.device)
        return y - m[:, None]

    # ------------------------------------------------------------------
    def _auto_mode(self, n, nnz):
        """Mode by N and sparsity (the JAX package's gp2Scale auto pick)."""
        sparsity = float(nnz) / float(n ** 2)
        if self.linalg_mode is not None:
            return self.linalg_mode
        if n < 50001 and sparsity < 1e-4:
            return "sparseLU"
        if n < 2001 and sparsity >= 1e-4:
            return "Chol"
        return "sparseCGpre"

    def _resolved_mode(self, KV):
        """The mode of a solve against ``KV``: the committed one, or under
        lazy gp2Scale the auto pick from KV's size and sparsity."""
        if not self.gp2Scale:
            return self.mode
        nnz = KV.nnz if is_block_sparse(KV) else KV.numel()
        return self._auto_mode(len(self.x_data), nnz)

    def _direct_dense_ok_n(self, n):
        return n <= int(self.args.get("sparse_direct_dense_cutoff", 20000))

    def _direct_dense_ok(self, KV):
        return self._direct_dense_ok_n(KV.shape[0])

    # ------------------------------------------------------------------
    # fingerprints + drift policy
    # ------------------------------------------------------------------
    @staticmethod
    def matrix_fingerprint(KV):
        """O(nnz) summary (shape, nnz, trace, fro) that detects a moved
        K+V; a host matrix gives the tuple of its tensor
        (``config.tensor_operand``)."""
        if KV is None:
            return None
        KV = config.tensor_operand(KV)
        if is_block_sparse(KV):
            trace, fro = KV.trace_and_fro()
            return (tuple(KV.shape), int(KV.nnz), float(trace), float(fro))
        return (tuple(KV.shape), int(KV.numel()), float(torch.trace(KV)),
                float(torch.linalg.norm(KV)))

    @staticmethod
    def _fingerprint_drift(old, new):
        if old is None or new is None:
            return np.inf
        if old[0] != new[0]:
            return np.inf
        drift = 0.0
        for ov, nv in ((old[2], new[2]), (old[3], new[3])):
            scale = max(abs(ov), abs(nv), 1e-300)
            drift = max(drift, abs(nv - ov) / scale)
        return drift

    def _matrix_drift(self, KV):
        return self._fingerprint_drift(self.Preconditioner_fingerprint,
                                       self.matrix_fingerprint(KV))

    def _max_matrix_drift(self):
        return float(self.args.get("sparse_preconditioner_max_matrix_drift",
                                   0.1))

    def _validated_warm_start(self, KV, x0):
        """Drop a warm start computed for a materially different K+V."""
        if x0 is None:
            return None
        if self.Warm_start_fingerprint is None:
            return x0
        if self._fingerprint_drift(
                self.Warm_start_fingerprint,
                self.matrix_fingerprint(KV)) > self._max_matrix_drift():
            return None
        return x0

    def _preconditioner_refresh_interval(self):
        value = self.args.get("sparse_preconditioner_refresh_interval", None)
        if value is None:
            return None
        return max(1, int(value))

    def _preconditioner_signature(self):
        relevant = {k: v for k, v in self.args.items()
                    if k.startswith("sparse_preconditioner_")}
        return tuple(sorted(relevant.items()))

    def _reset_sparse_preconditioner(self):
        self.Preconditioner_operator = None
        self.Preconditioner_signature = None
        self.Preconditioner_KV_shape = None
        self.Preconditioner_fingerprint = None
        self.Preconditioner_reuse_counter = 0
        self.Last_preconditioner_error = None

    def _can_reuse_sparse_preconditioner(self, KV, mode=None):
        if (mode or self.mode) not in _PRECONDITIONED_MODES:
            return False
        if self.Preconditioner_operator is None:
            return False
        if self.Preconditioner_KV_shape != tuple(KV.shape):
            return False
        if self.Preconditioner_signature != self._preconditioner_signature():
            return False
        interval = self._preconditioner_refresh_interval()
        if interval is not None \
                and self.Preconditioner_reuse_counter >= interval - 1:
            return False
        if self._matrix_drift(KV) > self._max_matrix_drift():
            return False
        return True

    def _get_or_refresh_preconditioner(self, KV, force_refresh=False,
                                       mode=None):
        """Cached or fresh preconditioner ``(apply_fn, data)`` for KV.
        ``mode`` is the RESOLVED mode of the current solve: under lazy
        gp2Scale the committed ``self.mode`` is still None on trial
        evaluations, and gating on it alone would run those solves
        unpreconditioned."""
        if (mode or self.mode) not in _PRECONDITIONED_MODES:
            return None
        if not force_refresh and self._can_reuse_sparse_preconditioner(
                KV, mode=mode):
            self.Preconditioner_reuse_counter += 1
            return self.Preconditioner_operator
        try:
            operator = build_preconditioner_op(KV, args=self.args)
        except RuntimeError as exc:
            # a factorization that fails after the shift ladder, or the
            # device out of memory; reset FIRST, the reset clears the error
            # slot and the recorded reason must survive for diagnostics
            self._reset_sparse_preconditioner()
            self.Last_preconditioner_error = f"{type(exc).__name__}: {exc}"
            warnings.warn(
                f"Failed to build preconditioner for mode "
                f"{mode or self.mode}; falling back to the unpreconditioned "
                f"iterative solve. Reason: {self.Last_preconditioner_error}.")
            return None
        self.Preconditioner_operator = operator
        self.Preconditioner_signature = self._preconditioner_signature()
        self.Preconditioner_KV_shape = tuple(KV.shape)
        self.Preconditioner_fingerprint = self.matrix_fingerprint(KV)
        self.Preconditioner_reuse_counter = 0
        self.Last_preconditioner_error = None
        return operator

    # ------------------------------------------------------------------
    # state transitions
    # ------------------------------------------------------------------
    def update_state_hyperparameters(self):
        self._refresh(rank_n_update=False)

    def update_state_data(self, append):
        self._refresh(rank_n_update=append)

    def _refresh(self, rank_n_update):
        self._fast_solver_ctx = None        # data/hyperparameters moved
        # the old solution survives as a warm-start hint for the next solve
        self._x0_hint = self._KVinvY if rank_n_update else None
        self._KVinvY = None
        self._logdet_KV = None
        if self.gp2Scale:
            # defer everything: KV materializes on first access, KVinvY and
            # the logdet on first use
            self._KV = None
            self._KV_dirty = True
            self._m_vec = None
            return
        from ..utils.logging import phase_timer
        KV = self.addKV(self.prior.K, self.likelihood.V)
        with phase_timer("fvgp.kv.factor"):
            if rank_n_update:
                self.update_KV(KV)
            else:
                self.set_KV(KV)
        self._m_vec = self.prior.m

    @property
    def KVinvY(self):
        """(K+V)⁻¹(y - m) at the committed state, shape (N, n_y)."""
        if self._KVinvY is None:
            if self._m_vec is None:
                self._m_vec = self.prior.m
            y_mean = self._y_minus(self._m_vec)
            # the weights serve every posterior mean of this state: below
            # float64 the committed solver refines them once past its CG's
            # exit floor
            self._KVinvY = self._solve(
                y_mean, x0=self._x0_hint,
                refine=int(self.dtype != torch.float64)).reshape(y_mean.shape)
            self._x0_hint = None
        return self._KVinvY

    @property
    def logdet_KV(self):
        if self._logdet_KV is None:
            self._logdet_KV = self.logdet()
        return self._logdet_KV

    # ------------------------------------------------------------------
    # factorizations
    # ------------------------------------------------------------------
    @staticmethod
    def _densify(KV):
        return KV.to_dense() if is_block_sparse(KV) else KV

    def set_KV(self, KV):
        """Full factorization refresh in the committed mode."""
        mode = self.mode
        self.Chol_factor = self.KVinv = None
        if self._is_custom(mode):
            self.custom_obj = mode[0](KV)
            self.KV = KV
        elif mode in _DENSE_MODES:
            KVd = self._densify(KV)
            self.KV = KVd
            if mode in ("Chol", "CholInv"):
                self.Chol_factor = dops.cholesky_factor(KVd)
            if mode == "CholInv":
                self.KVinv = dops.inv_from_chol(self.Chol_factor)
            if mode == "Inv":
                self.KVinv = dops.calculate_inv(KVd)
        elif mode in ("sparseCG", "sparseMINRES"):
            self.KV = KV
        elif mode in _PRECONDITIONED_MODES:
            self.KV = KV
            self._get_or_refresh_preconditioner(KV, force_refresh=True)
        elif mode in ("sparseLU", "sparseSolve"):
            # direct semantics: the exact Cholesky below the dense cutoff
            self.KV = KV
            if self._direct_dense_ok(KV):
                self.Chol_factor = dops.cholesky_factor(self._densify(KV))
        else:
            raise Exception(f"No Mode. Choose from: {_ALLOWED_MODES}")

    def _top_left_drifted(self, KV, n_old):
        """True when the appended matrix's old-data block no longer matches
        the stored KV the factor was computed from: the rank-n update
        assumes that block is unchanged, but e.g. the default noise
        ``(0.01·mean|y|)²`` moves with the new y mean, and extending the
        stale factor would corrupt logdet and solves."""
        old = self._KV
        if old is None or is_block_sparse(old) or old.shape[0] != n_old:
            return True
        diff = float(torch.max(torch.abs(KV[:n_old, :n_old] - old)))
        scale = float(torch.max(torch.abs(torch.diagonal(KV)[:n_old]))) \
            or 1.0
        return diff > 1e-12 * scale

    def update_KV(self, KV):
        """Rank-n update after an append: blocked trailing updates of the
        dense factor / explicit inverse, or a full refresh when the old-data
        block itself moved; the sparse modes swap the operator."""
        mode = self.mode
        if self._is_custom(mode):
            self.set_KV(KV)
        elif mode in ("Chol", "CholInv"):
            KVd = self._densify(KV)
            n_old = self.Chol_factor.shape[0]
            if KVd.shape[0] <= n_old or self._top_left_drifted(KVd, n_old):
                self.Chol_factor = dops.cholesky_factor(KVd)
            else:
                self.Chol_factor = dops.update_chol_factor(self.Chol_factor,
                                                           KVd)
            self.KV = KVd
            if mode == "CholInv":
                self.KVinv = dops.inv_from_chol(self.Chol_factor)
        elif mode == "Inv":
            KVd = self._densify(KV)
            n_old = self.KVinv.shape[0]
            if KVd.shape[0] <= n_old or self._top_left_drifted(KVd, n_old):
                self.KVinv = dops.calculate_inv(KVd)
            else:
                self.KVinv = dops.update_inv(self.KVinv, KVd)
            self.KV = KVd
        else:
            self.set_KV(KV)

    @staticmethod
    def addKV(K, V):
        """K + V for a dense or block-sparse K and a per-point vector, a
        dense matrix or a structured (``scipy.sparse`` / block-sparse) V.
        On a block-sparse K a structured V is tiled onto K's grid, on K's
        device, with K's dense tile dtype (``from_scipy``), and the two tile
        lists are merged; a float32 merge of bfloat16-stored K keeps the
        noise at float32 precision.  On a dense K it is densified.  Host
        arrays are taken as in the JAX package (``config.tensor_operand``):
        a host K goes to the default backend, the card where there is one,
        and V follows K's device and dtype."""
        from scipy.sparse import issparse
        K = config.tensor_operand(K)
        V = config.tensor_operand(V, K.device, K.dtype if torch.is_tensor(K)
                                  else _dense_dtype(K.tiles.dtype))
        if is_block_sparse(K):
            from ..parallel.block_sparse import from_scipy, merge
            if issparse(V):
                return merge(K, from_scipy(V, K.block_size, device=K.device,
                                           dtype=_dense_dtype(K.tiles.dtype)))
            if is_block_sparse(V):
                return merge(K, V)
            if not torch.is_tensor(V) or V.dim() != 1:
                raise AssertionError("K is block-sparse; expected a 1-d "
                                     "diagonal, scipy.sparse, or "
                                     "BlockSparseMatrix V")
            return K.add_diagonal(V)
        if K.dim() != 2 or K.shape[0] != K.shape[1]:
            raise AssertionError("K must be a square 2-d matrix")
        if issparse(V):
            V = config.tensor_operand(V.toarray(), like=K)
        elif is_block_sparse(V):
            V = V.to_dense().to(K.device, K.dtype)
        if V.dim() == 1:
            return dops.add_diagonal(K, V)
        if V.dim() == 2:
            return K + V
        raise Exception("K+V not possible with the given formats")

    # ------------------------------------------------------------------
    # solve / logdet against a given K+V
    # ------------------------------------------------------------------
    def _matvec_op(self, KV):
        """(matvec_fn, operator) of KV for the solvers' operator
        convention."""
        if is_block_sparse(KV):
            from ..parallel.block_sparse import bsm_matvec_factory
            return bsm_matvec_factory(KV.nb, KV.block_size, KV.n,
                                      KV.diag is not None), KV
        return krylov.dense_matvec, KV

    def _tols(self):
        cg_tol = float(self.args.get("sparse_cg_tol", 1e-5))
        mr_tol = float(self.args.get("sparse_minres_tol", 1e-5))
        maxiter = self.args.get("sparse_krylov_maxiter", None)
        cg_max = self.args.get("sparse_cg_maxiter", maxiter)
        mr_max = self.args.get("sparse_minres_maxiter", maxiter)
        return cg_tol, mr_tol, cg_max, mr_max

    def _cg_logged(self, *args, **kwargs):
        """CG with the iteration count recorded as ``last_solve_info`` —
        the measurable payoff of the warm-start and preconditioner-reuse
        policy."""
        x, info = krylov.cg(*args, with_info=True, **kwargs)
        self.last_solve_info = dict(
            info, method="cg", warm_start=kwargs.get("x0") is not None,
            preconditioned=kwargs.get("M") is not None)
        return x

    def _solve_with(self, mode, KV, b, x0=None, chol=None):
        cg_tol, mr_tol, cg_max, mr_max = self._tols()
        if mode in ("Chol", "CholInv"):
            L = chol if chol is not None \
                else dops.cholesky_factor(self._densify(KV))
            return dops.cholesky_solve(L, b)
        if mode == "Inv":
            return dops.calculate_inv(self._densify(KV)) @ b
        fn, data = self._matvec_op(KV)
        if mode in ("sparseLU", "sparseSolve"):
            if self._direct_dense_ok(KV):
                L = chol if chol is not None \
                    else dops.cholesky_factor(self._densify(KV))
                return dops.cholesky_solve(L, b)
            m_fn, m_data = build_preconditioner_op(KV, args=self.args)
            return self._cg_logged(fn, b, x0=x0, M=m_fn, tol=1e-10,
                                   operator=data, m_operator=m_data)
        if mode == "sparseCG":
            return self._cg_logged(fn, b, x0=x0, tol=cg_tol, maxiter=cg_max,
                                   operator=data)
        if mode == "sparseMINRES":
            return krylov.minres(fn, b, x0=x0, tol=mr_tol, maxiter=mr_max,
                                 operator=data)
        if mode in _PRECONDITIONED_MODES:
            M = self._get_or_refresh_preconditioner(KV, mode=mode)
            m_fn, m_data = M if M is not None else (None, None)
            if mode == "sparseCGpre":
                return self._cg_logged(fn, b, x0=x0, M=m_fn, tol=cg_tol,
                                       maxiter=cg_max, operator=data,
                                       m_operator=m_data)
            return krylov.minres(fn, b, x0=x0, M=m_fn, tol=mr_tol,
                                 maxiter=mr_max, operator=data,
                                 m_operator=m_data)
        raise Exception(f"No mode: {mode}")

    def _logdet_with(self, mode, KV, chol=None):
        if mode in ("Chol", "CholInv") or (
                mode in ("sparseLU", "sparseSolve")
                and self._direct_dense_ok(KV)):
            L = chol if chol is not None \
                else dops.cholesky_factor(self._densify(KV))
            return float(dops.cholesky_logdet(L))
        if mode == "Inv":
            return float(dops.calculate_logdet(self._densify(KV)))
        return self._random_logdet(KV)

    def _random_logdet(self, KV):
        """SLQ log-determinant; its variance is kept for
        ``log_likelihood_variance``."""
        info = {}
        fn, data = self._matvec_op(KV)
        # the probe batch of a block-sparse operator follows the JAX
        # package's rule (there a bound on the (T, B, k) product of the plain
        # SpMM, T its global tile count, padding included, on a mesh too),
        # so both packages draw the same number of probes
        batch = None
        if is_block_sparse(KV):
            T = KV.padded_tiles_global
            batch = max(4, min(32, (1 << 28) // max(T * KV.block_size * 4,
                                                    1)))
        args = self.args
        result = slq.slq_logdet(
            fn, KV.shape[0], dtype=self.dtype, device=self.data.device,
            operator=data, batch=batch,
            degree=int(args.get("random_logdet_lanczos_degree", 20)),
            min_num_samples=int(args.get("random_logdet_min_num_samples",
                                         10)),
            max_num_samples=int(args.get("random_logdet_max_num_samples",
                                         5000)),
            error_rtol=float(args.get("random_logdet_error_rtol", 0.01)),
            info_out=info)
        self.last_logdet_variance = info.get("variance", None)
        self.last_logdet_info = info
        return result

    # -- trial solves (nothing committed) ----------------------------------
    def _trial_chol(self, mode, KV):
        """The Cholesky factor that a trial's solve and logdet share, or
        None in the iterative modes."""
        if mode in ("Chol", "CholInv") or (
                mode in ("sparseLU", "sparseSolve")
                and self._direct_dense_ok(KV)):
            return dops.cholesky_factor(self._densify(KV))
        return None

    def compute_new_KVlogdet_KVinvY(self, K, V, m, x0=None):
        """``(KVinvY, log|K+V|)`` of a trial (K, V, m), nothing committed:
        one factorization serves both in the exact modes; the iterative
        modes (under gp2Scale the stored K's Krylov solve and SLQ
        log-determinant) and a custom ``[factor, solve, logdet]`` mode run
        as the trial LML runs them."""
        _, KVinvY, logdet, _ = self.trial_state(K, V, m, x0=x0)
        return KVinvY, logdet

    def compute_new_KVinvY(self, KV, m, x0=None):
        """KVinvY for a trial (KV, m) without committing state."""
        KV, m, x0 = map(self._operand, (KV, m, x0))
        x0 = self._validated_warm_start(KV, x0)
        self.Warm_start_fingerprint = self.matrix_fingerprint(KV)
        y_mean = self._y_minus(m)
        mode = self._resolved_mode(KV)
        if self._is_custom(mode):
            return self._custom_result(mode[1](mode[0](KV), y_mean)) \
                .reshape(y_mean.shape)
        return self._solve_with(mode, KV, y_mean, x0=x0).reshape(y_mean.shape)

    def trial_state(self, K, V, m, x0=None):
        """``(K+V, KVinvY, log|K+V|, Cholesky factor or None)`` of a trial,
        nothing committed: the solve and the logdet share one factorization
        (None in the iterative and custom modes), which the formula gradient
        then takes instead of factoring again."""
        K, V, m, x0 = map(self._operand, (K, V, m, x0))
        KV = self.addKV(K, V)
        x0 = self._validated_warm_start(KV, x0)
        self.Warm_start_fingerprint = self.matrix_fingerprint(KV)
        y_mean = self._y_minus(m)
        mode = self._resolved_mode(KV)
        if self._is_custom(mode):
            factor = mode[0](KV)
            return KV, self._custom_result(mode[1](factor, y_mean)) \
                .reshape(y_mean.shape), float(mode[2](factor)), None
        chol = self._trial_chol(mode, KV)
        KVinvY = self._solve_with(mode, KV, y_mean, x0=x0, chol=chol)
        return KV, KVinvY.reshape(y_mean.shape), \
            self._logdet_with(mode, KV, chol=chol), chol

    # ------------------------------------------------------------------
    # committed-state fast sparse solver (in-place tiles; no stored KV)
    # ------------------------------------------------------------------
    def _fast_sparse_solver(self):
        """Context for committed-state solves that assemble the covariance
        tiles at the committed hyperparameters, or None when that path does
        not apply (untraceable kernel, unpruned structure, or a mode it
        does not serve).

        The structure is ``data.tile_structure.exact`` at the committed
        lengthscales.  Under a mesh of more than one rank the solver is
        built like the training step: the schedule is partitioned by row
        ownership (``tile_structure.rank_partition``), each rank assembles
        its own tiles and preconditioner blocks, and the CG matvec gathers
        the iterate (all-gather, or the halo plan, as in training).  Every
        rank returns the whole solution."""
        if not (self.data.gp2Scale and self.data.Euclidean
                and self.prior.kernel_traceable) \
                or self._is_custom(self.linalg_mode):
            return None
        from ..parallel.mesh import current_mesh, tile_device_count
        from ..parallel.sharded_cov import _stable_kernel_closure
        from ..parallel.tile_structure import (halo_settings, padded_schedule,
                                               rank_partition, row_sorted)
        mesh = current_mesh()
        n_dev = tile_device_count(mesh) if mesh is not None else 1
        if n_dev <= 1:
            mesh, n_dev = None, 1
        hps = np.asarray(self.prior.hyperparameters, np.float64)
        args = self.args
        B = int(args.get("gp2Scale_block_size",
                         min(self.prior.batch_size, 256)))
        pwidth = max(1, int(args.get("gp2Scale_posterior_precond_width",
                                     args.get("gp2Scale_precond_width", 1))))
        # the posterior solve's preconditioner: block_jacobi or two_level
        # (amg); the training mBCG is block-diagonal by construction
        ptype = str(args.get("gp2Scale_posterior_precond", "block_jacobi"))
        coarse_w = args.get("gp2Scale_posterior_coarse_width", None)
        key = (self.data.point_number, self.data.generation, B, pwidth,
               ptype, coarse_w, hps.tobytes(), self.linalg_mode,
               args.get("gp2Scale_posterior_solver_dtype"),
               args.get("gp2Scale_solver_dtype"),
               args.get("gp2Scale_posterior_cg_tol"),
               args.get("sparse_cg_tol"), args.get("sparse_minres_tol"),
               args.get("gp2Scale_posterior_maxiter"),
               args.get("sparse_cg_maxiter",
                        args.get("sparse_krylov_maxiter")),
               args.get("sparse_minres_maxiter"),
               args.get("sparse_direct_dense_cutoff"),
               bool(args.get("gp2Scale_posterior_fused_spmm", True)),
               bool(args.get("gp2Scale_tile_filter", True)),
               args.get("gp2Scale_posterior_budget"),
               args.get("gp2Scale_posterior_col_budget"), args.get("dtype"),
               mesh) + halo_settings(args)
        ctx = self._fast_solver_ctx
        if ctx is not None and ctx["key"] == key:
            return ctx if ctx.get("fn") is not None else None

        # the noise diagonal on the host; a traceable noise callable's comes
        # back from the device once per cache miss.  Structured or matrix
        # noise has no diagonal to pad: the stored K+V serves it
        V = self.likelihood.calculate_V_host(self.x_data,
                                             self.prior.hyperparameters)
        if V is None:
            V_dev = self.likelihood.V
            if torch.is_tensor(V_dev) and V_dev.dim() == 1:
                V = config.to_numpy(V_dev)
            else:
                self._fast_solver_ctx = {"key": key, "fn": None}
                return None
        x = np.asarray(self.x_data, np.float64)
        n = len(x)
        ls, radius = self.data.tile_structure.support(self.prior, hps)
        if not np.isfinite(radius) and n > 4 * B:
            # unpruned structure: nb² candidate tiles — not a fast path
            self._fast_solver_ctx = {"key": key, "fn": None}
            return None
        rows_f, cols_f = self.data.tile_structure.exact(ls, radius, B)

        mode = self._auto_mode(n, len(rows_f) * B * B)
        supported = mode in ("sparseCG", "sparseCGpre", "sparseMINRES",
                             "sparseMINRESpre") or (
            mode in ("sparseLU", "sparseSolve")
            and not self._direct_dense_ok_n(n))
        if not supported:
            self._fast_solver_ctx = {"key": key, "fn": None, "mode": mode}
            return None

        from ..ops.sparse_lml import (_coarse_width,
                                      _normalize_committed_precond,
                                      make_committed_solver,
                                      make_padded_inputs)
        dtype = self.dtype
        device = self.data.device
        xb, mask, _, _, noise_pad = make_padded_inputs(
            x, np.zeros(n), V, B, dtype=dtype, device=device,
            row_multiple=pwidth * n_dev)
        nb = int(xb.shape[0])
        # fused K2 path for float32/bfloat16 solves: row-aligned C-tile
        # chunks — the (T, B, c) product never exists.  float64 keeps the
        # plain scan (the kernel accumulates float32).
        C_fused = 8
        use_fused = (mesh is None and dtype != torch.float64
                     and bool(args.get("gp2Scale_posterior_fused_spmm",
                                       True)))
        # a rank's share (on one device: all rows, no halo)
        part = {"halo_S": None, "plan": (), "cols_remap": None,
                "rsl": slice(None)}
        solver_rows = None
        if use_fused:
            from ..ops.hopper_kernels import row_aligned_schedule
            rows_p, cols_p, rowsc, _ = row_aligned_schedule(
                *row_sorted(rows_f, cols_f), nb, C=C_fused)
            solver_rows = torch.as_tensor(rowsc).to(device)
        elif mesh is not None:
            # the training step's ownership model and exchange; the
            # assembly keeps the global columns, the solve's gather reads
            # the remapped ones of a halo plan
            part = rank_partition(rows_f, cols_f, nb, B, mesh, args, dtype,
                                  device)
            rows_p, cols_p = part["rows"], part["cols"]
            noise_pad = noise_pad[part["rsl"]]
        else:
            rows_p, cols_p = padded_schedule(rows_f, cols_f, nb)
        T_pad = len(rows_p)

        if mode in ("sparseLU", "sparseSolve"):
            sdt = None                       # direct semantics: full precision
            tol = args.get("gp2Scale_posterior_cg_tol", None)
            if tol is None:
                tol = 1e-10 if dtype == torch.float64 else 1e-7
        else:
            sdt = config.as_torch_dtype(
                args.get("gp2Scale_posterior_solver_dtype",
                         args.get("gp2Scale_solver_dtype", None)))
            train_tol = args.get("sparse_cg_tol", None)
            if train_tol is None and mode.startswith("sparseMINRES"):
                train_tol = args.get("sparse_minres_tol", None)
            tol = args.get("gp2Scale_posterior_cg_tol", train_tol)
            if tol is None and sdt is not None \
                    and torch.finfo(sdt).bits < 32:
                # posterior default is TIGHTER than the training exit: the
                # bf16 matvec's attainable floor for user-facing variances
                tol = 1e-3
        tol = float(tol) if tol is not None else None
        train_iters = args.get("sparse_cg_maxiter",
                               args.get("sparse_krylov_maxiter", None))
        if train_iters is None and mode.startswith("sparseMINRES"):
            train_iters = args.get("sparse_minres_maxiter", None)
        maxiter = int(args.get("gp2Scale_posterior_maxiter",
                               max(96, 3 * int(train_iters or 0))))
        assemble, solver = make_committed_solver(
            _stable_kernel_closure(self.prior), nb, B, cg_iters=maxiter,
            solver_dtype=sdt, precond_width=pwidth, cg_tol=tol,
            row_chunk=C_fused if use_fused else None,
            precond_type=ptype, coarse_width=coarse_w, mesh=mesh,
            halo_S=part["halo_S"])
        # Column budget: the fixed residents (tiles + preconditioner) come
        # off the memory budget first; the rest divides by the per-column
        # cost (5 live CG buffers + the matvec's cast copy + the SpMM
        # accumulator).  Default budget: 80% of the card's memory, shared
        # by the ranks that sit on one card.  On a mesh a rank holds its
        # share of the tiles and the rows, plus the gathered iterate and
        # the plain product's per-tile (T_local, B, c) array (JAX charges
        # both, ``gp_kv.py:956-967``).
        n_pad = nb * B
        budget = args.get("gp2Scale_posterior_budget", None)
        if budget is None:
            limit = torch.cuda.mem_get_info(device)[1] \
                if device.type == "cuda" else 0
            share = mesh.ranks_per_device if mesh is not None else 1
            budget = int(0.8 * limit) // share if limit else (5 << 30)
        budget = int(budget)
        item = torch.finfo(dtype).bits // 8
        sitem = torch.finfo(sdt).bits // 8 if sdt is not None else 0
        T_all = T_pad * n_dev
        fixed = (T_all * B * B * (sitem or item)
                 + nb * pwidth * B * B * item) // n_dev + (512 << 20)
        if _normalize_committed_precond(ptype) == "two_level":
            # the (nbg, nbg) float32 coarse inverse and its Cholesky workspace
            nbg = -(-nb // _coarse_width(nb, coarse_w))
            fixed += 3 * nbg * nbg * 4
        bytes_per_col = n_pad * (5 * item + sitem + 4) // n_dev
        if mesh is not None:
            bytes_per_col += (n_pad * (sitem or item)
                              + T_pad * B * (8 if dtype == torch.float64
                                             and sdt is None else 4))
        col_budget = max(1, max(budget - fixed, budget // 8)
                         // max(bytes_per_col, 1))
        if use_fused and col_budget >= 128:
            col_budget = (col_budget // 128) * 128
        override = args.get("gp2Scale_posterior_col_budget", None)
        if override is not None:
            col_budget = max(1, int(override))
        arows = torch.as_tensor(rows_p).to(device)
        acols = torch.as_tensor(cols_p).to(device)
        ctx = {"key": key, "fn": solver, "mode": mode, "assemble": assemble,
               "tiles": None, "Minv": None,
               "arows": arows,              # per-tile rows (assembly)
               "rows": solver_rows if solver_rows is not None else arows,
               "cols": acols,               # global columns (assembly)
               "scols": (acols if part["cols_remap"] is None
                         else part["cols_remap"]),  # the gather's columns
               "halo_args": part["plan"], "mesh": mesh, "rsl": part["rsl"],
               "bytes_per_col": int(bytes_per_col),
               "xb": xb, "mask": mask, "noise_pad": noise_pad,
               "hps": torch.as_tensor(hps, dtype=dtype).to(device),
               "n": n, "n_pad": n_pad, "col_budget": int(col_budget)}
        self._fast_solver_ctx = ctx
        return ctx

    def fast_solve_col_budget(self):
        """Columns per committed-state fast solve, or None (no fast path)."""
        ctx = self._fast_sparse_solver()
        return None if ctx is None else ctx["col_budget"]

    @staticmethod
    def _chunk_widths(c_total, cb):
        """Power-of-two width (capped at the budget) for one chunk, else
        uniform budget-wide chunks (the ragged tail zero-padded)."""
        if c_total <= cb:
            return [min(max(8, 1 << (c_total - 1).bit_length()), cb)]
        return [cb] * (-(-c_total // cb))

    @staticmethod
    def _mesh_chunk_fits(ctx, c_eff):
        """Whether this rank can hold a mesh solve of ``c_eff`` columns: a
        trial allocation of its per-column working set on the card (the
        CPU has no such limit)."""
        device = ctx["xb"].device
        if device.type != "cuda":
            return True
        try:
            torch.empty(c_eff * ctx["bytes_per_col"], dtype=torch.uint8,
                        device=device)
        except torch.cuda.OutOfMemoryError:
            return False
        return True

    def _fast_solve(self, ctx, b, refine=0):
        dtype = self.dtype
        b = b.to(dtype)
        squeeze = b.dim() == 1
        if squeeze:
            b = b[:, None]
        n, n_pad = ctx["n"], ctx["n_pad"]
        c_total = b.shape[1]
        widths = self._chunk_widths(c_total, max(1, int(ctx["col_budget"])))
        if ctx["tiles"] is None:
            # one assembly + preconditioner per committed state, held on
            # the device (the 'fixed' share of the column budget)
            from ..utils.logging import phase_timer
            with phase_timer("fvgp.committed.assemble"):
                ctx["tiles"], ctx["Minv"] = ctx["assemble"](
                    ctx["hps"], ctx["arows"], ctx["cols"], ctx["xb"],
                    ctx["mask"], ctx["noise_pad"])
        mesh = ctx["mesh"]
        while True:
            outs, its, s = [], [], 0
            try:
                for c_eff in widths:
                    c = min(c_total - s, c_eff)
                    rhs_pad = torch.zeros((n_pad, c_eff), dtype=dtype,
                                          device=b.device)
                    rhs_pad[:n, :c] = b[:, s:s + c]
                    # on a mesh every rank retreats together: a retreat on
                    # one rank alone would leave the others waiting in the
                    # CG's collectives
                    if mesh is not None and not all_agree(
                            self._mesh_chunk_fits(ctx, c_eff), mesh):
                        raise torch.cuda.OutOfMemoryError(
                            "a mesh rank cannot hold the chunk")
                    with span("fvgp.committed.solve"):
                        X, it = ctx["fn"](ctx["tiles"], ctx["Minv"],
                                          ctx["rows"], ctx["scols"],
                                          ctx["noise_pad"],
                                          rhs_pad[ctx["rsl"]],
                                          *ctx["halo_args"], refine=refine)
                    if mesh is not None:
                        X = gather_rows(X, mesh)
                    outs.append(X[:n, :c])
                    its.append(it)
                    s += c
                break
            except torch.cuda.OutOfMemoryError:
                # retreat to HALF the attempted width (the JAX package
                # halves the budget, which can leave the width unchanged)
                old_width = widths[0]
                if old_width <= 8:
                    raise
                outs = rhs_pad = X = None                   # noqa: F841
                torch.cuda.empty_cache()
                ctx["col_budget"] = max(8, old_width // 2)
                widths = self._chunk_widths(c_total, ctx["col_budget"])
                warnings.warn(
                    "committed solver: device OOM at chunk width "
                    f"{old_width}; retrying at {ctx['col_budget']} columns "
                    "per solve")
        out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
        self.last_solve_info = {
            "method": "committed_pcg",
            "preconditioner": self.args.get("gp2Scale_posterior_precond",
                                            "block_jacobi"),
            "iterations": its[0] if len(its) == 1 else its,
            "chunks": len(widths)}
        return out[:, 0] if squeeze else out

    def _fast_solve_or_none(self, b, refine=0):
        """A committed-state solve through the fast path (``refine`` rounds
        of iterative refinement after its CG), or None."""
        if not self.gp2Scale:
            return None
        if self.mode is not None and (self._is_custom(self.mode)
                                      or self.mode not in _FAST_MODES):
            return None
        ctx = self._fast_sparse_solver()
        if ctx is None:
            return None
        if self.mode is None:
            # lazy gp2Scale: commit the auto mode WITHOUT materializing KV
            self.mode = ctx["mode"]
        return self._fast_solve(ctx, b, refine)

    def _materialize(self):
        """Under gp2Scale, build the stored K+V and its factorization if a
        state change left them stale: the first access resolves the mode,
        and after an append or new hyperparameters a factor kept from
        before would belong to the old matrix."""
        if self.gp2Scale and self._KV_dirty:
            _ = self.KV

    def solve(self, b, x0=None):
        """(K+V)⁻¹ b against the committed state.  Under gp2Scale with a
        kernel that runs on tensors this goes through the committed-state
        fast solver and never materializes the stored K+V (``x0`` is
        ignored there); otherwise the committed factorization or the
        stored-operator Krylov solve serves it."""
        return self._solve(b, x0)

    def _solve(self, b, x0=None, refine=0):
        """``solve``, with ``refine`` rounds of iterative refinement after
        the committed-state fast solver's CG where that solver serves."""
        b, x0 = self._operand(b), self._operand(x0)
        fast = self._fast_solve_or_none(b, refine)
        if fast is not None:
            return fast
        self._materialize()
        mode = self.mode
        if self._is_custom(mode):
            return self._custom_result(mode[1](self.custom_obj, b))
        if mode == "Chol" or (mode in ("sparseLU", "sparseSolve")
                              and self.Chol_factor is not None):
            return dops.cholesky_solve(self.Chol_factor, b)
        if mode in ("CholInv", "Inv"):
            return self.KVinv @ b
        return self._solve_with(mode, self.KV, b, x0=x0)

    def logdet(self):
        """log|K+V| in the committed mode."""
        self._materialize()
        mode = self.mode
        if self._is_custom(mode):
            return float(mode[2](self.custom_obj))
        if mode in ("Chol", "CholInv") or (
                mode in ("sparseLU", "sparseSolve")
                and self.Chol_factor is not None):
            return float(dops.cholesky_logdet(self.Chol_factor))
        if mode == "Inv":
            return float(dops.calculate_logdet(self.KV))
        return self._random_logdet(self.KV)

    # ------------------------------------------------------------------
    def __getstate__(self):
        state = dict(self.__dict__)
        # closures and device schedules, rebuilt by the next solve
        state["_fast_solver_ctx"] = None
        state["Preconditioner_operator"] = None
        return config.host_state(state)

    def __setstate__(self, state):
        self.__dict__.update(config.device_state(state))
