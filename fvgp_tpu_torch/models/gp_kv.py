"""Linear-algebra state under gp2Scale (counterpart of
``fvgp_tpu/models/gp_kv.py``): the lazy committed state, the auto mode,
and the committed-state fast solver that assembles the covariance tiles at
the committed hyperparameters and runs the wide preconditioned CG of
``ops/sparse_lml.make_committed_solver`` — on the card with the fused K2
SpMM for float32/bfloat16 solves.

Single device, block-Jacobi.  The stored K+V modes (Chol, CholInv, Inv, the
stored-operator Krylov modes and dense direct solves below
``sparse_direct_dense_cutoff``) are not ported yet (ROADMAP items 1.2,
1.4): a solve that needs them raises ``NotImplementedError``.
"""

import contextlib
import warnings

import numpy as np
import torch

from .. import config

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


class GPkv:
    def __init__(self, data, prior, likelihood, linalg_mode=None):
        if linalg_mode is not None and (not isinstance(linalg_mode, str)
                                        or linalg_mode not in _FAST_MODES):
            raise NotImplementedError(
                f"fvgp_tpu_torch: linalg_mode={linalg_mode!r} is not ported "
                "yet (ROADMAP items 1.2 and 1.4); the gp2Scale path serves "
                f"{sorted(_FAST_MODES)}")
        self.data = data
        self.prior = prior
        self.likelihood = likelihood
        self.linalg_mode = linalg_mode
        self.mode = None              # resolved lazily from the structure
        self.last_solve_info = None
        self._fast_solver_ctx = None
        self._KVinvY = None

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
    def dtype(self):
        return config.linalg_dtype(self.args, self.data.device)

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

    def _direct_dense_ok_n(self, n):
        return n <= int(self.args.get("sparse_direct_dense_cutoff", 20000))

    def update_state_hyperparameters(self):
        self._fast_solver_ctx = None
        self._KVinvY = None

    @property
    def KVinvY(self):
        """(K+V)⁻¹(y - m) at the committed state, shape (N, 1)."""
        if self._KVinvY is None:
            y = torch.as_tensor(np.asarray(self.y_data, np.float64),
                                dtype=self.dtype).to(self.data.device)
            m = self.prior.compute_mean(self.x_data,
                                        self.prior.hyperparameters)
            y_mean = y - m[:, None]
            self._KVinvY = self.solve(y_mean).reshape(y_mean.shape)
        return self._KVinvY

    # ------------------------------------------------------------------
    # committed-state fast sparse solver (in-place tiles; no stored KV)
    # ------------------------------------------------------------------
    def _fast_sparse_solver(self):
        """Context for committed-state solves that assemble the covariance
        tiles at the committed hyperparameters, or None when that path does
        not apply (untraceable kernel, unpruned structure, or a mode it
        does not serve)."""
        if not (self.data.gp2Scale and self.prior.kernel_traceable):
            return None
        from ..parallel.sharded_cov import (_bucket, _stable_kernel_closure,
                                            support_geometry)
        hps = np.asarray(self.prior.hyperparameters, np.float64)
        args = self.args
        B = int(args.get("gp2Scale_block_size",
                         min(self.prior.batch_size, 256)))
        pwidth = max(1, int(args.get("gp2Scale_posterior_precond_width",
                                     args.get("gp2Scale_precond_width", 1))))
        key = (self.data.point_number, self.data.generation, B, pwidth,
               hps.tobytes(), self.linalg_mode,
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
               args.get("gp2Scale_posterior_col_budget"), args.get("dtype"))
        ctx = self._fast_solver_ctx
        if ctx is not None and ctx["key"] == key:
            return ctx if ctx.get("fn") is not None else None

        V = self.likelihood.calculate_V_host(self.x_data,
                                             self.prior.hyperparameters)
        x = np.asarray(self.x_data, np.float64)
        n = len(x)
        ls, radius = support_geometry(self.prior, hps, args)
        if not np.isfinite(radius) and n > 4 * B:
            # unpruned structure: nb² candidate tiles — not a fast path
            self._fast_solver_ctx = {"key": key, "fn": None}
            return None
        if ls is None:
            ls = np.ones(x.shape[1], dtype=np.float64)
        ls = np.asarray(ls, np.float64)
        # the training pass computes the identical filtered structure —
        # share it through the per-data cache
        skey = ("tile_structure", self.data.generation,
                self.data.point_number, B, float(radius), ls.tobytes(),
                bool(args.get("gp2Scale_tile_filter", True)))
        shared = self.data.structure_cache
        if skey in shared:
            rows_f, cols_f = shared[skey]
        else:
            rows_f, cols_f = self._tile_structure(x, ls, radius, B, args)
            shared.clear()          # one live structure per dataset
            shared[skey] = (rows_f, cols_f)

        mode = self._auto_mode(n, len(rows_f) * B * B)
        supported = mode in ("sparseCG", "sparseCGpre", "sparseMINRES",
                             "sparseMINRESpre") or (
            mode in ("sparseLU", "sparseSolve")
            and not self._direct_dense_ok_n(n))
        if not supported:
            self._fast_solver_ctx = {"key": key, "fn": None, "mode": mode}
            return None

        from ..ops.sparse_lml import make_committed_solver, make_padded_inputs
        dtype = self.dtype
        device = self.data.device
        xb, mask, _, _, noise_pad = make_padded_inputs(
            x, np.zeros(n), V, B, dtype=dtype, device=device,
            row_multiple=pwidth)
        nb = int(xb.shape[0])
        # row-sort the schedule (stable, host-side, once): the SpMMs own
        # one output row block at a time (the mirrored upper-triangle
        # entries are not row-ordered as produced)
        order = np.argsort(rows_f, kind="stable")
        rows_f, cols_f = rows_f[order], cols_f[order]
        # fused K2 path for float32/bfloat16 solves: row-aligned C-tile
        # chunks — the (T, B, c) product never exists.  float64 keeps the
        # plain scan (the kernel accumulates float32).
        C_fused = 8
        use_fused = (dtype != torch.float64
                     and bool(args.get("gp2Scale_posterior_fused_spmm",
                                       True)))
        if use_fused:
            from ..ops.hopper_kernels import row_aligned_schedule
            rows_p, cols_p, rowsc, _ = row_aligned_schedule(
                rows_f, cols_f, nb, C=C_fused)
            solver_rows = torch.as_tensor(rowsc).to(device)
        else:
            T_pad = _bucket(max(len(rows_f), 1))
            rows_p = np.full(T_pad, nb, np.int32)
            cols_p = np.full(T_pad, nb, np.int32)
            rows_p[:len(rows_f)] = rows_f
            cols_p[:len(cols_f)] = cols_f
            solver_rows = None
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
            row_chunk=C_fused if use_fused else None)
        # Column budget: the fixed residents (tiles + preconditioner) come
        # off the memory budget first; the rest divides by the per-column
        # cost (5 live CG buffers + the matvec's cast copy + the SpMM
        # accumulator).  Default budget: 80% of the card's memory.
        n_pad = nb * B
        budget = args.get("gp2Scale_posterior_budget", None)
        if budget is None:
            limit = torch.cuda.mem_get_info(device)[1] \
                if device.type == "cuda" else 0
            budget = int(0.8 * limit) if limit else (5 << 30)
        budget = int(budget)
        item = torch.finfo(dtype).bits // 8
        sitem = torch.finfo(sdt).bits // 8 if sdt is not None else 0
        fixed = (T_pad * B * B * (sitem or item)
                 + nb * pwidth * B * B * item + (512 << 20))
        bytes_per_col = n_pad * (5 * item + sitem + 4)
        col_budget = max(1, max(budget - fixed, budget // 8)
                         // max(bytes_per_col, 1))
        if use_fused and col_budget >= 128:
            col_budget = (col_budget // 128) * 128
        override = args.get("gp2Scale_posterior_col_budget", None)
        if override is not None:
            col_budget = max(1, int(override))
        arows = torch.as_tensor(rows_p).to(device)
        ctx = {"key": key, "fn": solver, "mode": mode, "assemble": assemble,
               "tiles": None, "Minv": None,
               "arows": arows,              # per-tile rows (assembly)
               "rows": solver_rows if solver_rows is not None else arows,
               "cols": torch.as_tensor(cols_p).to(device),
               "xb": xb, "mask": mask, "noise_pad": noise_pad,
               "hps": torch.as_tensor(hps, dtype=dtype).to(device),
               "n": n, "n_pad": n_pad, "col_budget": int(col_budget)}
        self._fast_solver_ctx = ctx
        return ctx

    def _tile_structure(self, x, ls, radius, B, args):
        """Filtered (rows, cols) block structure at exact lengthscales:
        bounding-box candidate prune + exact tile liveness (native host
        runtime), content-addressed on disk (utils/structure_cache)."""
        from ..parallel.sharded_cov import _candidate_pairs
        from ..utils import structure_cache as sc
        from ..utils.logging import phase_timer
        filt = bool(args.get("gp2Scale_tile_filter", True))
        cdir = sc.cache_dir(args)
        token = self.data.content_token if cdir else None
        dkey = None
        if token is not None:
            dkey = sc.content_key("tile_structure", token, B, float(radius),
                                  ls, filt)
            hit = sc.load(cdir, "tile_structure", dkey)
            if hit is not None:
                return hit["rows"], hit["cols"]
        with phase_timer("committed solver: tile structure"):
            rows, cols = _candidate_pairs(x, None, ls, radius, B,
                                          symmetric=True)
            off = rows < cols
            rows_f = np.concatenate([rows, cols[off]]).astype(np.int32)
            cols_f = np.concatenate([cols, rows[off]]).astype(np.int32)
            if filt and np.isfinite(radius) and len(rows_f):
                from ..native import tile_live
                keep = tile_live(x / ls, rows_f, cols_f, B, radius)
                rows_f, cols_f = rows_f[keep], cols_f[keep]
        if dkey is not None:
            sc.store(cdir, "tile_structure", dkey, rows=rows_f, cols=cols_f)
        return rows_f, cols_f

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

    def _fast_solve(self, ctx, b):
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
            with phase_timer("committed solver: tile assembly + "
                             "preconditioner"):
                ctx["tiles"], ctx["Minv"] = ctx["assemble"](
                    ctx["hps"], ctx["arows"], ctx["cols"], ctx["xb"],
                    ctx["mask"], ctx["noise_pad"])
        while True:
            outs, its, s = [], [], 0
            try:
                for c_eff in widths:
                    c = min(c_total - s, c_eff)
                    rhs_pad = torch.zeros((n_pad, c_eff), dtype=dtype,
                                          device=b.device)
                    rhs_pad[:n, :c] = b[:, s:s + c]
                    X, it = ctx["fn"](ctx["tiles"], ctx["Minv"], ctx["rows"],
                                      ctx["cols"], ctx["noise_pad"], rhs_pad)
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
            "preconditioner": "block_jacobi",
            "iterations": its[0] if len(its) == 1 else its,
            "chunks": len(widths)}
        return out[:, 0] if squeeze else out

    def solve(self, b):
        """(K+V)⁻¹ b against the committed state, through the fast path."""
        if self.mode is not None and self.mode not in _FAST_MODES:
            raise NotImplementedError(
                f"fvgp_tpu_torch: mode {self.mode!r} needs the stored K+V, "
                "which is not ported yet (ROADMAP items 1.2 and 1.4)")
        ctx = self._fast_sparse_solver()
        if ctx is None:
            mode = (self._fast_solver_ctx or {}).get("mode")
            raise NotImplementedError(
                f"fvgp_tpu_torch: this committed solve (mode {mode!r}) needs "
                "the stored K+V — dense direct below "
                "args['sparse_direct_dense_cutoff'], or an unpruned / "
                "untraceable kernel — which is not ported yet (ROADMAP items "
                "1.2 and 1.4); pass linalg_mode='sparseCGpre'")
        if self.mode is None:
            self.mode = ctx["mode"]
        return self._fast_solve(ctx, b)
