"""Log marginal likelihood + gradient under gp2Scale (counterpart of
``fvgp_tpu/models/gp_marginal_likelihood.py``, the single-device sparse
path).

L = -1/2 ( (y-m)ᵀ(K+V)⁻¹(y-m) + log|K+V| + n log 2π ), evaluated by the
differentiable mBCG program of ``ops/sparse_lml.make_sparse_lml``.  The
host-side structure pass (bounding-box candidates at inflated lengthscales,
exact tile liveness) is cached under the JAX package's drift policy, and
the tile schedule is row-sorted once per structure for the K1 kernel.
"""

import numpy as np
import torch

from .. import config


def _rademacher_probes(n, p, dtype, device, generator):
    """(n, p) Rademacher probes (±1), drawn on the CPU from ``generator`` so
    a CPU and a CUDA run of the same model see the same probes."""
    bits = torch.randint(0, 2, (n, p), generator=generator, dtype=torch.int8)
    return (2.0 * bits.to(dtype) - 1.0).to(device)


class GPMarginalLikelihood:
    def __init__(self, data, prior, likelihood, trainer, kv):
        self.data = data
        self.prior = prior
        self.likelihood = likelihood
        self.trainer = trainer
        self.kv = kv
        self._sparse_cache = {}
        self._candidate_cache = None
        self._filter_mask_cache = None

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
    def hyperparameters(self):
        return self.trainer.hyperparameters

    # ------------------------------------------------------------------
    def _sparse_traced_ready(self):
        """The gp2Scale LML runs as one differentiable program when the
        kernel runs on torch tensors and mean/noise carry no
        hyperparameters."""
        return (self.data.gp2Scale and self.data.Euclidean
                and self.y_data.shape[1] == 1
                and self.prior.kernel_traceable
                and bool(self.args.get("gp2Scale_traced_lml", True)))

    def _require_sparse(self):
        if not self._sparse_traced_ready():
            raise NotImplementedError(
                "fvgp_tpu_torch: this LML needs the stored-K path (untraceable "
                "kernel, multi-column y or gp2Scale_traced_lml=False), which "
                "is not ported yet (ROADMAP item 1.4)")

    def _sparse_lml_eval(self, hyperparameters, want_grad=False):
        from ..ops.sparse_lml import make_padded_inputs, make_sparse_lml
        from ..parallel.sharded_cov import (_bucket, _candidate_pairs,
                                            _stable_kernel_closure,
                                            support_geometry)
        from ..utils import structure_cache as sc
        from ..utils.logging import phase_timer
        prior = self.prior
        args = self.args
        device = self.data.device
        x = np.asarray(self.x_data, dtype=np.float64)
        n = len(x)
        B = int(args.get("gp2Scale_block_size", min(prior.batch_size, 256)))
        pwidth = int(args.get("gp2Scale_precond_width", 1))
        row_mult = max(pwidth, 1)
        nb = -(-(-(-n // B)) // row_mult) * row_mult
        dtype = config.linalg_dtype(args, device)

        ls, radius = support_geometry(prior, hyperparameters, args)
        if ls is None:
            ls = np.ones(x.shape[1], dtype=np.float64)
        # candidates at INFLATED lengthscales ls·(1+tol): a superset for
        # every ls within the drift band; the exact liveness filter below
        # prunes it exactly
        tol_c = float(args.get("gp2Scale_filter_drift", 0.05))
        data_token = (self.data.point_number, self.data.generation)
        ls_now = np.asarray(ls, dtype=np.float64)
        ccache = self._candidate_cache
        if (ccache is not None
                and ccache[0] == (data_token, B, float(radius))
                and np.all(np.abs(ls_now / ccache[1] - 1.0) <= tol_c)):
            rows_f, cols_f = ccache[2], ccache[3]
        else:
            cdir = sc.cache_dir(args)
            token = self.data.content_token if cdir else None
            dkey = hit = None
            if token is not None:
                dkey = sc.content_key("candidates", token, B, float(radius),
                                      ls_now * (1.0 + tol_c))
                hit = sc.load(cdir, "candidates", dkey)
            if hit is not None:
                rows_f, cols_f = hit["rows"], hit["cols"]
            else:
                with phase_timer("sparse LML: candidate structure"):
                    rows, cols = _candidate_pairs(x, None,
                                                  ls_now * (1.0 + tol_c),
                                                  radius, B, symmetric=True)
                off = rows < cols
                rows_f = np.concatenate([rows, cols[off]]).astype(np.int32)
                cols_f = np.concatenate([cols, rows[off]]).astype(np.int32)
                if dkey is not None:
                    sc.store(cdir, "candidates", dkey,
                             rows=rows_f, cols=cols_f)
            self._candidate_cache = ((data_token, B, float(radius)), ls_now,
                                     rows_f, cols_f)

        cg_iters = int(args.get("sparse_cg_maxiter",
                                args.get("sparse_krylov_maxiter", 64)) or 64)
        ctol = args.get("sparse_cg_tol", None)
        ctol = float(ctol) if ctol is not None else None
        sdt = config.as_torch_dtype(args.get("gp2Scale_solver_dtype", None))
        probes = int(args.get("random_logdet_fixed_probes",
                              max(16, int(args.get(
                                  "random_logdet_min_num_samples", 10)))))
        key = (n, B, nb, cg_iters, ctol, probes, str(dtype), str(sdt), pwidth,
               self.data.point_number)
        entry = self._sparse_cache.get(key)
        if entry is None:
            with phase_timer("sparse LML: padded inputs (host pad + "
                             "device transfer)"):
                noise_h = self.likelihood.calculate_V_host(self.x_data,
                                                           hyperparameters)
                xb, mask, y_pad, ypad_mask, noise_pad = make_padded_inputs(
                    x, np.asarray(self.y_data)[:, 0], noise_h, B,
                    dtype=dtype, device=device, row_multiple=row_mult)
            if xb.shape[0] != nb:
                raise AssertionError((tuple(xb.shape), nb))
            lml = make_sparse_lml(_stable_kernel_closure(prior), nb, B,
                                  cg_iters=cg_iters,
                                  solver_dtype=sdt, precond_width=pwidth,
                                  cg_tol=ctol)
            entry = {"lml": lml, "xb": xb, "mask": mask, "y_pad": y_pad,
                     "ypad_mask": ypad_mask, "noise_pad": noise_pad,
                     "counter": 0, "schedule": None}
            self._sparse_cache = {key: entry}
        generator = torch.Generator().manual_seed(42 + entry["counter"])
        entry["counter"] += 1

        # exact-sparsity pass, cached under the drift policy: while the
        # candidate set is unchanged and the support lengthscales moved
        # < gp2Scale_filter_drift, known-dead pairs stay dropped
        if (bool(args.get("gp2Scale_tile_filter", True))
                and np.isfinite(radius) and len(rows_f)):
            pair_key = rows_f.astype(np.int64) * (nb + 1) + cols_f
            tol = float(args.get("gp2Scale_filter_drift", 0.05))
            cache = self._filter_mask_cache
            if (cache is not None and cache[2] == data_token
                    and cache[3] == (nb, B, float(radius))
                    and np.all(np.abs(ls_now / cache[0] - 1.0) <= tol)):
                keep = ~np.isin(pair_key, cache[1])
            else:
                from ..native import tile_live
                cdir = sc.cache_dir(args)
                token = self.data.content_token if cdir else None
                lkey = keep = None
                if token is not None:
                    lkey = sc.content_key("liveness", token, B, float(radius),
                                          ls_now, rows_f, cols_f)
                    hit = sc.load(cdir, "liveness", lkey)
                    if hit is not None:
                        keep = hit["keep"].astype(bool)
                if keep is None:
                    with phase_timer("sparse LML: exact tile liveness"):
                        keep = tile_live(x / ls_now, rows_f, cols_f, B,
                                         radius)
                    if lkey is not None:
                        sc.store(cdir, "liveness", lkey,
                                 keep=np.asarray(keep, dtype=bool))
                self._filter_mask_cache = (ls_now, np.sort(pair_key[~keep]),
                                           data_token, (nb, B, float(radius)))
                # the committed posterior solver needs the identical
                # filtered structure at these lengthscales: share it
                skey = ("tile_structure", self.data.generation,
                        self.data.point_number, B, float(radius),
                        ls_now.tobytes(), True)
                self.data.structure_cache.clear()
                self.data.structure_cache[skey] = (rows_f[keep], cols_f[keep])
            rows_f = rows_f[keep]
            cols_f = cols_f[keep]

        # row-sorted, bucket-padded schedule (sentinels at the tail) —
        # sorted once per structure, reused while the structure is unchanged
        sched = entry["schedule"]
        if (sched is None or len(sched[0]) != len(rows_f)
                or not np.array_equal(sched[0], rows_f)
                or not np.array_equal(sched[1], cols_f)):
            order = np.argsort(rows_f, kind="stable")
            T_pad = _bucket(max(len(rows_f), 1))
            rows_p = np.full(T_pad, nb, np.int32)
            cols_p = np.full(T_pad, nb, np.int32)
            rows_p[:len(rows_f)] = rows_f[order]
            cols_p[:len(cols_f)] = cols_f[order]
            sched = (rows_f.copy(), cols_f.copy(),
                     torch.as_tensor(rows_p).to(device),
                     torch.as_tensor(cols_p).to(device))
            entry["schedule"] = sched
        rows_d, cols_d = sched[2], sched[3]

        Z = _rademacher_probes(nb * B, probes, dtype, device, generator)
        Z = Z * entry["ypad_mask"][:, None]
        hps = torch.as_tensor(np.asarray(hyperparameters, np.float64),
                              dtype=dtype).to(device)
        with phase_timer("sparse LML: device program"), \
                torch.set_grad_enabled(want_grad):
            hps.requires_grad_(want_grad)
            val = entry["lml"](hps, rows_d, cols_d, entry["xb"],
                               entry["mask"], entry["y_pad"],
                               entry["ypad_mask"], entry["noise_pad"], Z)
            if want_grad:
                grad, = torch.autograd.grad(val, hps)
                return float(val.detach()), config.to_numpy(grad)
        return float(val)

    # ------------------------------------------------------------------
    # public surface
    # ------------------------------------------------------------------
    def log_likelihood(self, hyperparameters=None):
        """Marginal log-likelihood (at the committed hyperparameters when
        None)."""
        self._require_sparse()
        hps = self.hyperparameters if hyperparameters is None \
            else hyperparameters
        val = self._sparse_lml_eval(np.asarray(hps))
        return val if np.isfinite(val) else -np.inf

    def neg_log_likelihood(self, hyperparameters=None):
        return -self.log_likelihood(hyperparameters=hyperparameters)

    def log_likelihood_value_and_gradient(self, hyperparameters):
        """(L, dL/dh) in one pass — the training hot loop calls this."""
        self._require_sparse()
        hyperparameters = np.asarray(hyperparameters)
        val, grad = self._sparse_lml_eval(hyperparameters, want_grad=True)
        if not np.isfinite(val):
            return -np.inf, np.zeros_like(hyperparameters, dtype=float)
        return val, grad

    def neg_log_likelihood_gradient(self, hyperparameters=None, component=0):
        """Gradient of -L."""
        self._require_sparse()
        hps = self.hyperparameters if hyperparameters is None \
            else hyperparameters
        _, grad = self._sparse_lml_eval(np.asarray(hps), want_grad=True)
        return -grad
