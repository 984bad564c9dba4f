"""Log marginal likelihood + gradient (counterpart of
``fvgp_tpu/models/gp_marginal_likelihood.py``).

L = -1/2 ( (y-m)ᵀ(K+V)⁻¹(y-m) + log|K+V| + n log 2π ), the quadratic term
averaged over the columns of a multi-column y.

* Dense models: when kernel, mean and noise run on torch tensors the LML
  is one plain function of ``hps`` — kernel assembly, Cholesky (or, in the
  ``Inv`` mode, an LU solve and slogdet), solve, logdet — differentiated by
  ``torch.autograd`` (the JAX package's traced ``value_and_grad``; eager, no
  jit).  Its Hessian is ``torch.autograd.functional.hessian``.  A
  population of hyperparameter vectors (``method="global"``, vectorized
  MCMC chains) is evaluated in chunks sized from the card's free memory.
  Host (numpy) callables get the value through the committed-mode trial
  solve; their gradient engine waits for ROADMAP item 1.6.
* gp2Scale: the differentiable program of ``ops/sparse_lml.make_sparse_lml``
  (``args["gp2Scale_solver"]``: ``"mbcg"``, the default, or ``"slq"`` with
  ``args["random_logdet_lanczos_degree"]``); its estimator variance is
  ``log_likelihood_variance``, its Hessian central differences of the
  gradient.  The host-side structure pass
  (bounding-box candidates at inflated lengthscales, exact tile liveness) is
  cached under the JAX package's drift policy, and the tile schedule is
  row-sorted once per structure for the K1 kernel.
* gp2Scale off the traced path (``args["gp2Scale_traced_lml"] = False``, a
  multi-column y, a prior mean function, a kernel that does not run on
  tensors): the stored-K LML — a trial K+V assembled as a
  ``BlockSparseMatrix``, solved in the resolved sparse mode with warm starts
  under ``args["sparse_krylov_warm_start"]``, the log-determinant exact
  below the dense cutoff and by SLQ above it; its estimator variance is
  ``log_likelihood_variance``.
"""

import math

import numpy as np
import torch

from .. import config
from ..ops import dense as dops
from ..ops.slq import rademacher_probes as _rademacher_probes

_LOG_2PI = math.log(2.0 * math.pi)




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
        self._warm_start_KVinvY = None

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
                and self.prior._default_mean
                and bool(self.args.get("gp2Scale_traced_lml", True)))

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
        degree = int(args.get("random_logdet_lanczos_degree", 20))
        # "mbcg" (the default): one preconditioned CG over [y-m | probes]
        # gives the solve and the log-determinant; "slq" runs an
        # implicit-gradient CG and a fixed-degree Lanczos quadrature apart
        solver = str(args.get("gp2Scale_solver", "mbcg"))
        key = (n, B, nb, cg_iters, ctol, probes, degree, str(dtype), str(sdt),
               solver, pwidth, self.data.point_number)
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
                                  cg_iters=cg_iters, slq_degree=degree,
                                  with_variance=True, solver_dtype=sdt,
                                  solver=solver, precond_width=pwidth,
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
            val, var = entry["lml"](hps, rows_d, cols_d, entry["xb"],
                                    entry["mask"], entry["y_pad"],
                                    entry["ypad_mask"], entry["noise_pad"], Z)
            grad = torch.autograd.grad(val, hps)[0] if want_grad else None
        var = float(var.detach())
        self.kv.last_logdet_variance = var
        self.kv.last_logdet_info = {"variance": var,
                                    "num_samples": probes, "degree": degree}
        if want_grad:
            return float(val.detach()), config.to_numpy(grad)
        return float(val)

    # ------------------------------------------------------------------
    # dense traced path
    # ------------------------------------------------------------------
    def _traced_ready(self):
        """The dense LML is one autograd-differentiable function when
        kernel, mean and noise run on torch tensors."""
        return (not self.data.gp2Scale and self.data.Euclidean
                and self.kv.mode in ("Chol", "CholInv", "Inv")
                and self.prior.traceable and self.likelihood.noise_traceable)

    def _hps_tensor(self, hyperparameters, requires_grad=False):
        h = torch.as_tensor(np.asarray(hyperparameters, np.float64),
                            dtype=self.prior.dtype).to(self.data.device)
        return h.requires_grad_(requires_grad)

    def _dense_operands(self, hps):
        """(K+V, y-m) of the dense model at the hyperparameter tensor
        ``hps``, built from the kernel, mean and noise callables directly so
        autograd records them when ``hps`` requires grad."""
        prior, lik = self.prior, self.likelihood
        x = prior._x_dev
        K = prior._apply_kernel(x, x, hps).to(prior.dtype)
        V = lik.call_noise(x, hps).to(prior.dtype) \
            if lik._mode == "callable" else lik.V
        m = prior._default_mean_function(x, hps) if prior._default_mean \
            else prior._apply_mean(x, hps).to(prior.dtype)
        return self.kv.addKV(K, V), self.kv._y_minus(m)

    def _lml_from(self, KV, ym):
        """LML of one or a batch of (K+V, y-m), and the factorization's
        info (non-zero where K+V is not positive definite)."""
        if self.kv.mode == "Inv":
            alpha, info = torch.linalg.solve_ex(KV, ym)
            logdet = torch.linalg.slogdet(KV)[1]
        else:
            L, info = torch.linalg.cholesky_ex(KV)
            alpha = torch.cholesky_solve(ym, L)
            logdet = 2.0 * torch.sum(torch.log(torch.diagonal(
                L, dim1=-2, dim2=-1)), dim=-1)
        l1 = torch.sum(ym * alpha, dim=(-2, -1)) / ym.shape[-1]
        return -0.5 * (l1 + logdet + KV.shape[-1] * _LOG_2PI), info

    def _dense_lml(self, hps):
        return self._lml_from(*self._dense_operands(hps))

    def _traced_eval(self, hyperparameters, want_grad=False):
        """(L, dL/dh or None); NaN where the factorization failed, as the
        JAX program returns NaN from a failed Cholesky."""
        hps = self._hps_tensor(hyperparameters, requires_grad=want_grad)
        with torch.set_grad_enabled(want_grad):
            val, info = self._dense_lml(hps)
            grad = torch.autograd.grad(val, hps)[0] if want_grad else None
        if int(info) != 0:
            return np.nan, (None if grad is None
                            else np.full(len(hyperparameters), np.nan))
        return float(val.detach()), (None if grad is None
                                     else config.to_numpy(grad))

    def _population_chunk(self, pop):
        """Members per batched evaluation: each holds K+V and its factor
        (two n² matrices) plus one member's transient kernel assembly, in
        half of the card's free memory (2 GiB on the CPU)."""
        n = len(self.x_data)
        item = torch.finfo(self.prior.dtype).bits // 8
        dev = self.data.device
        budget = torch.cuda.mem_get_info(dev)[0] // 2 \
            if dev.type == "cuda" else 2 << 30
        return max(1, min(pop, budget // max(3 * n * n * item, 1)))

    def batched_neg_log_likelihood(self, P):
        """-LML over a (pop, H) batch of hyperparameter vectors, evaluated
        in population chunks with batched factorizations (NaN for members
        whose K+V is not positive definite).  None off the traced path."""
        if not self._traced_ready():
            return None
        P = np.atleast_2d(np.asarray(P, np.float64))
        n = len(self.x_data)
        chunk = self._population_chunk(len(P))
        out = []
        with torch.no_grad():
            for s in range(0, len(P), chunk):
                members = P[s:s + chunk]
                KV = torch.empty((len(members), n, n), dtype=self.prior.dtype,
                                 device=self.data.device)
                ym = []
                for i, h in enumerate(members):
                    KV[i], r = self._dense_operands(self._hps_tensor(h))
                    ym.append(r)
                val, info = self._lml_from(KV, torch.stack(ym))
                out.append(torch.where(info == 0, -val,
                                       torch.full_like(val, np.nan)))
                del KV
        return config.to_numpy(torch.cat(out))

    # ------------------------------------------------------------------
    # public surface
    # ------------------------------------------------------------------
    def _require_gradient(self):
        if self.data.gp2Scale:
            if not self._sparse_traced_ready():
                raise NotImplementedError(
                    "fvgp_tpu_torch: the gp2Scale LML gradient exists on the "
                    "traced path only (a kernel that runs on tensors, the "
                    "default mean, one y column, gp2Scale_traced_lml on); the "
                    "formula gradient engine is not ported yet (ROADMAP item "
                    "1.6)")
        elif not self._traced_ready():
            raise NotImplementedError(
                "fvgp_tpu_torch: LML gradients of host (numpy) kernel, mean "
                "or noise callables need the formula gradient engine, which "
                "is not ported yet (ROADMAP item 1.6)")

    # ------------------------------------------------------------------
    # warm-start plumbing of the iterative trial solves
    # ------------------------------------------------------------------
    def _warm_start_enabled(self):
        return bool(self.args.get("sparse_krylov_warm_start", False))

    def _iterative_initial_guess(self, target_shape):
        """The last trial's solution, else the committed one, as the start
        of the next trial solve (None unless warm starts are on)."""
        if not self._warm_start_enabled():
            return None
        for candidate in (self._warm_start_KVinvY, self.kv.KVinvY):
            if candidate is None:
                continue
            guess = candidate.reshape(-1, 1) if candidate.dim() == 1 \
                else candidate
            if guess.shape[0] != target_shape[0]:
                continue
            if guess.shape[1] == target_shape[1]:
                return guess
            if guess.shape[1] == 1 and target_shape[1] > 1:
                return guess.repeat(1, target_shape[1])
        return None

    def _update_warm_start(self, KVinvY):
        if self._warm_start_enabled():
            self._warm_start_KVinvY = KVinvY.clone()

    def compute_new_KVinvY(self, KV, m):
        x0 = self._iterative_initial_guess(tuple(self.y_data.shape))
        KVinvY = self.kv.compute_new_KVinvY(KV, m, x0=x0)
        self._update_warm_start(KVinvY)
        return KVinvY

    def compute_new_KVlogdet_KVinvY(self, K, V, m):
        x0 = self._iterative_initial_guess(tuple(self.y_data.shape))
        KVinvY, KVlogdet = self.kv.compute_new_KVlogdet_KVinvY(K, V, m,
                                                               x0=x0)
        self._update_warm_start(KVinvY)
        return KVinvY, KVlogdet

    def _trial_value(self, hyperparameters):
        """The LML from a trial K+V in the resolved mode: the dense LML of
        host callables, and the stored-K LML under gp2Scale."""
        prior = self.prior
        K = prior.compute_prior_covariance_matrix(self.x_data,
                                                  hyperparameters)
        V = self.likelihood.calculate_V(self.x_data, hyperparameters)
        m = prior.compute_mean(self.x_data, hyperparameters)
        KVinvY, logdet = self.compute_new_KVlogdet_KVinvY(K, V, m)
        return self._lml_value(self.kv._y_minus(m), KVinvY, logdet)

    @staticmethod
    def _lml_value(ym, KVinvY, logdet):
        l1 = float(torch.sum(ym * KVinvY)) / ym.shape[1]
        return -0.5 * (l1 + logdet + len(ym) * _LOG_2PI)

    def log_likelihood(self, hyperparameters=None):
        """Marginal log-likelihood (at the committed hyperparameters when
        None); -inf where K+V is not positive definite."""
        if hyperparameters is None:
            if self._sparse_traced_ready() \
                    and self.kv._fast_sparse_solver() is not None:
                # the committed state through the traced sparse program: the
                # same estimator as the training evaluations, and the stored
                # K+V never materializes.  Gated on the fast path, so the
                # small-N dense modes keep their exact logdet
                val = self._sparse_lml_eval(np.asarray(self.hyperparameters))
            else:
                KVinvY = self.kv.KVinvY
                val = self._lml_value(self.kv._y_minus(self.kv._m_vec),
                                      KVinvY, self.kv.logdet_KV)
        elif self._traced_ready():
            val, _ = self._traced_eval(hyperparameters)
        elif self._sparse_traced_ready():
            val = self._sparse_lml_eval(np.asarray(hyperparameters))
        else:
            try:
                val = self._trial_value(np.asarray(hyperparameters))
            except dops.NonPositiveDefiniteError:
                val = -np.inf
        return val if np.isfinite(val) else -np.inf

    def neg_log_likelihood(self, hyperparameters=None):
        return -self.log_likelihood(hyperparameters=hyperparameters)

    def log_likelihood_variance(self):
        """Variance of the latest stochastic LML evaluation — the SLQ
        estimator's variance scaled by 0.25; None for exact modes."""
        v = self.kv.last_logdet_variance
        return None if v is None else 0.25 * float(v)

    def log_likelihood_value_and_gradient(self, hyperparameters):
        """(L, dL/dh) in one pass — the training hot loop calls this.  Off
        the traced paths the value exists but the gradient raises."""
        self._require_gradient()
        hyperparameters = np.asarray(hyperparameters)
        if not self.data.gp2Scale:
            return self._traced_eval(hyperparameters, want_grad=True)
        val, grad = self._sparse_lml_eval(hyperparameters, want_grad=True)
        if not np.isfinite(val):
            return -np.inf, np.zeros_like(hyperparameters, dtype=float)
        return val, grad

    def neg_log_likelihood_gradient(self, hyperparameters=None, component=0):
        """Gradient of -L (at the committed hyperparameters when None)."""
        hps = self.hyperparameters if hyperparameters is None \
            else hyperparameters
        _, grad = self.log_likelihood_value_and_gradient(np.asarray(hps))
        return -grad

    def neg_log_likelihood_hessian(self, hyperparameters=None):
        """Hessian of -L.  Dense: the exact Hessian (autograd twice through
        the dense LML).  gp2Scale: central differences of the gradient with
        the step 1e-3·max(1, |h_i|), symmetrized — each gradient draws its
        own probes, as the JAX package's do."""
        self._require_gradient()
        if hyperparameters is None:
            hyperparameters = self.hyperparameters
        if not self.data.gp2Scale:
            hess = torch.autograd.functional.hessian(
                lambda h: -self._dense_lml(h)[0],
                self._hps_tensor(hyperparameters))
            return np.asarray(config.to_numpy(hess), dtype=np.float64)
        H = len(hyperparameters)
        d2 = np.zeros((H, H))
        for i in range(H):
            eps = 1e-3 * max(1.0, abs(float(hyperparameters[i])))
            hp = np.array(hyperparameters, dtype=np.float64)
            hm = np.array(hyperparameters, dtype=np.float64)
            hp[i] += eps
            hm[i] -= eps
            d2[i] = (self.neg_log_likelihood_gradient(hyperparameters=hp)
                     - self.neg_log_likelihood_gradient(hyperparameters=hm)
                     ) / (2.0 * eps)
        return 0.5 * (d2 + d2.T)

    def test_log_likelihood_gradient(self, hyperparameters, epsilon=1e-6):
        """Forward differences of the LML beside the analytic gradient:
        ``(finite differences, analytic)``."""
        thps = np.array(hyperparameters, dtype=np.float64)
        grad = np.empty(len(thps))
        base = self.log_likelihood(hyperparameters=thps)
        for i in range(len(thps)):
            aux = np.array(thps)
            aux[i] += epsilon
            grad[i] = (self.log_likelihood(hyperparameters=aux) - base) \
                / epsilon
        analytical = -self.neg_log_likelihood_gradient(hyperparameters=thps)
        return grad, np.asarray(analytical)
