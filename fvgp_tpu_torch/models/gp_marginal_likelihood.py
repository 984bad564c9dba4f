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
* Dense models off that path — host (numpy) kernel, mean or noise
  callables, user gradient callables' models, custom ``[factor, solve,
  logdet]`` modes, non-Euclidean inputs, structured noise — take the value
  from one trial assembly and solve in the committed mode, and the gradient
  from the explicit formula
  ``dL/dh_i = ½ bᵀ (∂(K+V)/∂h_i) b − ½ tr((K+V)⁻¹ ∂(K+V)/∂h_i) − (∂m/∂h_i)ᵀ b``
  with ``b = (K+V)⁻¹(y−m)``: one batched ``cholesky_solve`` over the
  (H, n, n) derivative stack, or one direction at a time under
  ``ram_economy``.  The derivatives come from the user's gradient
  callables, forward-mode AD or central differences (``GPprior.dk_dh``,
  ``dm_dh``, ``GPlikelihood.calculate_V_grad``).  A hyperparameter with a
  non-zero mean derivative takes the mean term only, as in the JAX
  package.  The committed-state gradient (``hyperparameters=None``) takes
  this formula on every dense model, also on the traced path, as the JAX
  package does.  Its Hessian is central differences of the gradient with
  the step ``1e-3·max(1, |h_i|)``.
* gp2Scale: the differentiable program of ``ops/sparse_lml.make_sparse_lml``
  (``args["gp2Scale_solver"]``: ``"mbcg"``, the default, or ``"slq"`` with
  ``args["random_logdet_lanczos_degree"]``); its estimator variance is
  ``log_likelihood_variance``, its Hessian central differences of the
  gradient.  The host-side structure pass is ``parallel/tile_structure``'s
  (candidates at inflated lengthscales, exact tile liveness, the JAX
  package's drift policy); the program's schedule is rebuilt once per
  structure.
* gp2Scale off the traced path (``args["gp2Scale_traced_lml"] = False``, a
  multi-column y, a prior mean function, a noise callable, a kernel that
  does not run on tensors, non-Euclidean inputs): the stored-K LML — a
  trial K+V assembled as a ``BlockSparseMatrix``, solved in the resolved sparse mode with warm starts
  under ``args["sparse_krylov_warm_start"]``, the log-determinant exact
  below the dense cutoff and by SLQ above it; its estimator variance is
  ``log_likelihood_variance``.  It has no gradient (as in the JAX
  package): training off the traced path runs MCMC or BO.
"""

import math

import numpy as np
import torch

from .. import config
from ..ops import dense as dops
from ..ops.slq import rademacher_probes as _rademacher_probes
from ..utils.logging import phase_timer
from ..utils.trace import count, span

_LOG_2PI = math.log(2.0 * math.pi)




class GPMarginalLikelihood:
    def __init__(self, data, prior, likelihood, trainer, kv):
        self.data = data
        self.prior = prior
        self.likelihood = likelihood
        self.trainer = trainer
        self.kv = kv
        self._sparse_cache = {}
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
    def ram_economy(self):
        return self.data.ram_economy

    @property
    def gp2Scale(self):
        return self.data.gp2Scale

    @property
    def hyperparameters(self):
        return self.trainer.hyperparameters

    def invalidate_traced(self):
        """Drop what the traced gp2Scale LML caches for the dataset: the
        program's entry and the tile structure's caches (every entry is
        also keyed by the data's generation, so ``update_gp_data`` does the
        same)."""
        self._sparse_cache = {}
        self.data.tile_structure.clear()

    # ------------------------------------------------------------------
    def _sparse_traced_ready(self):
        """The gp2Scale LML runs as one differentiable program when the
        kernel runs on torch tensors and mean/noise carry no
        hyperparameters."""
        return (self.data.gp2Scale and self.data.Euclidean
                and self.y_data.shape[1] == 1
                and self.prior.kernel_traceable
                and self.prior._default_mean
                and self.likelihood._mode != "callable"
                and bool(self.args.get("gp2Scale_traced_lml", True)))

    def _sparse_settings(self):
        """The traced sparse program's settings, read from ``args``, the
        data and the active mesh, and ``key``: the cached program they
        build.  Under a mesh of n ranks the blocking is padded to a
        multiple of n·pwidth, so every rank owns the same number of row
        blocks and each rank's block count divides by the preconditioner
        width."""
        from ..parallel.mesh import current_mesh, tile_device_count
        from ..parallel.tile_structure import halo_settings
        args = self.args
        n = len(self.x_data)
        B = int(args.get("gp2Scale_block_size",
                         min(self.prior.batch_size, 256)))
        pwidth = int(args.get("gp2Scale_precond_width", 1))
        mesh = current_mesh()
        n_dev = tile_device_count(mesh) if mesh is not None else 1
        if n_dev <= 1:
            mesh, n_dev = None, 1
        row_mult = n_dev * max(pwidth, 1)
        ctol = args.get("sparse_cg_tol", None)
        st = dict(
            n=n, B=B, pwidth=pwidth, mesh=mesh, n_dev=n_dev,
            nb=-(-(-(-n // B)) // row_mult) * row_mult,
            dtype=config.linalg_dtype(args, self.data.device),
            cg_iters=int(args.get("sparse_cg_maxiter",
                                  args.get("sparse_krylov_maxiter", 64))
                         or 64),
            ctol=float(ctol) if ctol is not None else None,
            sdt=config.as_torch_dtype(args.get("gp2Scale_solver_dtype",
                                               None)),
            probes=int(args.get("random_logdet_fixed_probes",
                                max(16, int(args.get(
                                    "random_logdet_min_num_samples", 10))))),
            degree=int(args.get("random_logdet_lanczos_degree", 20)),
            # "mbcg" (the default): one preconditioned CG over [y-m |
            # probes] gives the solve and the log-determinant; "slq" runs
            # an implicit-gradient CG and a fixed-degree Lanczos quadrature
            # apart
            solver=str(args.get("gp2Scale_solver", "mbcg")))
        st["key"] = (n, B, st["nb"], st["cg_iters"], st["ctol"],
                     st["probes"], st["degree"], str(st["dtype"]),
                     str(st["sdt"]), st["solver"], pwidth,
                     self.data.point_number, mesh) + halo_settings(args)
        return st

    def _sparse_lml_eval(self, hyperparameters, want_grad=False):
        st = self._sparse_settings()
        with span("fvgp.sparse_lml.structure"):
            entry, run = self._sparse_structure(hyperparameters, st)
        nb, B, dtype, probes, degree = (st[k] for k in ("nb", "B", "dtype",
                                                        "probes", "degree"))
        device = self.data.device
        with span("fvgp.sparse_lml.probes"):
            generator = torch.Generator().manual_seed(42 + entry["counter"])
            entry["counter"] += 1
            Z = run["probe"](_rademacher_probes(nb * B, probes, dtype, device,
                                                generator))
            hps = torch.as_tensor(np.asarray(hyperparameters, np.float64),
                                  dtype=dtype).to(device)
        grad = None
        with torch.set_grad_enabled(want_grad):
            hps.requires_grad_(want_grad)
            val, var = run["lml"](hps, *run["static"], Z, *run["halo"])
            if want_grad:
                with span("fvgp.sparse_lml.backward"):
                    grad = torch.autograd.grad(val, hps)[0]
        var = config.to_float(var.detach())
        self.kv.last_logdet_variance = var
        self.kv.last_logdet_info = {"variance": var,
                                    "num_samples": probes, "degree": degree}
        if want_grad:
            return config.to_float(val.detach()), config.to_numpy(grad)
        return config.to_float(val)

    def _sparse_structure(self, hyperparameters, st):
        """(entry, run) of the sparse LML at ``hyperparameters``: the cached
        program and padded inputs, and the schedule of the training
        structure at these lengthscales (``data.tile_structure``), rebuilt
        where the structure moved."""
        from ..ops.sparse_lml import make_padded_inputs, make_sparse_lml
        from ..parallel.sharded_cov import _stable_kernel_closure
        tiles = self.data.tile_structure
        device = self.data.device
        B, nb, pwidth, dtype = (st[k] for k in ("B", "nb", "pwidth", "dtype"))
        cg_iters, ctol, sdt, probes, degree, solver, key = (
            st[k] for k in ("cg_iters", "ctol", "sdt", "probes", "degree",
                            "solver", "key"))
        ls, radius = tiles.support(self.prior, hyperparameters)
        entry = self._sparse_cache.get(key)
        if entry is None:
            with phase_timer("fvgp.sparse_lml.padded_inputs"):
                noise_h = self.likelihood.calculate_V_host(self.x_data,
                                                           hyperparameters)
                xb, mask, y_pad, ypad_mask, noise_pad = make_padded_inputs(
                    np.asarray(self.x_data, dtype=np.float64),
                    np.asarray(self.y_data)[:, 0], noise_h, B, dtype=dtype,
                    device=device, row_multiple=st["n_dev"] * max(pwidth, 1))
            if xb.shape[0] != nb:
                raise AssertionError((tuple(xb.shape), nb))
            kern = _stable_kernel_closure(self.prior)

            def lml_for(nb_eff, halo_S=None):
                return make_sparse_lml(kern, nb_eff, B, cg_iters=cg_iters,
                                       slq_degree=degree, with_variance=True,
                                       solver_dtype=sdt, solver=solver,
                                       precond_width=pwidth, cg_tol=ctol,
                                       mesh=st["mesh"], halo_S=halo_S)

            entry = {"lml_for": lml_for, "xb": xb, "mask": mask,
                     "y_pad": y_pad, "ypad_mask": ypad_mask,
                     "noise_pad": noise_pad, "probes": probes, "counter": 0,
                     "schedule": None}
            self._sparse_cache = {key: entry}
        # the program's schedule and bound inputs, built once per structure
        # and reused while the filtered structure is unchanged: meshless, the
        # padded schedule; under a mesh, the rank's segment of it.  Where
        # neither structure cache moved since the schedule was built, the
        # structure is its own, unfiltered and uncompared (the stamp)
        sched = entry["schedule"]
        rows_f, cols_f, stamp = tiles.training(
            ls, radius, B, nb, since=None if sched is None else sched[3])
        if rows_f is not None and (
                sched is None or len(sched[0]) != len(rows_f)
                or not np.array_equal(sched[0], rows_f)
                or not np.array_equal(sched[1], cols_f)):
            with span("fvgp.sparse_lml.schedule"):
                run = (self._mesh_run(entry, rows_f, cols_f, st)
                       if st["mesh"] is not None
                       else self._single_run(entry, rows_f, cols_f, nb,
                                             device))
            count("schedule_rebuilds")
            sched = (rows_f.copy(), cols_f.copy(), run, stamp)
        else:
            sched = sched[:3] + (stamp,)
        entry["schedule"] = sched
        # what the Adam chain revalidates on entry: the support lengthscales
        # and the data this structure was built for
        entry["chain_ctx"] = {"ls_ref": ls, "data_token": tiles.token()}
        return entry, sched[2]

    def _single_run(self, entry, rows_f, cols_f, nb, device):
        """One device: the padded schedule and the padded inputs."""
        from ..parallel.tile_structure import padded_schedule
        rows_p, cols_p = padded_schedule(rows_f, cols_f, nb)
        ypad_mask = entry["ypad_mask"]
        return {"lml": entry["lml_for"](nb),
                "static": (torch.as_tensor(rows_p).to(device),
                           torch.as_tensor(cols_p).to(device), entry["xb"],
                           entry["mask"], entry["y_pad"], ypad_mask,
                           entry["noise_pad"]),
                "halo": (), "probe": lambda Z: Z * ypad_mask[:, None]}

    def _mesh_run(self, entry, rows_f, cols_f, st):
        """A mesh rank's share of the sparse LML (the JAX package's mesh
        branch, ``gp_marginal_likelihood.py:466-640``).  Every rank runs
        this host pass on the same replicated structure, so every rank
        derives the same plan.

        Row-block ranges are balanced by tile count
        (``partition.tile_balanced_layout``; the per-rank width is pinned
        to a bucket at the first structure of these settings) and mapped
        onto equal-width ranks by a permuted padded block layout; the
        schedule is then partitioned by ``tile_structure.rank_partition``.
        The rank keeps its segment, its rows of the permuted y / mask /
        noise and of the plan; points and mask stay whole.  Probes are
        drawn per logical point and gathered through the layout, so a mesh
        run and a meshless one see the same ``Z``."""
        from ..parallel.partition import (apply_block_layout, permute_blocked,
                                          tile_balanced_layout)
        from ..parallel.tile_structure import rank_partition
        mesh, n_dev, nb, B = st["mesh"], st["n_dev"], st["nb"], st["B"]
        dtype, device = st["dtype"], self.data.device
        layout, W = tile_balanced_layout(rows_f, nb, n_dev,
                                         width=entry.get("layout_width"))
        if layout is not None and entry.get("layout_width") is None:
            # pin the per-rank width to a bucket, so that later drift of
            # the structure keeps the program's block count
            W0 = nb // n_dev
            step = max(1, -(-W0 // 8))
            Wb = min(-(-W // step) * step, int(np.ceil(1.5 * W0)))
            entry["layout_width"] = Wb
            if Wb != W:
                layout, W = tile_balanced_layout(rows_f, nb, n_dev, width=Wb)
        vecs = {k: entry[k] for k in ("xb", "mask", "y_pad", "ypad_mask",
                                      "noise_pad")}
        rows_u, cols_u, nb_eff = rows_f, cols_f, nb
        layout_idx = None
        if layout is not None:
            rows_u, cols_u, nb_eff = apply_block_layout(layout, rows_f,
                                                        cols_f, nb)

            def perm(name, pad=0.0):
                a = config.to_numpy(vecs[name])
                shape = a.shape
                if a.ndim == 1:
                    a = a.reshape(nb, B)
                out = permute_blocked(layout, a, pad_value=pad)
                if len(shape) == 1:
                    out = out.ravel()
                return torch.as_tensor(out, dtype=dtype).to(device)

            vecs = {"xb": perm("xb"), "mask": perm("mask"),
                    "y_pad": perm("y_pad"), "ypad_mask": perm("ypad_mask"),
                    "noise_pad": perm("noise_pad", 1.0)}
            layout_idx = torch.as_tensor(np.where(layout >= 0, layout, 0))
        part = rank_partition(rows_u, cols_u, nb_eff, B, mesh, self.args,
                              dtype, device)
        rsl = part["rsl"]
        halo = part["plan"] + ((part["cols_remap"],)
                               if part["halo_S"] is not None else ())
        ypad_mask, ym_m = entry["ypad_mask"], vecs["ypad_mask"]

        def probe(Z):
            Z = Z * ypad_mask[:, None]
            if layout_idx is not None:
                Z = Z.reshape(nb, B, -1)[layout_idx.to(Z.device)]
                Z = Z.reshape(nb_eff * B, -1) * ym_m[:, None]
            return Z[rsl]

        return {"lml": entry["lml_for"](nb_eff, part["halo_S"]),
                "static": (torch.as_tensor(part["rows"]).to(device),
                           torch.as_tensor(part["cols"]).to(device),
                           vecs["xb"], vecs["mask"], vecs["y_pad"][rsl],
                           vecs["ypad_mask"][rsl], vecs["noise_pad"][rsl]),
                "halo": halo, "probe": probe, "exchange": part["exchange"],
                "schedule": part["schedule"]}

    def _chain_entry(self, theta):
        """The cached sparse program for an Adam chunk at ``theta``: reused
        while ``args`` still build it, the data is unchanged and the support
        lengthscales stay inside the drift band of the ones its structure
        was built at, else refreshed by one value-and-gradient evaluation
        at ``theta``."""
        tiles = self.data.tile_structure
        entry = self._sparse_cache.get(self._sparse_settings()["key"])
        ctx = entry.get("chain_ctx") if entry is not None else None
        if (ctx is not None and ctx["data_token"] == tiles.token()
                and tiles.within_drift(tiles.support(self.prior, theta)[0],
                                       ctx["ls_ref"])):
            return entry
        self._sparse_lml_eval(theta, want_grad=True)
        return self._sparse_cache[self._sparse_settings()["key"]]

    def sparse_adam_steps(self, theta, m, v, t_start, n_steps, seed=0,
                          lr=1e-2, beta1=0.9, beta2=0.999, eps=1e-8,
                          bounds=None, probe_source=None):
        """``n_steps`` Adam steps on the NEGATIVE sparse LML, every step a
        value-and-gradient of the cached program (its mBCG launches K1) and
        the moment update (``gp_training.adam_step``) on the device, in the
        hyperparameters' dtype.

        The structure (tile schedule, padded inputs) is revalidated against
        ``theta`` on entry only: inside the chunk it is reused, the bet the
        drift policy already makes, so staleness never exceeds one chunk.
        Probes are fresh at every step, drawn from a generator seeded by
        ``(seed, the entry's evaluation counter, t_start + i)``: the
        ABSOLUTE step index, or chunk k+1 would replay chunk k's probes and
        the estimator's noise would become a repeating bias.
        ``probe_source`` (a callable ``step -> Z`` of shape
        (padded N, probes)) replaces the generator.  Non-finite gradients
        are zeroed; ``bounds`` clamps.  Returns ``(theta, m, v, fvals)`` as
        numpy, ``fvals`` the per-step negative LML values.

        The chain keeps the JAX chain's structure reuse and probe law; it
        saves no dispatch (JAX fuses the chunk into one program, here each
        step is one value-and-gradient, as in the host loop)."""
        from .gp_training import adam_step
        theta = np.asarray(theta, dtype=np.float64)
        entry = self._chain_entry(theta)
        device = self.data.device
        dtype = config.linalg_dtype(self.args, device)
        run = entry["schedule"][2]
        n_pad = entry["xb"].shape[0] * entry["xb"].shape[1]

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float64),
                                   dtype=dtype).to(device)

        th, m, v = dev(theta), dev(m), dev(v)
        if bounds is not None:
            lo, hi = (dev(col) for col in np.asarray(bounds).T)
        fvals = []
        for i in range(int(n_steps)):
            step = int(t_start) + i
            with span("fvgp.sparse_lml.probes"):
                if probe_source is not None:
                    Z = torch.as_tensor(probe_source(step),
                                        dtype=dtype).to(device)
                else:
                    key = np.random.SeedSequence(
                        [int(seed), int(entry["counter"]), step])
                    generator = torch.Generator().manual_seed(
                        int(key.generate_state(1)[0]))
                    Z = _rademacher_probes(n_pad, entry["probes"], dtype,
                                           device, generator)
            h = th.detach().requires_grad_(True)
            with torch.enable_grad():
                val, _ = run["lml"](h, *run["static"], run["probe"](Z),
                                    *run["halo"])
                with span("fvgp.sparse_lml.backward"):
                    g = -torch.autograd.grad(val, h)[0]    # minimize -LML
            g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
            th, m, v = adam_step(th, g, m, v, step + 1, lr, beta1, beta2,
                                 eps)
            if bounds is not None:
                th = torch.clamp(th, lo, hi)
            fvals.append(-val.detach())
        return (config.to_numpy(th), config.to_numpy(m), config.to_numpy(v),
                config.to_numpy(torch.stack(fvals)))

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
        grad = None
        with torch.set_grad_enabled(want_grad):
            with span("fvgp.dense_lml.forward"):
                val, info = self._dense_lml(hps)
            if want_grad:
                with span("fvgp.dense_lml.backward"):
                    grad = torch.autograd.grad(val, hps)[0]
        if config.to_float(info) != 0:
            return np.nan, (None if grad is None
                            else np.full(len(hyperparameters), np.nan))
        return config.to_float(val.detach()), (None if grad is None
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

    def batched_value_and_grad_device(self):
        """A callable ``(pop, H) -> (values, grads)`` of the NEGATIVE dense
        LML on the model's device (tensors in, tensors out; numpy is
        accepted) — the engine of the ``hgdl`` lockstep phase.  None off the
        traced path.

        A chunk of members is one batched factorization and one
        ``torch.autograd.grad`` of the sum of their values: the members are
        independent, so row i of the gradient is member i's.  A member whose
        K+V is not positive definite is masked out of the sum and returns
        NaN; its gradient row may be non-finite (the caller zeroes it).
        Autograd records the plain kernel formula (K3 serves no recorded
        input), so a member holds about ten n² saved tensors besides K+V and
        its factor: on the card one member's peak is measured once, with
        the first member of the first call, and chunks fill half of the free
        memory; on the CPU they fill 2 GiB at 13 n² per member."""
        if not self._traced_ready():
            return None
        return self._batched_value_and_grad

    def _vg_members(self, P):
        """(-LML, its gradient) of one chunk of members."""
        n = len(self.x_data)
        hps = P.detach().clone().requires_grad_(True)
        with torch.enable_grad():
            KV = torch.empty((len(P), n, n), dtype=self.prior.dtype,
                             device=self.data.device)
            ym = []
            for i in range(len(P)):
                KV[i], r = self._dense_operands(hps[i])
                ym.append(r)
            val, info = self._lml_from(KV, torch.stack(ym))
            ok = info == 0
            del KV
            total = torch.where(ok, val, torch.zeros_like(val)).sum()
            grad = -torch.autograd.grad(total, hps)[0]
        return torch.where(ok, -val.detach(),
                           torch.full_like(val, float("nan"))), grad

    def _batched_value_and_grad(self, P):
        dev = self.data.device
        P = torch.as_tensor(P, dtype=self.prior.dtype).to(dev)
        n = len(self.x_data)
        item = torch.finfo(self.prior.dtype).bits // 8
        key = (n, str(self.prior.dtype), self.kv.mode)
        vals, grads = [], []
        s = 0
        if dev.type == "cuda" and getattr(self, "_vg_member_bytes",
                                          (None,))[0] != key:
            torch.cuda.synchronize(dev)
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            v, g = self._vg_members(P[:1])
            vals.append(v)
            grads.append(g)
            self._vg_member_bytes = (key, max(
                torch.cuda.max_memory_allocated(dev) - base, 1))
            s = 1
        if dev.type == "cuda":
            per_member = self._vg_member_bytes[1]
            budget = torch.cuda.mem_get_info(dev)[0] // 2
        else:
            per_member, budget = 13 * n * n * item, 2 << 30
        chunk = self._vg_chunk = max(1, budget // per_member)
        while s < len(P):
            v, g = self._vg_members(P[s:s + chunk])
            vals.append(v)
            grads.append(g)
            s += chunk
        return torch.cat(vals), torch.cat(grads)

    # ------------------------------------------------------------------
    # public surface
    # ------------------------------------------------------------------
    def _require_gradient(self):
        """Raise where the JAX package has no gradient: gp2Scale off the
        traced sparse program."""
        if self.data.gp2Scale and not self._sparse_traced_ready():
            raise Exception("Can't compute neg_log_likelihood_gradient for "
                            "gp2Scale with a non-traceable (host numpy) "
                            "kernel")

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

    def _trial_state(self, K, V, m):
        """The kv's trial state of (K, V, m), warm-started where warm starts
        are on: ``(K+V, KVinvY, logdet, Cholesky factor or None)``."""
        x0 = self._iterative_initial_guess(tuple(self.y_data.shape))
        state = self.kv.trial_state(K, V, m, x0=x0)
        self._update_warm_start(state[1])
        return state

    def compute_new_KVlogdet_KVinvY(self, K, V, m):
        """``(KVinvY, log|K+V|)`` of a trial (K, V, m) through the kv's one
        factorization, warm-started where warm starts are on."""
        return self._trial_state(K, V, m)[1:3]

    def _trial(self, hyperparameters):
        """One trial assembly and solve in the resolved mode: ``(K, V, m,
        K+V, KVinvY, logdet, Cholesky factor or None)``."""
        prior = self.prior
        K = prior.compute_prior_covariance_matrix(self.x_data,
                                                  hyperparameters)
        V = self.likelihood.calculate_V(self.x_data, hyperparameters)
        m = prior.compute_mean(prior._x_points(), hyperparameters)
        return (K, V, m, *self._trial_state(K, V, m))

    def _trial_value(self, hyperparameters):
        """The LML from a trial K+V in the resolved mode: the dense LML of
        host callables, and the stored-K LML under gp2Scale."""
        _, _, m, _, KVinvY, logdet, _ = self._trial(hyperparameters)
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
        """(L, dL/dh) in one pass — the training hot loop calls this.  Dense
        models off the traced path share one trial assembly and
        factorization between the value and the formula gradient; gp2Scale
        off the traced path has no gradient and raises."""
        hyperparameters = np.asarray(hyperparameters)
        if self._traced_ready():
            return self._traced_eval(hyperparameters, want_grad=True)
        if self._sparse_traced_ready():
            val, grad = self._sparse_lml_eval(hyperparameters, want_grad=True)
            if not np.isfinite(val):
                return -np.inf, np.zeros_like(hyperparameters, dtype=float)
            return val, grad
        self._require_gradient()
        try:
            trial = self._trial(hyperparameters)
        except dops.NonPositiveDefiniteError as e:
            raise Exception(f"Linear algebra failed for hyperparameters "
                            f"{hyperparameters}: {e}") from e
        _, _, m, KV, KVinvY, logdet, chol = trial
        val = self._lml_value(self.kv._y_minus(m), KVinvY, logdet)
        grad = -self._formula_gradient(hyperparameters,
                                       trial=(KV, KVinvY, chol))
        return val, grad

    def neg_log_likelihood_gradient(self, hyperparameters=None, component=0):
        """Gradient of -L.  gp2Scale: the traced sparse program's (at the
        committed hyperparameters when None), and none off it.  Dense: at
        given hyperparameters autograd on the traced path, else the formula
        gradient; at the committed state (None) the formula gradient of the
        committed factorization, on every dense model (``component``: the
        column of a multi-column y)."""
        if self.data.gp2Scale:
            hps = self.hyperparameters if hyperparameters is None \
                else hyperparameters
            _, grad = self.log_likelihood_value_and_gradient(np.asarray(hps))
            return -grad
        if hyperparameters is not None and self._traced_ready():
            _, grad = self._traced_eval(np.asarray(hyperparameters),
                                        want_grad=True)
            return -grad
        return self._formula_gradient(hyperparameters, component)

    def _formula_gradient(self, hyperparameters, component=0, trial=None):
        """dL/dh by the explicit formula (the NEGATIVE gradient's sign, as
        the JAX package returns it): at the committed state when
        ``hyperparameters`` is None, else at a trial — the caller's
        ``trial=(K+V, KVinvY, Cholesky factor or None)`` or one assembled
        here.  ``ram_economy=False``: the (H, n, n) stack of ∂(K+V)/∂h and
        one batched ``cholesky_solve``; ``True``: one direction at a time,
        skipping the solve of a direction whose mean term is non-zero."""
        prior, lik, kv = self.prior, self.likelihood, self.kv
        chol = None
        if hyperparameters is None:
            hyperparameters = self.hyperparameters
            KV, KVinvY, chol = kv.KV, kv.KVinvY, kv.Chol_factor
        elif trial is not None:
            KV, KVinvY, chol = trial
        else:
            _, _, _, KV, KVinvY, _, chol = self._trial(hyperparameters)
        hyperparameters = np.asarray(hyperparameters, dtype=np.float64)
        x = prior._x_points()
        b = KVinvY[:, component]
        H = len(hyperparameters)
        dm_term = prior.dm_dh(x, hyperparameters) @ b
        L = chol if chol is not None \
            else dops.cholesky_factor(kv._densify(KV))
        if not self.data.ram_economy:
            dKV = prior.dk_dh(x, x, hyperparameters)
            if prior._user_dk_dh is not None:
                dKV = dKV.clone()       # may share the user's array
            noise_der = lik.calculate_V_grad(x, hyperparameters)
            if noise_der.dim() == 2:
                dKV.diagonal(dim1=-2, dim2=-1).add_(noise_der)
            else:
                dKV += noise_der
            sol = torch.cholesky_solve(dKV, L)
            traces = sol.diagonal(dim1=-2, dim2=-1).sum(-1)
            del sol
            quad = torch.einsum("i,hij,j->h", b, dKV, b)
            grads = torch.where(dm_term == 0.0, -0.5 * (quad - traces),
                                torch.zeros_like(quad))
            return config.to_numpy(grads) - config.to_numpy(dm_term)
        dL_dH = np.zeros(H)
        dL_dHm = -config.to_numpy(dm_term)
        for i in range(H):
            if dL_dHm[i] != 0.0:
                continue
            dKV = prior.dk_dh(x, x, hyperparameters, direction=i)
            noise_der = lik.calculate_V_grad(x, hyperparameters, direction=i)
            if noise_der.dim() == 1:
                dKV = dops.add_diagonal(dKV, noise_der)
            else:
                dKV = dKV + noise_der
            trace = torch.cholesky_solve(dKV, L).diagonal().sum()
            dL_dH[i] = -0.5 * (float(b @ (dKV @ b)) - float(trace))
        return dL_dH + dL_dHm

    def neg_log_likelihood_hessian(self, hyperparameters=None):
        """Hessian of -L.  The dense traced path: the exact Hessian
        (autograd twice through the dense LML).  Elsewhere central
        differences of the gradient with the step 1e-3·max(1, |h_i|),
        symmetrized — under gp2Scale each gradient draws its own probes, as
        the JAX package's do; a host callable's gradient carries its own
        difference-quotient noise, which a smaller step would amplify."""
        if hyperparameters is None:
            hyperparameters = self.hyperparameters
        if self._traced_ready():
            hess = torch.autograd.functional.hessian(
                lambda h: -self._dense_lml(h)[0],
                self._hps_tensor(hyperparameters))
            return np.asarray(config.to_numpy(hess), dtype=np.float64)
        self._require_gradient()
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

    def __getstate__(self):
        state = dict(self.__dict__)
        # the traced program's closures: rebuilt by the next evaluation
        state.update(_sparse_cache={})
        return config.host_state(state)

    def __setstate__(self, state):
        self.__dict__.update(config.device_state(state))

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
