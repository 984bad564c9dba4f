#!/usr/bin/env python3
"""Where a journey's time goes on one CUDA card.

Run from the root of the repository:

    python3 chip_profile.py [N]             # the dense journey
    python3 chip_profile.py gp2scale [N]    # the gp2Scale journey
    python3 chip_profile.py stored [N]      # the stored-K gp2Scale journey
    python3 chip_profile.py slq [N]         # the SLQ training solver
    python3 chip_profile.py k1              # K1's launch order and wrapper
    python3 chip_profile.py k3              # K3's launch and store variants
    python3 chip_profile.py k4              # K4's wrapper, launch by launch
    python3 chip_profile.py cell <workload> [seed]   # a benchmark cell

Dense: builds the bench's dense cell (``chip_smoke.dense_cell_data``,
N = 10,000 by default, D = 3, linalg_mode="Chol", float32), warms it up,
then traces with ``torch.profiler`` (a) three LML + gradient evaluations
and (b) one ``set_hyperparameters`` commit followed by ``posterior_mean``
and ``posterior_covariance(variance_only=True)`` on 500 points.

gp2Scale: builds the smoke's N = 1,000,000 journey
(``chip_smoke.journey_data`` and ``journey_model``: B = 128, bfloat16
solver), warms it up, then traces (a) one LML + gradient evaluation,
(b) one ``set_hyperparameters`` commit followed by ``posterior_mean`` on
500 points (the committed tile assembly and the c = 8 solve) and (c)
``posterior_covariance(variance_only=True)`` on the same points (the
c = 512 solve).

stored: builds the smoke's stored-K model (``chip_smoke.stored_model`` on
``journey_data``: N = 1,000,000, B = 128, bfloat16 tile storage,
``gp2Scale_traced_lml=False``, sparseCGpre), warms it up, then traces
(a) the assembly of ``gp.K``, (b) one trial ``log_likelihood(hps)``, and on
the committed K+V (c) one preconditioned CG solve and (d) one SLQ
log-determinant.

For each window (each call in it marked as one request,
``gpbench.request``) it prints what the benchmark's trace reducers give:
the window, the device's idle time (the window less the union of its
kernel, copy and fill intervals, ``gpbench/harness/trace.py``) and the
part of it inside the program's spans; per request and span
(``gpbench/harness/spans.py``) the host, self, device and idle ms; the
longest idle gaps, each named by the innermost span around it; and the
largest device-time entries by name.  The profiler stretches host time, so
the device totals are the comparable numbers.

cell: one cell of the benchmark (``BENCHMARK.json``; the seed defaults to
1): its data, system and warm-up as ``gpbench/run.py`` makes them, then the
cell's traced requests in one such window, the program's counters per
request (``fvgp_tpu_torch.utils.trace.counters()`` and K1's and K2's
launches, with the share of K2's on the float32 wgmma body), the
benchmark's ``assembly_ms`` and ``dense_linalg_ms`` kernels of the same
window by the span that launched them, and one more request
under ``torch.cuda.set_sync_debug_mode("warn")``: the synchronising calls
it reports, by the line of the program that made them, beside the
request's ``host_syncs``.

slq: on the gp2Scale journey's model (N = 1,000,000, bfloat16), the LML
value by mBCG (the journey's settings, and with ``sparse_cg_tol`` 1e-3 and
200 trips), by SLQ at degree 20 and 40 and by SLQ with float32 streaming,
each variant on the same 16 probes, at the configuration's
hyperparameters and at a point on the smoke's training path; then one SLQ
LML + gradient traced with ``torch.profiler``, and the committed state's
500-point variance with the two-level preconditioner and with
block-Jacobi (each a commit, its assembly and its solve; warmed up once).

k1: at the smoke's N = 50k training structure (float32 and bfloat16
tiles), bare launches of K1 with the longest-rows-first order and without
one (row-major), in turns, beside the wrapper ``chunked_spmm``; the same at
the N = 1M journey's shape, where the launcher drops the order (the grid
is ~30 waves), so both bare launches run row-major.

k3: at the dense journey's shapes (N = 10,000, D = 3; N x N on one tensor
and on two, N x 500, 500 x 500), float32 and float64: bare launches beside
the wrapper ``dense_covariance``, in turns — k(X, X) by the symmetric and by
the full route (Matérn-3/2 and Wendland, and at D = 8 and 32: the
measurements behind the wrapper's route rule), the store variants of the
kernel (16-byte stores with and without the streaming hint, the
scalar-store instance), and one wrapper call of N x 500 launch by launch.

k4: at the same N = 50k structure, one call of the entry point
``block_spmv`` traced with ``torch.profiler`` — float32 and bfloat16, a 2-D
X (n = 50,000, k = 17) and a 1-D X: every device kernel and copy of the
call with its time, the CUDA runtime calls the host made for it (launches,
copies, synchronisations), the host time of the call, and the event-timed
means of the call and of the bare launch on operands prepared once.

Exits non-zero without a card.
"""

import sys
import time
import traceback
import warnings

import numpy as np


def window(label, calls, top=10):
    """``calls`` (callables) under the profiler, each marked as one request
    and synchronised; prints the idle attribution, the per-span table and
    the ``top`` largest device entries by name, and returns the window's
    records (``spans.records``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from gpbench.harness import spans, trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for call in calls:
            with record_function(trace.SPAN):
                call()
                torch.cuda.synchronize()
    sp, launches, device = spans.records(prof.profiler.kineto_results.events())
    spans.print_table(spans.reduce(sp, launches, device), label,
                      out=lambda line: print(line, flush=True))
    by_name = {}
    for name, s, e, _, _ in device:
        by_name[name] = by_name.get(name, 0) + e - s
    for name, ns in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  device {ns / 1e6:9.3f} ms  {name[:90]}", flush=True)
    return sp, launches, device


def main():
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this profile needs a "
              "CUDA card")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    warnings.simplefilter("ignore")
    args = sys.argv[1:]
    if args and args[0] == "gp2scale":
        return gp2scale(int(args[1]) if len(args) > 1 else 1_000_000)
    if args and args[0] == "stored":
        return stored(int(args[1]) if len(args) > 1 else 1_000_000)
    if args and args[0] == "slq":
        return slq(int(args[1]) if len(args) > 1 else 1_000_000)
    if args and args[0] == "k1":
        return k1_order()
    if args and args[0] == "k3":
        return k3_launch()
    if args and args[0] == "k4":
        return k4_wrapper()
    if args and args[0] == "cell":
        return cell(args[1], int(args[2]) if len(args) > 2 else 1)
    N = int(args[0]) if args else 10_000
    print(f"card: {cs.smi_line()}; N={N}", flush=True)
    x, y, xp = cs.dense_cell_data(N)
    hps = np.array([1.0, 1.5, 1.5, 1.5])
    gp = cs.dense_model(x, y, hps, "cuda")
    ml = gp.marginal_likelihood
    ml.log_likelihood_value_and_gradient(hps)
    gp.posterior_mean(xp)
    gp.posterior_covariance(xp, variance_only=True)
    window("3 x LML+grad", [
        lambda i=i: ml.log_likelihood_value_and_gradient(
            hps * (1 + 1e-4 * (i + 1))) for i in range(3)])
    window("commit + posterior mean + variance (500)", [lambda: (
        gp.set_hyperparameters(hps * 1.01), gp.posterior_mean(xp),
        gp.posterior_covariance(xp, variance_only=True))])
    return 0


def cell(name, seed):
    import torch

    from fvgp_tpu_torch.ops import hopper_kernels as hk
    from fvgp_tpu_torch.utils import trace as program
    from gpbench.harness import spans
    from gpbench.harness.inputs import Traffic, make_data
    from gpbench.harness.spec import Spec
    from gpbench.harness.system import System
    from gpbench.metrics.assembly_ms import is_assembly
    from gpbench.metrics.dense_linalg_ms import is_library
    spec = Spec()
    w = spec.workload(name)
    config = spec.config(w["config"])
    mix = spec.traffic(w["traffic"])
    op = spec.op(mix["op"])
    settings = spec.cell(name)
    if "host_threads" in settings:
        torch.set_num_threads(int(settings["host_threads"]))
    data = make_data(spec, config, seed)
    system = System(spec, config, data, "cuda", op)
    traffic = Traffic(mix, config, seed, op)
    for req in traffic.warmup():
        system.run(req)
    stream = iter(traffic)
    reqs = [next(stream) for _ in range(int(settings["traced"]))]
    counts = []

    def launch_counts():
        return dict(program.counters(), k1=hk.chunked_spmm.launches,
                    k2=hk.row_chunk_sums.launches)

    def counted(req):
        before = launch_counts()
        system.run(req)
        after = launch_counts()
        counts.append({k: v - before.get(k, 0) for k, v in after.items()})

    sp, launches, device = window(f"{name} (seed {seed})",
                                  [lambda r=r: counted(r) for r in reqs])
    print(f"  program counters per request: {counts}", flush=True)
    k2 = sum(c.get("k2", 0) for c in counts)
    if k2:
        print(f"  K2 launches on the float32 wgmma body: "
              f"{sum(c.get('k2_wgmma_launches', 0) for c in counts)} of {k2}",
              flush=True)
    # the benchmark's outside measures of the same window, per request and
    # by the span that launched their kernels
    for label, pick in (("assembly_ms", is_assembly),
                        ("dense_linalg_ms", is_library)):
        red = spans.reduce(sp, launches, [d for d in device if pick(d[0])])
        rows = {k: spans.totals(red, k)["device_ns"] / 1e6
                for k in {k for r in red["requests"] for k in r}}
        print(f"  {label} on the same window "
              f"{sum(rows.values()):.3f} per request: " + ", ".join(
                  f"{k} {v:.3f}" for k, v in sorted(
                      rows.items(), key=lambda kv: -kv[1]) if v > 0.0005),
              flush=True)

    req, index = next(stream), system.calls
    system.calls += 1
    before = program.counters().get("host_syncs", 0)
    where = {}

    def note(message, category, filename, lineno, *rest):
        # the innermost frame of this repository that made the call
        if "synchroniz" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()[:-1]
                if "fvgp_tpu_torch" in f.filename or "gpbench" in f.filename
                or f.filename.endswith("chip_profile.py")]
        frame = ours[-1] if ours else None
        key = (f"{frame.filename.split('/repo/')[-1]}:{frame.lineno}"
               if frame else f"{filename}:{lineno}")
        where[key] = where.get(key, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            op.call(system.model, req, index)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = program.counters().get("host_syncs", 0) - before
    print(f"  one request under set_sync_debug_mode('warn'): "
          f"{sum(where.values())} synchronising calls, host_syncs {syncs}",
          flush=True)
    for key, n in sorted(where.items(), key=lambda kv: -kv[1]):
        print(f"    {n:4d}  {key}", flush=True)
    return 0


def gp2scale(N):
    import torch

    import chip_smoke as cs
    print(f"card: {cs.smi_line()}; gp2Scale N={N}", flush=True)
    x, y, xp = cs.journey_data(N)
    hps = np.array([1.0, 2.0, 2.0, 2.0])
    gp = cs.journey_model(x, y, hps)
    ml = gp.marginal_likelihood
    ml.log_likelihood_value_and_gradient(hps)
    gp.posterior_mean(xp)
    gp.posterior_covariance(xp, variance_only=True)
    windows = (("LML+grad", lambda: ml.log_likelihood_value_and_gradient(
                   hps * (1 + 1e-4))),
               ("commit + posterior mean (500)", lambda: (
                   gp.set_hyperparameters(hps * 1.01),
                   gp.posterior_mean(xp))),
               ("posterior variance (500)", lambda: gp.posterior_covariance(
                   xp, variance_only=True)))
    for label, fn in windows:
        window(label, [fn])
    return 0


def call_breakdown(label, fn):
    """One call of ``fn`` under the profiler: its device kernels and copies
    in the order of their size, the host's CUDA runtime calls, and the
    host's time for the call (to the return, and to the device's end)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for _ in range(3):          # a trace now and then comes back empty
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        avgs = prof.key_averages()
        dev = sorted((e for e in avgs if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.self_device_time_total, reverse=True)
        if dev:
            break
    host = [e for e in avgs if e.device_type == DeviceType.CPU
            and e.key.startswith("cuda")]
    print(f"{label}: host {1e3 * (t1 - t0):.4f} ms to return, "
          f"{1e3 * (t2 - t0):.4f} ms to the device's end; device "
          f"{sum(e.self_device_time_total for e in dev) / 1e3:.4f} ms in "
          f"{sum(e.count for e in dev)} launches and copies", flush=True)
    for e in dev:
        print(f"  device {e.self_device_time_total / 1e3:8.4f} ms  "
              f"x{e.count:<3d} {e.key[:84]}", flush=True)
    print("  host runtime calls: " + ", ".join(
        f"{e.key} x{e.count}" for e in host), flush=True)


def k4_wrapper():
    import torch

    import chip_smoke as cs
    from fvgp_tpu_torch.ops import hopper_kernels as hk
    print(f"card: {cs.smi_line()}; K4 wrapper", flush=True)
    hk._kernels()
    gen = torch.Generator().manual_seed(3)
    hps = np.array([1.0, 1.0, 1.0, 1.0])
    N, B, k = 50_000, 256, 17
    x, nb, rows, cols = cs.bench_structure(N, B, hps)
    X = torch.randn((N, k), generator=gen).cuda()
    for tdt in (torch.float32, torch.bfloat16):
        t, r, c = cs.assemble(x, nb, B, rows, cols, hps, tdt, torch.float32,
                              "cuda")
        for shape, Xk in (("2-D X", X.to(tdt)),
                          ("1-D X", X[:, 0].contiguous().to(tdt))):
            label = f"K4 block_spmv [{str(tdt)[6:]}, {shape}, n={N}]"
            call_breakdown(label, lambda: hk.block_spmv(r, c, t, Xk, nb, B))
            X2 = Xk[:, None] if Xk.dim() == 1 else Xk
            Xp = hk._pad_cols("k4", X2)
            row_ptr, order = hk._row_segments("k4", r, nb)
            out = torch.empty_like(X2)

            def bare():
                err = hk._kernels().fvgp_block_spmv(
                    hk._ptr(t), hk._ptr(Xp), hk._ptr(row_ptr),
                    hk._ptr(order), hk._ptr(c), hk._ptr(out), nb, B,
                    X2.shape[1], Xp.shape[1], N, N,
                    hk._KERNEL_DTYPES[tdt], hk._stream(Xp))
                if err:
                    raise RuntimeError(f"K4 launch failed: {err}")
            ms = {"wrapper": [], "bare": []}
            for _ in range(3):
                for name in ("wrapper", "bare", "bare", "wrapper"):
                    fn = bare if name == "bare" else \
                        (lambda: hk.block_spmv(r, c, t, Xk, nb, B))
                    ms[name].append(cs.cuda_ms(fn, reps=20))
            print(f"{label}: event-timed " + "; ".join(
                f"{k} median {np.median(v):.4f} ms ({len(v)} x 20)"
                for k, v in ms.items()), flush=True)
    return 0


def k3_launch():
    import torch

    import chip_smoke as cs
    from fvgp_tpu_torch.ops import hopper_kernels as hk
    print(f"card: {cs.smi_line()}; K3 launch, routes and store variants",
          flush=True)
    lib = hk._kernels()
    x, _, xp = cs.dense_cell_data(10_000)
    sym, vec, hint = (hk._COV_SYMMETRIC, hk._COV_VECTOR_STORES,
                      hk._COV_STREAMING)

    def time_variants(label, a, b, hps, kind, variants):
        """``variants``: name -> launch flags, or None for the wrapper; each
        timed 6 x 20 launches, in turns."""
        out = torch.empty((len(a), len(b)), dtype=a.dtype, device="cuda")

        def bare(flags):
            err = lib.fvgp_dense_covariance(
                hk._ptr(a), hk._ptr(b), hk._ptr(hps), hk._ptr(out), len(a),
                len(b), a.shape[1], hk._COV_KINDS[kind],
                hk._COV_DTYPES[a.dtype], flags, hk._stream(a))
            if err:
                raise RuntimeError(f"K3 launch failed: {err}")
        ms = {name: [] for name in variants}
        names = list(variants)
        for _ in range(3):
            for name in names + names[::-1]:
                fn = (lambda: hk.dense_covariance(a, b, hps, kind=kind)) \
                    if variants[name] is None else \
                    (lambda f=variants[name]: bare(f))
                ms[name].append(cs.cuda_ms(fn, reps=20))
        bound_ms = out.numel() * out.element_size() / cs.HBM_BYTES_PER_S * 1e3
        print(f"K3 [{kind}, {str(a.dtype)[6:]}, D={a.shape[1]}, {label}] "
              f"(output bytes over the memory rate {bound_ms:.4f} ms): "
              + "; ".join(f"{k} median {np.median(v):.4f} ms"
                          for k, v in ms.items()) + " (6 x 20 each)",
              flush=True)

    routes = {"wrapper": None, "symmetric route": sym | vec | hint,
              "full route": vec | hint}
    for dt in (torch.float32, torch.float64):
        X = torch.as_tensor(x, dtype=dt).cuda()
        XP = torch.as_tensor(xp, dtype=dt).cuda()
        hps = torch.as_tensor([1.0, 1.5, 1.5, 1.5], dtype=dt).cuda()
        # the journey's shapes: which route k(X, X) should take, the store
        # variants of the full route, and the small shapes' launch
        time_variants("N x N, x2 is x1", X, X, hps, "matern32", routes)
        time_variants("N x N, x2 is x1", X, X, hps, "wendland", routes)
        time_variants("N x N, two tensors", X, X.clone(), hps, "matern32",
                      {"wrapper": None, "16-byte stores + hint": vec | hint,
                       "16-byte stores": vec, "scalar stores": 0,
                       "scalar stores + hint": hint})
        time_variants("N x 500", X, XP, hps, "matern32",
                      {"wrapper": None, "bare": vec | hint})
        time_variants("500 x 500, x2 is x1", XP, XP, hps, "matern32", routes)
        call_breakdown(f"K3 dense_covariance [{str(dt)[6:]}, N x 500]",
                       lambda: hk.dense_covariance(X, XP, hps))
        # the route rule's other side: the run-time-D instance
        gen = torch.Generator().manual_seed(5)
        for D in (8, 32):
            XD = (4.0 * torch.rand((10_000, D), generator=gen)).to(dt).cuda()
            hD = torch.cat([torch.ones(1), 1.0 + 2.0 * torch.rand(
                D, generator=gen)]).to(dt).cuda()
            time_variants("N x N, x2 is x1", XD, XD, hD, "matern32", routes)
    return 0


def stored(N):
    import torch

    import chip_smoke as cs
    print(f"card: {cs.smi_line()}; stored-K gp2Scale N={N}", flush=True)
    gp, _, _, _, hps = cs.stored_journey_model(N)
    gp.log_likelihood(hps * 1.001)            # builds the kernels, warms up
    KV = gp.kv.addKV(gp.K, gp.V)
    ym = gp.kv._y_minus(gp.m)
    torch.cuda.synchronize()

    def assemble():
        gp.prior.K = None
        return gp.K

    windows = (("assemble gp.K", assemble),
               ("trial log_likelihood(hps)",
                lambda: gp.log_likelihood(hps * 1.002)),
               ("preconditioned CG on the committed K+V",
                lambda: gp.kv._solve_with("sparseCGpre", KV, ym)),
               ("SLQ logdet on the committed K+V",
                lambda: gp.kv._random_logdet(KV)))
    for label, fn in windows:
        window(label, [fn])
    print(f"CG iterations {gp.kv.last_solve_info['iterations']}, SLQ probes "
          f"{gp.kv.last_logdet_info['num_samples']}", flush=True)
    return 0


def slq(N):
    import torch

    import chip_smoke as cs
    print(f"card: {cs.smi_line()}; SLQ solver, gp2Scale N={N}", flush=True)
    x, y, xp = cs.journey_data(N)
    hps = np.array([1.0, 2.0, 2.0, 2.0])
    gp = cs.journey_model(x, y, hps)
    ml = gp.marginal_likelihood
    base = dict(gp.args)
    # every variant builds its own program, whose first draw is seed 42:
    # all of them see the same probes
    variants = (("mBCG", {}),
                ("mBCG, sparse_cg_tol 1e-3, 200 trips",
                 {"sparse_cg_tol": 1e-3, "sparse_cg_maxiter": 200}),
                ("SLQ, degree 20", {"gp2Scale_solver": "slq"}),
                ("SLQ, degree 40", {"gp2Scale_solver": "slq",
                                    "random_logdet_lanczos_degree": 40}),
                ("SLQ, float32 streaming", {"gp2Scale_solver": "slq",
                                            "gp2Scale_solver_dtype": None}))
    # the smoke's trained hyperparameters (train(method="local", 2 steps))
    points = (("configuration", hps),
              ("training path", np.array([0.1991, 2.4739, 2.4739, 2.4739])))
    for label, h in points:
        for name, extra in variants:
            gp.args.clear()
            gp.args.update(base, **extra)
            torch.cuda.synchronize()
            t0 = time.time()
            val = gp.log_likelihood(h)
            torch.cuda.synchronize()
            print(f"{label} {h}: {name}: lml {val:.4f}, variance "
                  f"{ml.log_likelihood_variance():.4e}, "
                  f"{time.time() - t0:.3f} s", flush=True)
    gp.args.clear()
    gp.args.update(base, gp2Scale_solver="slq")
    ml.log_likelihood_value_and_gradient(hps)
    for precond in ("two_level", "block_jacobi"):
        gp.args["gp2Scale_posterior_precond"] = precond
        gp.posterior_covariance(xp, variance_only=True)

    def variance(precond, scale):
        gp.args["gp2Scale_posterior_precond"] = precond
        gp.set_hyperparameters(hps * scale)
        gp.posterior_covariance(xp, variance_only=True)

    windows = (("SLQ LML+grad", lambda: ml.log_likelihood_value_and_gradient(
                   hps * (1 + 1e-4))),
               ("commit + two-level variance (500)",
                lambda: variance("two_level", 1.01)),
               ("commit + block-Jacobi variance (500)",
                lambda: variance("block_jacobi", 1.02)))
    for label, fn in windows:
        window(label, [fn], top=14)
        if "variance" in label:
            print(f"  CG iterations {gp.kv.last_solve_info['iterations']}",
                  flush=True)
    return 0


def k1_order():
    import torch

    import chip_smoke as cs
    from fvgp_tpu_torch.ops import hopper_kernels as hk
    print(f"card: {cs.smi_line()}; K1 launch order", flush=True)
    lib = hk._kernels()
    gen = torch.Generator().manual_seed(3)
    hps = np.array([1.0, 1.0, 1.0, 1.0])
    x, nb, rows, cols = cs.bench_structure(50_000, 256, hps)
    cases = []
    for tdt in (torch.float32, torch.bfloat16):
        t, r, c = cs.assemble(x, nb, 256, rows, cols, hps, tdt,
                              torch.float32, "cuda")
        cases.append((f"N=50k {str(tdt)[6:]}", t, r, c, nb, 256))
    hps1 = np.array([1.0, 2.0, 2.0, 2.0])
    x, nb1, rows, cols = cs.bench_structure(1_000_000, 128, hps1, seed=1)
    t, r, c = cs.assemble(x, nb1, 128, rows, cols, hps1, torch.bfloat16,
                          torch.float32, "cuda")
    cases.append(("N=1M bfloat16", t, r, c, nb1, 128))
    for label, t, r, c, nb_, B in cases:
        cc = c.clamp(max=nb_ - 1)
        X = torch.randn((nb_ * B, 17), generator=gen).cuda()
        Xp = torch.nn.functional.pad(X.to(t.dtype), (0, 7))
        row_ptr, order = hk._row_segments("k1", r, nb_)
        c32 = cc.to(torch.int32).contiguous()
        out = torch.empty((nb_ * B, 17), dtype=torch.float32, device="cuda")

        def bare(ordered):
            err = lib.fvgp_chunked_spmm(
                hk._ptr(t), hk._ptr(Xp), hk._ptr(row_ptr),
                hk._ptr(order) if ordered else None, hk._ptr(c32),
                hk._ptr(out), nb_, nb_, B, 17, 24, hk._KERNEL_DTYPES[t.dtype],
                hk._stream(Xp))
            if err:
                raise RuntimeError(f"K1 launch failed: {err}")
        mvd = None if t.dtype == torch.float32 else t.dtype
        ms = {"ordered": [], "row-major": [], "wrapper": []}
        for _ in range(3):
            for name in ("ordered", "row-major", "wrapper", "wrapper",
                         "row-major", "ordered"):
                fn = (lambda: hk.chunked_spmm(r, cc, t, X, nb_, B,
                                              mv_dtype=mvd)) \
                    if name == "wrapper" else \
                    (lambda o=(name == "ordered"): bare(o))
                ms[name].append(cs.cuda_ms(fn, reps=20))
        print(f"{label}: " + "; ".join(
            f"{k} median {np.median(v):.4f} ms ({len(v)} runs)"
            for k, v in ms.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
