#!/usr/bin/env python3
"""Where a journey's time goes on one CUDA card.

Run from the root of the repository:

    python3 chip_profile.py [N]             # the dense journey
    python3 chip_profile.py gp2scale [N]    # the gp2Scale journey
    python3 chip_profile.py k1              # K1's launch order and wrapper

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

For each window it prints the wall time, the device time summed over
kernels, the device's idle share (1 − device time / wall time) and the ten
largest device-time entries by name.  The profiler stretches wall time, so
the device totals are the comparable numbers.

k1: at the smoke's N = 50k training structure (float32 and bfloat16
tiles), bare launches of K1 with the longest-rows-first order and without
one (row-major), in turns, beside the wrapper ``chunked_spmm``; the same at
the N = 1M journey's shape, where the launcher drops the order (the grid
is ~30 waves), so both bare launches run row-major.  Exits non-zero without a
card.
"""

import sys
import time
import warnings

import numpy as np


def device_table(prof, wall_s, label, top=10):
    """Device kernels only: the aten operators that launch them carry the
    same time again and are left out of the sum."""
    from torch.autograd import DeviceType
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    total_ms = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"{label}: wall {wall_s * 1e3:.1f} ms, device {total_ms:.1f} ms, "
          f"idle share {max(0.0, 1 - total_ms / (wall_s * 1e3)):.3f}",
          flush=True)
    for e in rows[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}", flush=True)


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

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
    if args and args[0] == "k1":
        return k1_order()
    N = int(args[0]) if args else 10_000
    print(f"card: {cs.smi_line()}; N={N}", flush=True)
    x, y, xp = cs.dense_cell_data(N)
    hps = np.array([1.0, 1.5, 1.5, 1.5])
    gp = cs.dense_model(x, y, hps, "cuda")
    ml = gp.marginal_likelihood
    ml.log_likelihood_value_and_gradient(hps)
    gp.posterior_mean(xp)
    gp.posterior_covariance(xp, variance_only=True)
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.time()
        for i in range(3):
            ml.log_likelihood_value_and_gradient(hps * (1 + 1e-4 * (i + 1)))
        torch.cuda.synchronize()
        wall = time.time() - t0
    device_table(prof, wall, "3 x LML+grad")
    with profile(activities=acts) as prof:
        t0 = time.time()
        gp.set_hyperparameters(hps * 1.01)
        gp.posterior_mean(xp)
        gp.posterior_covariance(xp, variance_only=True)
        torch.cuda.synchronize()
        wall = time.time() - t0
    device_table(prof, wall, "commit + posterior mean + variance (500)")
    return 0


def gp2scale(N):
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    print(f"card: {cs.smi_line()}; gp2Scale N={N}", flush=True)
    x, y, xp = cs.journey_data(N)
    hps = np.array([1.0, 2.0, 2.0, 2.0])
    gp = cs.journey_model(x, y, hps)
    ml = gp.marginal_likelihood
    ml.log_likelihood_value_and_gradient(hps)
    gp.posterior_mean(xp)
    gp.posterior_covariance(xp, variance_only=True)
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    windows = (("LML+grad", lambda: ml.log_likelihood_value_and_gradient(
                   hps * (1 + 1e-4))),
               ("commit + posterior mean (500)", lambda: (
                   gp.set_hyperparameters(hps * 1.01),
                   gp.posterior_mean(xp))),
               ("posterior variance (500)", lambda: gp.posterior_covariance(
                   xp, variance_only=True)))
    for label, fn in windows:
        with profile(activities=acts) as prof:
            t0 = time.time()
            fn()
            torch.cuda.synchronize()
            wall = time.time() - t0
        device_table(prof, wall, label)
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
                hk._ptr(out), nb_, B, 17, 24, hk._KERNEL_DTYPES[t.dtype],
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
