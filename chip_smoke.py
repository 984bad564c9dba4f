#!/usr/bin/env python3
"""Chip smoke for fvgp_tpu_torch: the gp2Scale journey on one CUDA card.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises, so the script exits non-zero and the final
line is never printed):

1. the card's name and power limit (nvidia-smi); TF32 off;
2. build the Hopper kernels (nvcc) and the native host runtime (g++);
3. kernel phase: K1 ``chunked_spmm`` at the N=50k training structure
   (B=256, k=17, bfloat16 and float32 tiles from the real assembly) and K2
   ``row_chunk_sums`` at committed-solver shapes (B=128, C=8, c=128), each
   against its plain PyTorch version, with errors and times;
4. cross-check: the public journey at N=10,000 on CUDA (float32, and
   float32 with bfloat16 tile streaming) against the CPU in float64, with
   the same probes;
5. the journey at full size through the public GP: N=1,000,000, D=3,
   bfloat16 solver, 16 probes — construction, LML+gradient (1 + 3 timed),
   train(method="local", max_iter=2), posterior_mean and
   posterior_covariance(variance_only=True) on 500 points — with the
   kernels' launch counters reset before it and read after it.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA device.
"""

import json
import subprocess
import sys
import time
import warnings

import numpy as np

K1_SOURCE = "fvgp_tpu_torch/csrc/hopper_kernels.cu"
K1_REPLACES = "fvgp_tpu/ops/pallas_kernels.py:180"
K2_REPLACES = "fvgp_tpu/ops/pallas_kernels.py:354"
# kernel vs plain version: both read identical (bf16-rounded) inputs and
# accumulate in float32, only in another order — 1e-4 of the output scale
KERNEL_RTOL = 1e-4
# journey on CUDA vs the CPU in float64, same probes (relative for the LML,
# relative 2-norm for the gradient, absolute for posteriors of O(1) scale)
BOUNDS = {"float32": {"lml": 1e-4, "grad": 1e-3, "mean": 1e-3, "var": 1e-3},
          "bfloat16": {"lml": 5e-3, "grad": 5e-2, "mean": 5e-2, "var": 5e-2}}


def log(msg):
    print(msg, flush=True)


def smi_line():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    except FileNotFoundError:
        out = ""
    return out.splitlines()[0] if out else "nvidia-smi unavailable"


def cuda_ms(fn, reps=10, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bench_structure(N, B, hps, seed=0):
    """The bench's training structure (bench.py:356-383): ~40 support
    neighbours per point, Morton order, box prune + exact liveness, rows
    mirrored, row-sorted, sentinels at the tail of a bucket-padded list."""
    from fvgp_tpu_torch.native import tile_live
    from fvgp_tpu_torch.parallel.ordering import morton_order
    from fvgp_tpu_torch.parallel.sharded_cov import _bucket, _candidate_pairs
    rng = np.random.default_rng(seed)
    span = (N * 4.19 / 40.0) ** (1.0 / 3.0) * hps[1]
    x = rng.uniform(0, span, (N, 3))
    x = x[morton_order(x)]
    rows, cols = _candidate_pairs(x, None, hps[1:], 1.0, B, symmetric=True)
    off = rows < cols
    rows_f = np.concatenate([rows, cols[off]]).astype(np.int32)
    cols_f = np.concatenate([cols, rows[off]]).astype(np.int32)
    keep = tile_live(x / hps[1:], rows_f, cols_f, B, 1.0)
    rows_f, cols_f = rows_f[keep], cols_f[keep]
    order = np.argsort(rows_f, kind="stable")
    nb = -(-N // B)
    T_pad = _bucket(len(rows_f))
    rows_p = np.full(T_pad, nb, np.int32)
    cols_p = np.full(T_pad, nb, np.int32)
    rows_p[:len(rows_f)] = rows_f[order]
    cols_p[:len(cols_f)] = cols_f[order]
    return x, nb, rows_p, cols_p


def assemble(x, nb, B, rows, cols, hps, tile_dtype, dtype, device):
    """Tiles from the port's own chunked assembly."""
    import torch

    from fvgp_tpu_torch.kernels import wendland_anisotropic
    from fvgp_tpu_torch.ops.sparse_lml import (_assemble_chunked_tiles,
                                               make_padded_inputs)
    xb, mask, _, _, _ = make_padded_inputs(x, np.zeros(len(x)),
                                           np.ones(len(x)), B, dtype=dtype,
                                           device=device)
    r = torch.as_tensor(rows).to(device)
    c = torch.as_tensor(cols).to(device)
    live = (r < nb) & (c < nb)
    h = torch.as_tensor(hps, dtype=dtype).to(device)
    with torch.no_grad():
        tiles = _assemble_chunked_tiles(
            wendland_anisotropic, B, tile_dtype, h, r.clamp(max=nb - 1),
            c.clamp(max=nb - 1), live, xb, mask)
    return tiles, r, c


def kernel_phase(device):
    import torch

    from fvgp_tpu_torch.ops import hopper_kernels as hk
    records = {}
    hps = np.array([1.0, 1.0, 1.0, 1.0])
    # ---- K1 at the N=50k training structure --------------------------
    N, B, k = 50_000, 256, 17
    x, nb, rows_p, cols_p = bench_structure(N, B, hps)
    log(f"K1 structure: N={N} B={B} nb={nb} T={len(rows_p)} "
        f"(live {int((rows_p < nb).sum())})")
    gen = torch.Generator().manual_seed(3)
    X = torch.randn((nb * B, k), generator=gen,
                    dtype=torch.float32).to(device)
    for name, tdt in (("float32", torch.float32),
                      ("bfloat16", torch.bfloat16)):
        tiles, r, c = assemble(x, nb, B, rows_p, cols_p, hps, tdt,
                               torch.float32, device)
        cc = c.clamp(max=nb - 1)      # the training path's operands
        mvd = None if tdt == torch.float32 else tdt
        got = hk.chunked_spmm(r, cc, tiles, X, nb, B, mv_dtype=mvd)
        ref = hk.chunked_spmm_reference(r, cc, tiles, X, nb, B,
                                        mv_dtype=mvd)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        tol = KERNEL_RTOL * scale
        ms = cuda_ms(lambda: hk.chunked_spmm(r, cc, tiles, X, nb, B,
                                             mv_dtype=mvd))
        plain_ms = cuda_ms(lambda: hk.chunked_spmm_reference(
            r, cc, tiles, X, nb, B, mv_dtype=mvd))
        log(f"K1 chunked_spmm [{name} tiles, B={B}, k={k}, T={len(rows_p)}]"
            f": max_abs_err {err:.3e} (tol {tol:.3e} = {KERNEL_RTOL:g} x "
            f"max|ref| {scale:.3e}); kernel {ms:.4f} ms, plain {plain_ms:.4f}"
            f" ms")
        if not (err <= tol):
            raise AssertionError(f"K1 ({name}) disagrees with its plain "
                                 f"version: {err} > {tol}")
        if name == "bfloat16":     # the path's dtype
            records["chunked_spmm"] = {"max_abs_err": err, "ms": ms,
                                       "plain_ms": plain_ms}
        del tiles
    # ---- K2 at committed-solver shapes --------------------------------
    B, C, c_w = 128, 8, 128
    hps2 = np.array([1.0, 2.0, 2.0, 2.0])
    x, nb, rows_p, cols_p = bench_structure(N, B, hps2, seed=1)
    live = rows_p < nb
    rows_a, cols_a, rowsc, n_chunks = hk.row_aligned_schedule(
        rows_p[live], cols_p[live], nb, C=C)
    tiles, r, cc = assemble(x, nb, B, rows_a, cols_a, hps2, torch.bfloat16,
                            torch.float32, device)
    Xb = torch.randn((nb, B, c_w), generator=gen).to(torch.bfloat16) \
        .to(device)
    got = hk.row_chunk_sums(tiles, cc, Xb, B, C=C)
    ref = hk.row_chunk_sums_reference(tiles, cc, Xb, B, C=C)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    tol = KERNEL_RTOL * scale
    ms = cuda_ms(lambda: hk.row_chunk_sums(tiles, cc, Xb, B, C=C))
    plain_ms = cuda_ms(lambda: hk.row_chunk_sums_reference(tiles, cc, Xb, B,
                                                           C=C))
    log(f"K2 row_chunk_sums [bfloat16, B={B}, C={C}, c={c_w}, "
        f"n_chunks={n_chunks}]: max_abs_err {err:.3e} (tol {tol:.3e}); "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    if not (err <= tol):
        raise AssertionError(f"K2 disagrees with its plain version: "
                             f"{err} > {tol}")
    records["row_chunk_sums"] = {"max_abs_err": err, "ms": ms,
                                 "plain_ms": plain_ms}
    return records


def journey_data(N, seed=1):
    """The bench's large-N data (bench.py:73-77): ~40 support neighbours
    at lengthscale 2."""
    rng = np.random.default_rng(seed)
    span = (N * 4.19 * 2.0 ** 3 / 40.0) ** (1.0 / 3.0)
    x = rng.uniform(0, span, (N, 3))
    y = np.sin(0.2 * x[:, 0]) + 0.05 * rng.standard_normal(N)
    xp = rng.uniform(0, span, (500, 3))
    return x, y, xp


def run_journey(x, y, xp, hps, device, args):
    """LML+grad, posterior mean and variance through the public GP."""
    from fvgp_tpu_torch import GP
    gp = GP(x, y, init_hyperparameters=hps,
            noise_variances=np.full(len(x), 1e-2), gp2Scale=True,
            compute_device=device, linalg_mode="sparseCGpre", args=args)
    val, grad = gp.marginal_likelihood.log_likelihood_value_and_gradient(hps)
    mean = gp.posterior_mean(xp)["m(x)"]
    var = gp.posterior_covariance(xp, variance_only=True)["v(x)"]
    return val, grad, mean, var


def cross_check():
    N = 10_000
    x, y, xp = journey_data(N, seed=2)
    xp = xp[:64]
    hps = np.array([1.0, 2.0, 2.0, 2.0])
    base = {"gp2Scale_block_size": 128, "sparse_cg_maxiter": 64,
            "random_logdet_fixed_probes": 16,
            "gp2Scale_structure_cache_dir": False}
    t0 = time.time()
    ref = run_journey(x, y, xp, hps, "cpu", dict(base))
    log(f"cross-check N={N}: CPU float64 journey {time.time() - t0:.2f} s, "
        f"lml {ref[0]:.6f}")
    for name, extra in (("float32", {}),
                        ("bfloat16", {"gp2Scale_solver_dtype": "bfloat16"})):
        t0 = time.time()
        got = run_journey(x, y, xp, hps, "cuda", {**base, **extra})
        errs = {"lml": abs(got[0] - ref[0]) / abs(ref[0]),
                "grad": float(np.linalg.norm(got[1] - ref[1])
                              / np.linalg.norm(ref[1])),
                "mean": float(np.abs(got[2] - ref[2]).max()),
                "var": float(np.abs(got[3] - ref[3]).max())}
        bounds = BOUNDS[name]
        log(f"cross-check N={N} CUDA {name} vs CPU float64 "
            f"({time.time() - t0:.2f} s): "
            + ", ".join(f"{k} {errs[k]:.3e} (bound {bounds[k]:g})"
                        for k in errs))
        bad = [k for k in errs if not errs[k] <= bounds[k]]
        if bad:
            raise AssertionError(f"cross-check {name} out of bounds: {bad}")


def full_journey(N):
    import torch

    from fvgp_tpu_torch import GP
    from fvgp_tpu_torch.ops import hopper_kernels as hk
    x, y, xp = journey_data(N)
    hps = np.array([1.0, 2.0, 2.0, 2.0])
    times = {}
    torch.cuda.reset_peak_memory_stats()
    hk.reset_launch_counts()
    t0 = time.time()
    gp = GP(x, y, init_hyperparameters=hps, noise_variances=np.full(N, 1e-2),
            gp2Scale=True, compute_device="cuda",
            args={"gp2Scale_block_size": 128,
                  "gp2Scale_solver_dtype": "bfloat16",
                  "gp2Scale_storage_dtype": "bfloat16",
                  "sparse_cg_maxiter": 32,
                  "random_logdet_fixed_probes": 16,
                  "gp2Scale_structure_cache_dir": False})
    times["construction_s"] = time.time() - t0
    ml = gp.marginal_likelihood
    t0 = time.time()
    val, grad = ml.log_likelihood_value_and_gradient(hps)
    torch.cuda.synchronize()
    times["first_lml_grad_s"] = time.time() - t0
    if not (np.isfinite(val) and np.all(np.isfinite(grad))):
        raise AssertionError(f"non-finite LML/grad: {val} {grad}")
    t0 = time.time()
    for i in range(3):
        val, grad = ml.log_likelihood_value_and_gradient(
            hps * (1.0 + 1e-4 * (i + 1)))
    torch.cuda.synchronize()
    times["lml_grad_s_per_eval"] = (time.time() - t0) / 3
    log(f"N={N}: lml {val:.4f}, grad {np.array2string(grad, precision=4)}")
    bounds = np.array([[0.1, 10.0]] + [[1.5, 2.5]] * 3)
    t0 = time.time()
    trained = gp.train(hyperparameter_bounds=bounds, method="local",
                       max_iter=2)
    torch.cuda.synchronize()
    times["train_local_2_s"] = time.time() - t0
    if not np.all(np.isfinite(trained)):
        raise AssertionError(f"non-finite trained hps {trained}")
    t0 = time.time()
    pm = gp.posterior_mean(xp)["m(x)"]
    torch.cuda.synchronize()
    times["posterior_mean_500_s"] = time.time() - t0
    t0 = time.time()
    pv = gp.posterior_covariance(xp, variance_only=True)["v(x)"]
    torch.cuda.synchronize()
    times["posterior_variance_500_s"] = time.time() - t0
    launches = {"chunked_spmm": hk.chunked_spmm.launches,
                "row_chunk_sums": hk.row_chunk_sums.launches}
    if not (pm.shape == (500,) and pv.shape == (500,)
            and np.all(np.isfinite(pm)) and np.all(np.isfinite(pv))
            and np.all(pv >= 0.0)):
        raise AssertionError("posterior mean/variance not finite or of the "
                             "wrong shape")
    log(f"N={N}: trained hps {np.array2string(trained, precision=4)}; "
        f"mean range [{pm.min():.4f}, {pm.max():.4f}], variance range "
        f"[{pv.min():.3e}, {pv.max():.3e}]; posterior CG iterations "
        f"{gp.kv.last_solve_info['iterations']}")
    log(f"N={N} phase times: " + json.dumps(
        {k: round(v, 4) for k, v in times.items()}))
    log(f"N={N} peak device memory: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"launches in this phase: {json.dumps(launches)}")
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"{name} never launched on the main path")
    return launches


def main():
    import torch
    smi = smi_line()
    log(f"card: {smi}")
    if not torch.cuda.is_available():
        log("torch.cuda.is_available() is False: this smoke needs a CUDA "
            "card")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    warnings.simplefilter("ignore")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    from fvgp_tpu_torch.native import backend
    from fvgp_tpu_torch.ops import hopper_kernels as hk
    secs, build_log = hk.build_kernels(verbose=True)
    log(f"Hopper kernels built in {secs:.2f} s (nvcc, sm_90a)")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    t0 = time.time()
    log(f"native host runtime: {backend()} ({time.time() - t0:.2f} s)")

    t0 = time.time()
    records = kernel_phase("cuda")
    log(f"kernel phase: {time.time() - t0:.1f} s")
    t0 = time.time()
    cross_check()
    log(f"cross-check phase: {time.time() - t0:.1f} s")
    t0 = time.time()
    launches = full_journey(1_000_000)
    log(f"full journey phase: {time.time() - t0:.1f} s")

    kernels = []
    for name, replaces in (("chunked_spmm", K1_REPLACES),
                           ("row_chunk_sums", K2_REPLACES)):
        kernels.append({"name": name, "route": "cuda", "source": K1_SOURCE,
                        "replaces": replaces, "launches": launches[name],
                        **records[name]})
    log(f"card: {smi}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
