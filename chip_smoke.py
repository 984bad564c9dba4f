#!/usr/bin/env python3
"""Chip smoke for fvgp_tpu_torch on one CUDA card: the gp2Scale journey
and the dense exact GP, with every hand-written kernel held against its
plain PyTorch version.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises, so the script exits non-zero and the final
line is never printed):

1. the card's name and power limit (nvidia-smi); TF32 off;
2. build the Hopper kernels (nvcc) and the native host runtime (g++), both
   started together;
3. kernel phase: K1 ``chunked_spmm`` and K4 ``block_spmv`` at the N=50k
   training structure (B=256, k=17, bfloat16 and float32 tiles from the
   real assembly), K1 again at the N=1M journey's structure (B=128, k=17,
   bfloat16: the shape of its launches on that path), K2 ``row_chunk_sums``
   at committed-solver shapes (B=128, C=8; c=128 in bfloat16 and float32,
   and the journey's widths c=8 and c=512 in bfloat16), and K3
   ``dense_covariance`` at the dense cell's shapes (N=10,000 x 10,000 on
   one tensor — as the journey calls it — and on two, 10,000 x 500 and
   500 x 500, D=3; Matérn-3/2 and Wendland; float32 and float64) — each against its plain PyTorch version, with errors, times,
   the bound and, where one exists, one library call's time; K4's launch
   path (the schedule kept on the caller's rows tensor, numpy rows, an X
   that needs no copy, ragged n, 1-D X) and K3 at the shapes that break a
   tiled body (ragged and unaligned n2, every D, the symmetric route
   against the full one bit for bit); then K4's own path, its ops entry
   point ``block_spmv`` as a user calls it (its only caller, as in the JAX
   package);
4. gp2Scale cross-check: the public journey at N=10,000 on CUDA (float32,
   and float32 with bfloat16 tile streaming) against the CPU in float64,
   with the same probes;
5. dense cross-check: the dense GP at N=2,000 on CUDA float32 against the
   CPU in float64 (LML, gradient, posterior mean and variance), then
   train(method="global", max_iter=2) and train(method="mcmc",
   max_iter=200) on the card;
6. the dense journey at the bench's dense cell through the public GP:
   N=10,000, D=3, linalg_mode="Chol", float32 — construction, LML+gradient
   (1 + 5 timed), train(method="local", max_iter=5), posterior_mean and
   posterior_covariance(variance_only=True) on 500 points, cold and warm;
7. the gp2Scale journey at full size through the public GP: N=1,000,000,
   D=3, bfloat16 solver, 16 probes — construction, LML+gradient (1 + 3
   timed), train(method="local", max_iter=2), posterior_mean and
   posterior_covariance(variance_only=True) on 500 points.

K4's entry point and phases 6 and 7 are the paths: every kernel's launch
counter is reset just before each and read just after it, and the
``launches`` of a kernel is its sum over the three.  The line before the
last is
``{"kernels": [...]}``; the last line is ``{"ok": true, "device": {...}}``.
Exits non-zero without a CUDA device.
"""

import json
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SOURCE = "fvgp_tpu_torch/csrc/hopper_kernels.cu"
REPLACES = {"chunked_spmm": "fvgp_tpu/ops/pallas_kernels.py:180",
            "row_chunk_sums": "fvgp_tpu/ops/pallas_kernels.py:354",
            "dense_covariance": "fvgp_tpu/ops/pallas_kernels.py:437",
            "block_spmv": "fvgp_tpu/ops/pallas_kernels.py:84"}
# kernel vs plain version: both read identical (bf16-rounded) inputs and
# accumulate in float32, only in another order — 1e-4 of the output scale
KERNEL_RTOL = 1e-4
# K4 writes bfloat16: the two float32 sums may round to neighbouring
# bfloat16 values (one ulp is 2^-8 relative) — 1e-2 of the output scale
K4_BF16_RTOL = 1e-2
# K3: the same exact differences in the same order; expf/exp and sqrt
# differ from torch's by a few ulp — of the output scale (the signal
# variance), 1e-5 in float32 and 1e-12 in float64
K3_RTOL = {"float32": 1e-5, "float64": 1e-12}
# published dense peaks of one H100 SXM (NVIDIA data sheet): tensor-core
# bf16 and TF32, float32 outside the tensor cores, float64 outside the
# tensor cores; HBM3 bandwidth.  The float32 SpMMs do three TF32 products
# for each float32 product (the 3xTF32 split), counted as such.
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12,
              "float64": 34e12}
HBM_BYTES_PER_S = 3.35e12
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


def bound(n_bytes, n_ops, dtype):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the peak rate of their type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def record(err, ms, plain_ms, n_bytes, n_ops, dtype, library_ms):
    bound_ms, bound_by = bound(n_bytes, n_ops, dtype)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def spmm_record(err, ms, plain_ms, n_bytes, n_products, dtype, library_ms):
    """A block-sparse SpMM's record: bfloat16 products run on the bf16
    tensor cores, float32 ones as three TF32 products each."""
    if dtype == "float32":
        return record(err, ms, plain_ms, n_bytes, 3 * n_products, "tf32",
                      library_ms)
    return record(err, ms, plain_ms, n_bytes, n_products, dtype, library_ms)


def share(rec):
    return (f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), "
            f"{100.0 * rec['bound_ms'] / rec['ms']:.1f}% of it")


def ptxas_summary(build_log):
    """One line per kernel of nvcc's ``-Xptxas -v`` report: the kernel's
    name with its mangled template arguments, registers and spills."""
    import re
    out, name = [], None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '\w*?((?:segment_mma|"
                      r"chunk_sums_wgmma|dense_cov)_kernelI\w*?E)Ev", line)
        if m:
            name = m.group(1)
        elif name and "spill" in line:
            spill = line.strip()
        elif name and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{name}: {regs} registers; {spill}")
            name = None
    return out


def launch_counts():
    """Every kernel's launch counter, read now."""
    from fvgp_tpu_torch.ops import hopper_kernels as hk
    return {name: getattr(hk, name).launches for name in REPLACES}


def bsr_library_ms(rows, cols, tiles, X, nb, B):
    """Time of one ``torch.sparse.mm`` of a ``sparse_bsr_tensor`` built
    once (build excluded) from the live tiles — the library call that
    computes K1's and K4's product — or None where the library refuses the
    dtype.  Timed here only; the port never calls it."""
    import torch
    live = (rows < nb) & (cols < nb)
    r, c, t = rows[live], cols[live], tiles[live]
    order = torch.argsort(r.long() * (nb + 1) + c.long())
    r, c, t = r[order], c[order], t[order]
    crow = torch.searchsorted(r, torch.arange(nb + 1, device=r.device,
                                              dtype=r.dtype))
    try:
        A = torch.sparse_bsr_tensor(crow.to(torch.int64), c.to(torch.int64),
                                    t.contiguous(), size=(nb * B, nb * B))
        Xc = X.to(t.dtype)
        torch.sparse.mm(A, Xc)
        torch.cuda.synchronize()
        return cuda_ms(lambda: torch.sparse.mm(A, Xc))
    except (RuntimeError, NotImplementedError) as exc:
        log(f"  library torch.sparse.mm (BSR, {t.dtype}) refused: "
            f"{str(exc).splitlines()[0][:160]}")
        return None


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


def k1_case(label, r, c, tiles, X, nb, B, mvd):
    """K1 against its plain version on the training path's operands
    (clamped columns), timed beside the plain version and the BSR library
    call; returns the record (bound from the live tiles, X and the float32
    output, each once)."""
    from fvgp_tpu_torch.ops import hopper_kernels as hk
    cc = c.clamp(max=nb - 1)
    got = hk.chunked_spmm(r, cc, tiles, X, nb, B, mv_dtype=mvd)
    ref = hk.chunked_spmm_reference(r, cc, tiles, X, nb, B, mv_dtype=mvd)
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    tol = KERNEL_RTOL * scale
    del got, ref
    ms = cuda_ms(lambda: hk.chunked_spmm(r, cc, tiles, X, nb, B,
                                         mv_dtype=mvd))
    plain_ms = cuda_ms(lambda: hk.chunked_spmm_reference(
        r, cc, tiles, X, nb, B, mv_dtype=mvd), reps=3)
    lib_ms = bsr_library_ms(r, c, tiles, X, nb, B)
    live = int(((r < nb) & (c < nb)).sum())
    k = X.shape[1]
    rec = spmm_record(err, ms, plain_ms,
                      live * B * B * tiles.element_size()
                      + 2 * nb * B * k * 4 + 8 * live,
                      2 * live * B * B * k, str(tiles.dtype)[6:], lib_ms)
    log(f"K1 chunked_spmm [{label}, B={B}, k={k}, T={len(r)}, live {live}]:"
        f" max_abs_err {err:.3e} (tol {tol:.3e} = {KERNEL_RTOL:g} x "
        f"max|ref| {scale:.3e}); kernel {ms:.4f} ms, plain {plain_ms:.4f}"
        f" ms, library {lib_ms} ms; {share(rec)}")
    if not (err <= tol):
        raise AssertionError(f"K1 ({label}) disagrees with its plain "
                             f"version: {err} > {tol}")
    return rec


def k2_case(label, tiles, cc, Xb, B, C, n_chunks, nb):
    """K2 against its plain version, timed beside the plain version and
    the library yardstick: one ``torch.einsum('ncij,ncjk->nik')`` over the
    tiles and the X blocks gathered through cols beforehand (the gather
    excluded, as the BSR build is for K1; cuBLAS writes the input dtype).
    Bound: live tiles, cols, X and the float32 output, each once."""
    import torch

    from fvgp_tpu_torch.ops import hopper_kernels as hk
    c_w = Xb.shape[2]
    got = hk.row_chunk_sums(tiles, cc, Xb, B, C=C)
    ref = hk.row_chunk_sums_reference(tiles, cc, Xb, B, C=C)
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    tol = KERNEL_RTOL * scale
    del got
    ms = cuda_ms(lambda: hk.row_chunk_sums(tiles, cc, Xb, B, C=C))
    plain_ms = cuda_ms(lambda: hk.row_chunk_sums_reference(tiles, cc, Xb, B,
                                                           C=C), reps=3)
    Xg = Xb[cc.long().clamp(max=nb - 1)].view(n_chunks, C, B, c_w)
    tv = tiles.view(n_chunks, C, B, B)
    lib = torch.einsum("ncij,ncjk->nik", tv, Xg)
    lib_err = float((lib.float() - ref).abs().max())
    del lib, ref
    lib_ms = cuda_ms(lambda: torch.einsum("ncij,ncjk->nik", tv, Xg))
    del Xg
    live = int((cc < nb).sum())
    item = tiles.element_size()
    rec = spmm_record(err, ms, plain_ms,
                      live * B * B * item + 4 * len(cc) + nb * B * c_w * item
                      + n_chunks * B * c_w * 4, 2 * live * B * B * c_w,
                      str(tiles.dtype)[6:], lib_ms)
    log(f"K2 row_chunk_sums [{label}, B={B}, C={C}, c={c_w}, n_chunks="
        f"{n_chunks}]: max_abs_err {err:.3e} (tol {tol:.3e}); kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms "
        f"(einsum over gathered X, max_abs_err {lib_err:.3e}); {share(rec)}")
    if not (err <= tol):
        raise AssertionError(f"K2 ({label}) disagrees with its plain "
                             f"version: {err} > {tol}")
    if not (lib_err <= K4_BF16_RTOL * scale):
        raise AssertionError(f"the K2 library yardstick ({label}) computes "
                             f"another function: {lib_err}")
    return rec


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
    live = int((rows_p < nb).sum())
    for name, tdt in (("float32", torch.float32),
                      ("bfloat16", torch.bfloat16)):
        tiles, r, c = assemble(x, nb, B, rows_p, cols_p, hps, tdt,
                               torch.float32, device)
        mvd = None if tdt == torch.float32 else tdt
        rec = k1_case(f"{name} tiles", r, c, tiles, X, nb, B, mvd)
        if name == "bfloat16":     # the path's dtype
            records["chunked_spmm"] = rec
        # ---- K4 block_spmv on the same structure: X in the tile dtype,
        # ragged n = N, sentinel rows clamped into the last row block
        Xk = X[:N].to(tdt)
        got = hk.block_spmv(r, c, tiles, Xk, nb, B)
        ref = hk.block_spmv_reference(r, c, tiles, Xk, nb, B)
        torch.cuda.synchronize()
        if got.shape != (N, k) or got.dtype != tdt:
            raise AssertionError(f"K4 shape/dtype {tuple(got.shape)} "
                                 f"{got.dtype}")
        err = float((got.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        rtol = KERNEL_RTOL if tdt == torch.float32 else K4_BF16_RTOL
        tol = rtol * scale
        ms = cuda_ms(lambda: hk.block_spmv(r, c, tiles, Xk, nb, B))
        plain_ms = cuda_ms(lambda: hk.block_spmv_reference(r, c, tiles, Xk,
                                                           nb, B))
        lib_ms = bsr_library_ms(r, c, tiles, X, nb, B)
        item = tiles.element_size()
        rec = spmm_record(err, ms, plain_ms,
                          live * B * B * item + 2 * N * k * item + 8 * live,
                          2 * live * B * B * k, name, lib_ms)
        log(f"K4 block_spmv [{name}, B={B}, k={k}, n={N}, T={len(rows_p)}]: "
            f"max_abs_err {err:.3e} (tol {tol:.3e} = {rtol:g} x max|ref| "
            f"{scale:.3e}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {lib_ms} ms; {share(rec)}")
        if not (err <= tol):
            raise AssertionError(f"K4 ({name}) disagrees with its plain "
                                 f"version: {err} > {tol}")
        if name == "float32":
            records["block_spmv"] = rec
            k4_launch_path_cases(r, c, tiles, X, nb, B, N)
            spmv_launches = spmv_entry_path(r, c, tiles, Xk, nb, B)
        del tiles
    # ---- K1 at the N=1M journey's structure (its 100 launches' shape) --
    N1, B1 = 1_000_000, 128
    hps1 = np.array([1.0, 2.0, 2.0, 2.0])
    x, nb, rows_p, cols_p = bench_structure(N1, B1, hps1, seed=1)
    tiles, r, c = assemble(x, nb, B1, rows_p, cols_p, hps1, torch.bfloat16,
                           torch.float32, device)
    X1 = torch.randn((nb * B1, k), generator=gen).to(device)
    k1_case("bfloat16 tiles, N=1M journey", r, c, tiles, X1, nb, B1,
            torch.bfloat16)
    del tiles, X1, r, c
    torch.cuda.empty_cache()
    # ---- K2 at committed-solver shapes: c=128 in both dtypes, and the
    # N=1M journey's widths (posterior mean 8, variance 512) in bfloat16
    B, C = 128, 8
    hps2 = np.array([1.0, 2.0, 2.0, 2.0])
    x, nb, rows_p, cols_p = bench_structure(N, B, hps2, seed=1)
    live = rows_p < nb
    rows_a, cols_a, rowsc, n_chunks = hk.row_aligned_schedule(
        rows_p[live], cols_p[live], nb, C=C)
    for name, tdt, widths in (("bfloat16", torch.bfloat16, (128, 8, 512)),
                              ("float32", torch.float32, (128,))):
        tiles, r, cc = assemble(x, nb, B, rows_a, cols_a, hps2, tdt,
                                torch.float32, device)
        for c_w in widths:
            Xb = torch.randn((nb, B, c_w), generator=gen).to(tdt).to(device)
            rec = k2_case(name, tiles, cc, Xb, B, C, n_chunks, nb)
            if (name, c_w) == ("bfloat16", 128):
                records["row_chunk_sums"] = rec
            del Xb
        del tiles
    torch.cuda.empty_cache()
    return records, spmv_launches


def k4_launch_path_cases(r, c, tiles, X, nb, B, N):
    """K4's launch path at the N=50k structure (float32): the schedule is
    found again on the caller's rows tensor, rows and cols as numpy arrays,
    an X of nb·B rows and 16 columns (no copy of X), ragged n, ``n`` shorter
    than X, and a 1-D X — each against the plain version."""
    import torch

    from fvgp_tpu_torch.ops import hopper_kernels as hk

    def check(label, got, ref):
        err = float((got - ref).abs().max())
        tol = KERNEL_RTOL * float(ref.abs().max())
        log(f"K4 launch path [{label}]: shape {tuple(got.shape)}, "
            f"max_abs_err {err:.3e} (tol {tol:.3e})")
        if got.shape != ref.shape or not (err <= tol):
            raise AssertionError(f"K4 launch path ({label}) disagrees with "
                                 f"its plain version: {err} > {tol}")

    X16 = X[:, :16].contiguous()                      # nb*B rows, k % 8 == 0
    kept = getattr(r, "_fvgp_row_segments", None)
    got = hk.block_spmv(r, c, tiles, X16, nb, B)
    if kept is None or r._fvgp_row_segments is not kept:
        raise AssertionError("block_spmv did not find the schedule kept on "
                             "the caller's rows tensor")
    check("rows tensor reused, n = nb*B, k = 16",
          got, hk.block_spmv_reference(r, c, tiles, X16, nb, B))
    r_np, c_np = r.cpu().numpy(), c.cpu().numpy()
    check("numpy rows and cols, ragged n, k = 17",
          hk.block_spmv(r_np, c_np, tiles, X[:N], nb, B),
          hk.block_spmv_reference(r_np, c_np, tiles, X[:N], nb, B))
    check("n shorter than X", hk.block_spmv(r, c, tiles, X[:N], nb, B,
                                            n=N - 1000),
          hk.block_spmv_reference(r, c, tiles, X[:N], nb, B, n=N - 1000))
    x1d = X[:N, 0].contiguous()
    check("1-D X, ragged n", hk.block_spmv(r, c, tiles, x1d, nb, B),
          hk.block_spmv_reference(r, c, tiles, x1d, nb, B))
    torch.cuda.synchronize()


def spmv_entry_path(rows, cols, tiles, X, nb, B):
    """K4's own path: its ops entry point ``block_spmv``, its only caller
    (as in the JAX package), called as a user calls it — a 2-D X and a 1-D
    X, ragged n.  The counters are reset just before and read just after."""
    import torch

    from fvgp_tpu_torch.ops import hopper_kernels as hk
    hk.reset_launch_counts()
    Y = hk.block_spmv(rows, cols, tiles, X, nb, B)
    y = hk.block_spmv(rows, cols, tiles, X[:, 0], nb, B)
    torch.cuda.synchronize()
    launches = launch_counts()
    err = float((y - Y[:, 0]).abs().max())
    tol = KERNEL_RTOL * float(Y.abs().max())
    log(f"K4 ops entry: Y {tuple(Y.shape)}, y {tuple(y.shape)}, "
        f"|y - Y[:, 0]| {err:.3e} (tol {tol:.3e}); launches: "
        f"{json.dumps(launches)}")
    if not (Y.shape == X.shape and y.shape == X.shape[:1]
            and bool(torch.isfinite(Y).all()) and err <= tol):
        raise AssertionError("block_spmv's entry point gave a wrong result")
    if launches["block_spmv"] < 1:
        raise AssertionError("block_spmv never launched on its entry path")
    return launches


def dense_cell_data(N, seed=7):
    """The bench's dense cell data (bench.py:182-185)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 10.0, (N, 3))
    y = np.sin(x[:, 0]) + 0.25 * x[:, 1] + 0.05 * rng.standard_normal(N)
    xp = rng.uniform(0.0, 10.0, (500, 3))
    return x, y, xp


def k3_bound_record(err, ms, plain_ms, n1, n2, D, dname):
    """K3's record: the inputs and the hyperparameters once, the output
    once; ~3D + 7 operations per element (differences, squares, sums, sqrt,
    the polynomial, exp, the variance)."""
    item = 4 if dname == "float32" else 8
    return record(err, ms, plain_ms,
                  (n1 + n2) * D * item + (1 + D) * item + n1 * n2 * item,
                  n1 * n2 * (3 * D + 7), dname, None)


def dense_kernel_phase(device):
    """K3 at the dense cell's shapes: k(X, X) at N=10,000 on one tensor (as
    the journey calls it: the wrapper picks the route, symmetric in float64)
    and on two (the full route), k(X, x*) at 10,000 x 500 and k(x*, x*) at
    500 x 500, Matérn-3/2 and Wendland, float32 and float64."""
    import torch

    from fvgp_tpu_torch.ops import hopper_kernels as hk
    x, _, xp = dense_cell_data(10_000)
    records = {}
    for dname, dt in (("float32", torch.float32), ("float64", torch.float64)):
        X = torch.as_tensor(x, dtype=dt).to(device)
        X2 = X.clone()
        XP = torch.as_tensor(xp, dtype=dt).to(device)
        hps = torch.as_tensor([1.0, 1.5, 1.5, 1.5], dtype=dt).to(device)
        for kind in ("matern32", "wendland"):
            for shape, a, b in (("N x N one tensor", X, X),
                                ("N x N two tensors", X, X2),
                                ("N x 500", X, XP),
                                ("500 x 500 one tensor", XP, XP)):
                got = hk.dense_covariance(a, b, hps, kind=kind)
                ref = hk.dense_covariance_reference(a, b, hps, kind=kind)
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                tol = K3_RTOL[dname] * float(hps[0])
                if a is b and not (bool(torch.all(
                        torch.diagonal(got) == hps[0]))
                        and torch.equal(got, got.T)):
                    raise AssertionError("K3's k(X, X) is not exactly "
                                         "symmetric with the signal variance"
                                         " on its diagonal")
                ms = cuda_ms(lambda: hk.dense_covariance(a, b, hps,
                                                         kind=kind))
                plain_ms = cuda_ms(lambda: hk.dense_covariance_reference(
                    a, b, hps, kind=kind), reps=3)
                rec = k3_bound_record(err, ms, plain_ms, len(a), len(b), 3,
                                      dname)
                log(f"K3 dense_covariance [{kind}, {dname}, {shape}, D=3]: "
                    f"max_abs_err {err:.3e} (tol {tol:.3e}); kernel "
                    f"{ms:.4f} ms, plain {plain_ms:.4f} ms; {share(rec)}")
                if not (err <= tol):
                    raise AssertionError(f"K3 ({kind}, {dname}, {shape}) "
                                         f"disagrees with its plain version"
                                         f": {err} > {tol}")
                if (kind, dname, shape) == ("matern32", "float32",
                                            "N x N one tensor"):
                    records["dense_covariance"] = rec
                del got, ref
        if dname == "float64":
            # the 3D + 7 count takes exp and sqrt as one operation each; in
            # float64 they are software: ~30 and ~10 fused multiply-adds
            n_el = len(x) ** 2
            ops = n_el * (3 * 3 + 5 + 2 * (30 + 10))
            log(f"K3 float64 N x N with exp as 30 and sqrt as 10 fused "
                f"multiply-adds: {ops / PEAK_FLOPS['float64'] * 1e3:.4f} ms "
                f"of operations (Matérn-3/2, two tensors; on one tensor the "
                f"symmetric route computes half of them)")
    k3_edge_cases(device)
    return records


def k3_edge_cases(device):
    """K3 at the shapes that break a tiled body, each against the plain
    version at K3_RTOL: n1, n2 in {1, 33, 129, 1000}, an odd n2 and one with
    n2 % 4 == 2 (rows of the output not 16-byte aligned), D in {1, 2, 8, 17,
    32}; and k(X, X) on one tensor exactly symmetric, its diagonal exactly
    the signal variance, and one result bit for bit by the symmetric route,
    by the full route, through the wrapper and for X against a copy of X.
    Both kinds, both dtypes."""
    import torch

    from fvgp_tpu_torch.ops import hopper_kernels as hk
    rng = np.random.default_rng(17)
    sizes = (1, 33, 129, 1000)
    n_cases, worst = 0, {"float32": 0.0, "float64": 0.0}
    for dname, dt in (("float32", torch.float32), ("float64", torch.float64)):
        for D in (1, 2, 8, 17, 32):
            xs = {n: torch.as_tensor(rng.uniform(0, 4, (n, D)),
                                     dtype=dt).to(device)
                  for n in sizes + (999, 1002)}
            hps = torch.as_tensor(
                np.concatenate([[1.3], rng.uniform(1.0, 3.0, D)]),
                dtype=dt).to(device)
            tol = K3_RTOL[dname] * float(hps[0])
            for kind in ("matern32", "wendland"):
                pairs = [(n1, n2) for n1 in sizes for n2 in sizes] \
                    + [(129, 999), (1000, 1002)]
                for n1, n2 in pairs:
                    a = xs[n1]
                    b = xs[n2].clone()           # another tensor: full route
                    got = hk.dense_covariance(a, b, hps, kind=kind)
                    ref = hk.dense_covariance_reference(a, b, hps, kind=kind)
                    err = float((got - ref).abs().max())
                    worst[dname] = max(worst[dname], err)
                    n_cases += 1
                    if got.shape != (n1, n2) or not (err <= tol):
                        raise AssertionError(
                            f"K3 ({kind}, {dname}, {n1} x {n2}, D={D}) "
                            f"disagrees with its plain version: {err} > "
                            f"{tol}")
                for n in sizes + (999, 1002):
                    a = xs[n]
                    sym = hk._launch_dense_covariance(a, a, hps, kind, True)
                    full = hk._launch_dense_covariance(a, a, hps, kind,
                                                       False)
                    n_cases += 1
                    if not (torch.equal(sym, full)
                            and torch.equal(sym, hk.dense_covariance(
                                a, a, hps, kind=kind))
                            and torch.equal(sym, hk.dense_covariance(
                                a, a.clone(), hps, kind=kind))
                            and torch.equal(sym, sym.T)
                            and bool(torch.all(torch.diagonal(sym)
                                               == hps[0]))):
                        raise AssertionError(
                            f"K3 symmetric route ({kind}, {dname}, n={n}, "
                            f"D={D}) is not the full route's result, bit "
                            f"for bit, symmetric with the variance on the "
                            f"diagonal")
    torch.cuda.synchronize()
    log(f"K3 edge cases: {n_cases} passed; worst max_abs_err float32 "
        f"{worst['float32']:.3e}, float64 {worst['float64']:.3e} (tol "
        f"{K3_RTOL['float32']:g} / {K3_RTOL['float64']:g} x the variance "
        f"1.3)")


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


DENSE_BOUNDS = {"lml": 1e-4, "grad": 1e-3, "mean": 1e-3, "var": 1e-3}


def dense_model(x, y, hps, device):
    from fvgp_tpu_torch import GP
    return GP(x, y, init_hyperparameters=hps,
              noise_variances=np.full(len(x), 1e-2), compute_device=device,
              linalg_mode="Chol")


def dense_cross_check():
    """The dense GP at N=2,000: CUDA float32 against the CPU in float64,
    then the population and sampling trainers on the card."""
    x, y, xp = dense_cell_data(2_000, seed=8)
    hps = np.array([1.0, 1.5, 1.5, 1.5])
    out = {}
    for device in ("cpu", "cuda"):
        t0 = time.time()
        gp = dense_model(x, y, hps, device)
        val, grad = gp.marginal_likelihood.log_likelihood_value_and_gradient(
            hps)
        out[device] = (val, grad, gp.posterior_mean(xp)["m(x)"],
                       gp.posterior_covariance(xp, variance_only=True)["v(x)"])
        log(f"dense cross-check N=2000 {device}: lml {val:.6f} "
            f"({time.time() - t0:.2f} s)")
    ref, got = out["cpu"], out["cuda"]
    errs = {"lml": abs(got[0] - ref[0]) / abs(ref[0]),
            "grad": float(np.linalg.norm(got[1] - ref[1])
                          / np.linalg.norm(ref[1])),
            "mean": float(np.abs(got[2] - ref[2]).max()),
            "var": float(np.abs(got[3] - ref[3]).max())}
    log("dense cross-check N=2000 CUDA float32 vs CPU float64: "
        + ", ".join(f"{k} {errs[k]:.3e} (bound {DENSE_BOUNDS[k]:g})"
                    for k in errs))
    bad = [k for k in errs if not errs[k] <= DENSE_BOUNDS[k]]
    if bad:
        raise AssertionError(f"dense cross-check out of bounds: {bad}")
    bounds = np.array([[0.1, 10.0]] + [[0.5, 5.0]] * 3)
    for method, max_iter in (("global", 2), ("mcmc", 200)):
        t0 = time.time()
        trained = gp.train(hyperparameter_bounds=bounds, method=method,
                           max_iter=max_iter)
        lml = gp.log_likelihood()
        log(f"dense N=2000 CUDA train(method={method!r}, max_iter="
            f"{max_iter}): {time.time() - t0:.2f} s, hps "
            f"{np.array2string(trained, precision=4)}, lml {lml:.4f}")
        if not (np.all(np.isfinite(trained)) and np.isfinite(lml)):
            raise AssertionError(f"train({method}) gave non-finite results")


def dense_journey(N):
    """The bench's dense cell through the public GP (main path of K3)."""
    import torch

    from fvgp_tpu_torch.ops import hopper_kernels as hk
    x, y, xp = dense_cell_data(N)
    hps = np.array([1.0, 1.5, 1.5, 1.5])
    times = {}
    torch.cuda.reset_peak_memory_stats()
    hk.reset_launch_counts()
    t0 = time.time()
    gp = dense_model(x, y, hps, "cuda")
    torch.cuda.synchronize()
    times["construction_s"] = time.time() - t0
    ml = gp.marginal_likelihood
    t0 = time.time()
    val, grad = ml.log_likelihood_value_and_gradient(hps)
    torch.cuda.synchronize()
    times["first_lml_grad_s"] = time.time() - t0
    if not (np.isfinite(val) and np.all(np.isfinite(grad))):
        raise AssertionError(f"non-finite dense LML/grad: {val} {grad}")
    t0 = time.time()
    for i in range(5):
        val, grad = ml.log_likelihood_value_and_gradient(
            hps * (1.0 + 1e-4 * (i + 1)))
    torch.cuda.synchronize()
    times["lml_grad_s_per_eval"] = (time.time() - t0) / 5
    log(f"dense N={N}: lml {val:.4f}, grad "
        f"{np.array2string(grad, precision=4)}")
    bounds = np.array([[0.1, 10.0]] + [[0.5, 5.0]] * 3)
    t0 = time.time()
    trained = gp.train(hyperparameter_bounds=bounds, method="local",
                       max_iter=5)
    torch.cuda.synchronize()
    times["train_local_5_s"] = time.time() - t0
    if not np.all(np.isfinite(trained)):
        raise AssertionError(f"non-finite trained hps {trained}")
    for tag, q in (("cold", xp), ("warm", xp * (1 + 1e-9))):
        t0 = time.time()
        pm = gp.posterior_mean(q)["m(x)"]
        times[f"posterior_mean_500_{tag}_s"] = time.time() - t0
        t0 = time.time()
        pv = gp.posterior_covariance(q, variance_only=True)["v(x)"]
        times[f"posterior_variance_500_{tag}_s"] = time.time() - t0
    torch.cuda.synchronize()
    launches = launch_counts()
    if not (pm.shape == (500,) and pv.shape == (500,)
            and np.all(np.isfinite(pm)) and np.all(np.isfinite(pv))
            and np.all(pv >= 0.0)):
        raise AssertionError("dense posterior mean/variance not finite or "
                             "of the wrong shape")
    log(f"dense N={N}: trained hps {np.array2string(trained, precision=4)}, "
        f"lml {gp.log_likelihood():.4f}; mean range [{pm.min():.4f}, "
        f"{pm.max():.4f}], variance range [{pv.min():.3e}, {pv.max():.3e}]")
    log(f"dense N={N} phase times: " + json.dumps(
        {k: round(v, 4) for k, v in times.items()}))
    log(f"dense N={N} peak device memory: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"launches in this phase: {json.dumps(launches)}")
    if launches["dense_covariance"] < 1:
        raise AssertionError("dense_covariance never launched on the dense "
                             "path")
    if launches["block_spmv"] != 0:
        raise AssertionError("block_spmv launched on the dense journey, "
                             "which has no call to it")
    return launches


def journey_model(x, y, hps):
    """The gp2Scale journey's public GP on the card: B=128, bfloat16 solver
    and storage, 32 CG iterations, 16 fixed probes, no structure cache."""
    from fvgp_tpu_torch import GP
    return GP(x, y, init_hyperparameters=hps,
              noise_variances=np.full(len(x), 1e-2), gp2Scale=True,
              compute_device="cuda",
              args={"gp2Scale_block_size": 128,
                    "gp2Scale_solver_dtype": "bfloat16",
                    "gp2Scale_storage_dtype": "bfloat16",
                    "sparse_cg_maxiter": 32,
                    "random_logdet_fixed_probes": 16,
                    "gp2Scale_structure_cache_dir": False})


def full_journey(N):
    import torch

    from fvgp_tpu_torch.ops import hopper_kernels as hk
    x, y, xp = journey_data(N)
    hps = np.array([1.0, 2.0, 2.0, 2.0])
    times = {}
    torch.cuda.reset_peak_memory_stats()
    hk.reset_launch_counts()
    t0 = time.time()
    gp = journey_model(x, y, hps)
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
    launches = launch_counts()
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
    for name in ("chunked_spmm", "row_chunk_sums"):
        if launches[name] < 1:
            raise AssertionError(f"{name} never launched on the main path")
    if launches["block_spmv"] != 0:
        raise AssertionError("block_spmv launched on the gp2Scale journey, "
                             "which has no call to it")
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
    t0 = time.time()
    with ThreadPoolExecutor(2) as pool:
        kernels_built = pool.submit(hk.build_kernels, verbose=True)
        native_built = pool.submit(backend)
        secs, build_log = kernels_built.result()
        native = native_built.result()
    log(f"Hopper kernels built in {secs:.2f} s (nvcc, sm_90a); native host "
        f"runtime: {native}; both in {time.time() - t0:.2f} s")
    if native != "native":
        # g++ is on the card's machine: the numpy fallback would silently
        # change the gp2Scale structure pass being measured
        raise RuntimeError("the native host runtime did not build (backend "
                           f"{native!r})")
    for line in ptxas_summary(build_log):
        log(f"  ptxas: {line}")

    t0 = time.time()
    records, spmv_launches = kernel_phase("cuda")
    records.update(dense_kernel_phase("cuda"))
    log(f"kernel phase: {time.time() - t0:.1f} s")
    t0 = time.time()
    cross_check()
    log(f"gp2Scale cross-check phase: {time.time() - t0:.1f} s")
    t0 = time.time()
    dense_cross_check()
    log(f"dense cross-check phase: {time.time() - t0:.1f} s")
    t0 = time.time()
    dense_launches = dense_journey(10_000)
    log(f"dense journey phase: {time.time() - t0:.1f} s")
    t0 = time.time()
    sparse_launches = full_journey(1_000_000)
    log(f"gp2Scale journey phase: {time.time() - t0:.1f} s")
    # each kernel's launches on the three paths, each read just after its
    # run: K4's ops entry, the dense journey, the gp2Scale journey
    launches = {name: spmv_launches[name] + dense_launches[name]
                + sparse_launches[name] for name in REPLACES}

    kernels = [{"name": name, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[name], "launches": launches[name],
                **records[name]} for name in REPLACES]
    log(f"card: {smi}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
