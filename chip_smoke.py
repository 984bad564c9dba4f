#!/usr/bin/env python3
"""Chip smoke for fvgp_tpu_torch on one CUDA card: the gp2Scale journey,
the dense exact GP and the stored-K gp2Scale journey, with every
hand-written kernel held against its plain PyTorch version.

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
   and the journeys' widths c=8, c=512 and c=64 in bfloat16), and K3
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
   posterior_covariance(variance_only=True) on 500 points;
8. stored-K cross-check: the stored-K path (``gp2Scale_traced_lml=False``)
   at N=10,240 on CUDA (float32, and bfloat16 tile storage) against the CPU
   in float64 — K @ X, the trial LML (CG + SLQ at the same probes), a full
   posterior covariance, an aligned ``update_gp_data(append=True)``, and a
   few ``train(method="mcmc")`` steps with warm starts on the card;
9. the stored-K journey at full width through the public GP: the same
   N=1,000,000 configuration with ``gp2Scale_traced_lml=False``,
   ``linalg_mode="sparseCGpre"`` and bfloat16 tile storage — assemble
   ``gp.K``, a trial ``log_likelihood(hps)``, the committed
   ``log_likelihood()`` with its variance, a full ``posterior_covariance``
   on 64 points, and one misaligned ``update_gp_data(append=True)``: public
   calls only while the launches are counted.  Before the counts are set to
   0, on a model of the same configuration: ``K @ X`` at k=1, at the SLQ
   batch width and at 64 columns on K1 against the plain ``matmat``
   (float32 and float64, with the BSR library call beside it), and CG with
   and without the preconditioner and the SLQ log-determinant timed alone;
   after they are read, ``K @ X`` at k=1 on the appended K.

K4's entry point and phases 6, 7 and 9 are the paths: every kernel's launch
counter is reset just before each and read just after it, and the
``launches`` of a kernel is its sum over the four.  The line before the
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


# the stored-K path on CUDA vs the CPU in float64 (same probes, same CG
# tolerance): K @ X of the output scale (float32 tiles round at 6e-8, the
# float32 sums of ~30 tiles x 128 terms at ~1e-5; bfloat16 storage rounds
# every covariance at 2^-9 = 2e-3 relative, the random-sign sum of a row's
# ~4000 terms stays below 1e-2 of the scale), the trial LML relative, the
# full posterior covariance absolute (entries of O(1))
STORED_BOUNDS = {"float32": {"matmat": 1e-4, "lml": 1e-4, "S": 1e-3},
                 "bfloat16": {"matmat": 1e-2, "lml": 5e-3, "S": 5e-2}}
# the gp2Scale solver options at N=10,000 on CUDA vs the CPU in float64, same
# probes: the SLQ solver's LML and gradient and the two-level posterior
# variance under the mBCG path's BOUNDS; the gp2Scale Hessian (float32 only:
# central differences divide the gradient's rounding by 2e-3) as a relative
# Frobenius norm — CPU float32 against float64 gives 2.1e-4; the stored K's
# gp_lin_alg CG solution (relative 2-norm) and SLQ log-determinant (relative,
# the same probes) in float32 storage
SLICE_HESSIAN_BOUND = 5e-3
GLA_BOUNDS = {"cg": 1e-3, "logdet": 1e-4}
# the N=1M slice phase: the SLQ and mBCG LMLs at the same hyperparameters are
# two estimates of one number, within 3 standard deviations of the two
# reported variances; two-level and block-Jacobi variances within the bf16
# bound of the journey (PERF.md section 2)
SLICE_SIGMAS = 3.0
SLICE_VAR_BOUND = 5e-2
# bfloat16 streaming moves the SLQ estimate by more than its probes'
# variance says: every Lanczos vector is cast to bfloat16 before its product
# (the JAX package's arithmetic too).  Set before the first full run from
# the port on the CPU at N=50,000, same 16 probes, plain versions: SLQ bf16
# -44212.14 against SLQ float64 -44174.98, 8.4e-4 of |LML|; mBCG bf16
# -44147.17 against float64 -44147.60.  Allowed on top of the 3 sigma for a
# bfloat16 SLQ evaluation: 2e-3 of |LML|; a float32 one gets none.  (On the
# card at N=1M the same comparison, ``chip_profile.py slq``, gave +4.9e-4
# at these hyperparameters and +4.0e-3 on the training path: the shift's
# sign and size depend on the conditioning)
SLICE_BF16_SLQ_SHIFT = 2e-3
# K1 from BlockSparseMatrix under bfloat16 storage: X enters as two bfloat16
# halves (16 mantissa bits, 2^-17 relative), so against the float64 product
# of the SAME stored tiles only the float32 summation remains
STORED_K1_F64_RTOL = 1e-4


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
    # the SLQ solver's Lanczos steps: one launch of the 16 probes' width
    X16 = torch.randn((nb * B1, 16), generator=gen).to(device)
    records["k1_slq_batch"] = k1_case("bfloat16 tiles, N=1M, SLQ batch", r,
                                      c, tiles, X16, nb, B1, torch.bfloat16)
    del tiles, X1, X16, r, c
    torch.cuda.empty_cache()
    # ---- K2 at committed-solver shapes: c=128 in both dtypes, and in
    # bfloat16 the N=1M journey's widths (posterior mean 8, variance 512)
    # and the stored-K journey's (a 64-point full covariance: 64)
    B, C = 128, 8
    hps2 = np.array([1.0, 2.0, 2.0, 2.0])
    x, nb, rows_p, cols_p = bench_structure(N, B, hps2, seed=1)
    live = rows_p < nb
    rows_a, cols_a, rowsc, n_chunks = hk.row_aligned_schedule(
        rows_p[live], cols_p[live], nb, C=C)
    for name, tdt, widths in (("bfloat16", torch.bfloat16,
                               (128, 8, 512, 64)),
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


def slice_cross_check():
    """The gp2Scale solver options at N=10,000: the SLQ training solver's
    LML and gradient and the two-level posterior variance (64 points) on
    CUDA, float32 and bfloat16 streaming, against the CPU in float64 at the
    same probes (fresh models draw the same seeds); then the gp2Scale
    Hessian (mBCG, central differences of 8 gradients) in float32."""
    from fvgp_tpu_torch import GP
    N = 10_000
    x, y, xp = journey_data(N, seed=2)
    xp = xp[:64]
    hps = np.array([1.0, 2.0, 2.0, 2.0])
    base = {"gp2Scale_block_size": 128, "sparse_cg_maxiter": 64,
            "random_logdet_fixed_probes": 16,
            "gp2Scale_structure_cache_dir": False}
    options = {"gp2Scale_solver": "slq",
               "gp2Scale_posterior_precond": "two_level"}

    def model(device, extra):
        return GP(x, y, init_hyperparameters=hps,
                  noise_variances=np.full(N, 1e-2), gp2Scale=True,
                  compute_device=device, linalg_mode="sparseCGpre",
                  args={**base, **extra})

    def run(device, extra):
        t0 = time.time()
        gp = model(device, {**options, **extra})
        val, grad = gp.marginal_likelihood.log_likelihood_value_and_gradient(
            hps)
        var = gp.posterior_covariance(xp, variance_only=True)["v(x)"]
        its = gp.kv.last_solve_info["iterations"]
        log(f"slice cross-check N={N} {device} {extra or ''}: SLQ lml "
            f"{val:.6f}, two-level CG {its} iterations, {time.time() - t0:.2f}"
            f" s")
        return val, grad, var

    ref = run("cpu", {})
    for name, extra in (("float32", {}),
                        ("bfloat16", {"gp2Scale_solver_dtype": "bfloat16"})):
        got = run("cuda", extra)
        errs = {"lml": abs(got[0] - ref[0]) / abs(ref[0]),
                "grad": float(np.linalg.norm(got[1] - ref[1])
                              / np.linalg.norm(ref[1])),
                "var": float(np.abs(got[2] - ref[2]).max())}
        bounds = BOUNDS[name]
        log(f"slice cross-check N={N} CUDA {name} vs CPU float64 (SLQ "
            "solver, two-level variance): "
            + ", ".join(f"{k} {errs[k]:.3e} (bound {bounds[k]:g})"
                        for k in errs))
        bad = [k for k in errs if not errs[k] <= bounds[k]]
        if bad:
            raise AssertionError(f"slice cross-check {name} out of bounds: "
                                 f"{bad}")
    hess = {}
    for device in ("cpu", "cuda"):
        t0 = time.time()
        hess[device] = model(device, {}).marginal_likelihood \
            .neg_log_likelihood_hessian(hps)
        log(f"slice cross-check N={N} {device}: gp2Scale Hessian "
            f"{time.time() - t0:.2f} s, diagonal "
            f"{np.array2string(np.diag(hess[device]), precision=4)}")
    err = float(np.linalg.norm(hess["cuda"] - hess["cpu"])
                / np.linalg.norm(hess["cpu"]))
    log(f"slice cross-check N={N}: Hessian CUDA float32 vs CPU float64 "
        f"{err:.3e} (bound {SLICE_HESSIAN_BOUND:g}, relative Frobenius)")
    if not (err <= SLICE_HESSIAN_BOUND
            and np.array_equal(hess["cuda"], hess["cuda"].T)):
        raise AssertionError(f"the gp2Scale Hessian disagrees: {err}")


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
    lml_at_hps = val
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
    slice_launches = slice_phase(gp, xp, pv, hps)
    return launches, lml_at_hps, slice_launches


def counted(fn):
    """(result, seconds, launches) of one public call: the counts set to 0
    just before it and read just after it."""
    import torch

    from fvgp_tpu_torch.ops import hopper_kernels as hk
    torch.cuda.synchronize()
    hk.reset_launch_counts()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0, launch_counts()


def slice_phase(gp, xp, pv_journey, hps):
    """The gp2Scale solver options at full width, on the journey's model
    (its data and structure pass): (a) ``gp2Scale_solver="slq"``, two
    LML+gradient evaluations at the configuration's hyperparameters
    ``hps`` against the mBCG LML there, and a third with float32 tile
    streaming; (b) at the committed (trained) state, the 500-point
    posterior variance with
    ``gp2Scale_posterior_precond="two_level"`` and again with block-Jacobi.
    Public calls only, each counted on its own.  Returns the launches of
    the SLQ evaluations and of the two-level variance."""
    import torch
    ml = gp.marginal_likelihood
    n = len(gp.x_data)
    h = np.asarray(hps)
    (val_m, _), secs_m, _ = counted(
        lambda: ml.log_likelihood_value_and_gradient(h))
    var_m = ml.log_likelihood_variance()
    log(f"slice N={n}: mBCG LML at hps {h} {val_m:.4f} (variance "
        f"{var_m:.4e}, {secs_m:.3f} s)")
    gp.args["gp2Scale_solver"] = "slq"
    slq_launches = {name: 0 for name in REPLACES}
    for i, stream in enumerate(("bfloat16", "bfloat16", "float32")):
        if stream == "float32":
            # the float32 tile set is twice the bfloat16 one: drop the
            # committed solver's tiles (7 GiB), rebuilt by the next solve
            gp.args["gp2Scale_solver_dtype"] = None
            gp.kv._fast_solver_ctx = None
            torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        (val, grad), secs, got = counted(
            lambda: ml.log_likelihood_value_and_gradient(h))
        var = ml.log_likelihood_variance()
        for name in REPLACES:
            slq_launches[name] += got[name]
        gap = abs(val - val_m)
        shift = SLICE_BF16_SLQ_SHIFT * abs(val_m) if stream == "bfloat16" \
            else 0.0
        allowed = SLICE_SIGMAS * np.sqrt(var + var_m) + shift
        # the journey's configuration streams bfloat16: those two
        # evaluations are held to the bound; the float32 one is measured
        held = stream == "bfloat16"
        log(f"slice N={n}: SLQ LML+grad #{i + 1} ({stream} streaming) "
            f"{secs:.3f} s, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, lml "
            f"{val:.4f} (variance {var:.4e}), grad "
            f"{np.array2string(grad, precision=4)}; SLQ - mBCG "
            f"{val - val_m:.4f} ({'bound' if held else 'measured against'} "
            f"{allowed:.4f} = {SLICE_SIGMAS:g} sigma + {shift:.4f}); "
            f"launches {json.dumps(got)}")
        if not (np.isfinite(val) and np.all(np.isfinite(grad))
                and (gap <= allowed or not held)):
            raise AssertionError(f"the SLQ LML {val} is not the mBCG LML "
                                 f"{val_m} within {allowed}")
    log(f"slice N={n}: K1 launches in the three SLQ evaluations: "
        f"{slq_launches['chunked_spmm']}")
    gp.args.update({"gp2Scale_solver": "mbcg",
                    "gp2Scale_solver_dtype": "bfloat16"})
    if slq_launches["chunked_spmm"] < 1:
        raise AssertionError("chunked_spmm never launched on the SLQ path")
    pvs = {}
    # two-level twice: its first solve also pays what runs once per
    # process (the first large dense Cholesky and triangular solve)
    for precond in ("two_level", "block_jacobi", "two_level"):
        gp.args["gp2Scale_posterior_precond"] = precond
        torch.cuda.reset_peak_memory_stats()
        pv, secs, got = counted(lambda: gp.posterior_covariance(
            xp, variance_only=True)["v(x)"])
        info = gp.kv.last_solve_info
        pvs.setdefault(precond, (pv, got))
        log(f"slice N={n}: posterior variance (500 points) with {precond}: "
            f"{secs:.3f} s (assembly and preconditioner included), CG "
            f"iterations {info['iterations']} in {info['chunks']} chunk(s), "
            f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
            f"launches {json.dumps(got)}")
        if info["preconditioner"] != precond or not (
                pv.shape == (500,) and np.all(np.isfinite(pv))):
            raise AssertionError(f"the {precond} posterior variance failed")
    diff = float(np.abs(pvs["two_level"][0] - pvs["block_jacobi"][0]).max())
    drift = float(np.abs(pvs["block_jacobi"][0] - pv_journey).max())
    log(f"slice N={n}: max |two_level - block_jacobi| variance {diff:.3e} "
        f"(bound {SLICE_VAR_BOUND:g}); block-Jacobi against the journey's "
        f"own variance {drift:.3e}")
    if not (diff <= SLICE_VAR_BOUND and drift <= SLICE_VAR_BOUND):
        raise AssertionError("the two-level posterior variance disagrees")
    two_level = pvs["two_level"][1]
    if two_level["row_chunk_sums"] < 1:
        raise AssertionError("row_chunk_sums never launched on the "
                             "two-level path")
    return {"slq": slq_launches, "two_level": two_level}


def stored_model(x, y, hps, device, extra):
    """The stored-K gp2Scale model: the traced LML off, sparseCGpre."""
    from fvgp_tpu_torch import GP
    return GP(x, y, init_hyperparameters=hps,
              noise_variances=np.full(len(x), 1e-2), gp2Scale=True,
              compute_device=device, linalg_mode="sparseCGpre",
              args={"gp2Scale_block_size": 128, "gp2Scale_traced_lml": False,
                    "sparse_cg_tol": 1e-5, "sparse_cg_maxiter": 500,
                    "gp2Scale_structure_cache_dir": False, **extra})


def stored_cross_check():
    """The stored-K path at N=10,240 (80 tiles of 128, so the append is
    aligned): CUDA float32 and bfloat16 storage against the CPU in
    float64."""
    import torch
    N, n_new = 10_240, 256
    x, y, xp = journey_data(N + n_new, seed=4)
    xp = xp[:64]
    hps = np.array([1.0, 2.0, 2.0, 2.0])
    trial = hps * 1.02
    X = np.random.default_rng(5).standard_normal((N, 4))
    out, gla_out = {}, {}
    for name, device, extra in (
            ("cpu", "cpu", {}), ("float32", "cuda", {}),
            ("bfloat16", "cuda", {"gp2Scale_storage_dtype": "bfloat16"})):
        t0 = time.time()
        gp = stored_model(x[:N], y[:N], hps, device, extra)
        K = gp.K
        KX = K.matmat(torch.as_tensor(X, dtype=gp.prior.dtype)
                      .to(gp.device)).double().cpu().numpy()
        lml = gp.log_likelihood(trial)
        its = gp.kv.last_solve_info["iterations"]
        S = gp.posterior_covariance(xp)["S"]
        gp.update_gp_data(x[N:], y[N:], append=True,
                          noise_variances_new=np.full(n_new, 1e-2))
        K2 = gp.K
        if K2.shape != (N + n_new, N + n_new) or K2.nnz <= K.nnz:
            raise AssertionError("the aligned append did not extend K")
        ones = torch.ones(N + n_new, dtype=gp.prior.dtype, device=gp.device)
        row_sums = K2.matmat(ones).double().cpu().numpy()
        out[name] = (KX, lml, S, row_sums, str(K.tiles.dtype), its)
        if name != "bfloat16":
            gla_out[name] = gla_case(gp, device)
        if name == "float32":
            stored_mcmc_steps(gp, hps)
        log(f"stored-K cross-check N={N} {name}: tiles {K.tiles.dtype}, "
            f"live {K.nnz // 128 ** 2}, trial lml {lml:.6f} (CG {its} "
            f"iterations), {time.time() - t0:.2f} s")
    ref = out["cpu"]
    for name in ("float32", "bfloat16"):
        got = out[name]
        scale = float(np.abs(ref[0]).max())
        errs = {"matmat": float(np.abs(got[0] - ref[0]).max()) / scale,
                "lml": abs(got[1] - ref[1]) / abs(ref[1]),
                "S": float(np.abs(got[2] - ref[2]).max()),
                "append": float(np.abs(got[3] - ref[3]).max())
                / float(np.abs(ref[3]).max())}
        bounds = dict(STORED_BOUNDS[name],
                      append=STORED_BOUNDS[name]["matmat"])
        log(f"stored-K cross-check N={N} CUDA {name} vs CPU float64: "
            + ", ".join(f"{k} {errs[k]:.3e} (bound {bounds[k]:g})"
                        for k in errs))
        bad = [k for k in errs if not errs[k] <= bounds[k]]
        if bad:
            raise AssertionError(f"stored-K cross-check {name} out of "
                                 f"bounds: {bad}")
    (x_ref, ld_ref), (x32, ld32) = gla_out["cpu"], gla_out["float32"]
    errs = {"cg": float(np.linalg.norm(x32 - x_ref) / np.linalg.norm(x_ref)),
            "logdet": abs(ld32 - ld_ref) / abs(ld_ref)}
    log(f"gp_lin_alg on the stored K+V, N={N} (before the append), CUDA "
        "float32 vs CPU float64: "
        + ", ".join(f"{k} {errs[k]:.3e} (bound {GLA_BOUNDS[k]:g})"
                    for k in errs))
    if not all(errs[k] <= GLA_BOUNDS[k] for k in errs):
        raise AssertionError(f"gp_lin_alg on the stored K disagrees: {errs}")


def gla_case(gp, device):
    """``gp_lin_alg`` on the model's stored K+V, where it lives: a
    preconditioned CG solve of y and the SLQ log-determinant (its probes
    drawn on the CPU from seed 0, so both devices see the same)."""
    from fvgp_tpu_torch import gp_lin_alg as gla
    KV = gp.kv.KV
    y = np.asarray(gp.y_data)[:, 0]
    t0 = time.time()
    _, M = gla.calculate_sparse_preconditioner(KV)
    xs = gla.calculate_sparse_conj_grad(KV, y, M=M, args={
        "sparse_cg_tol": 1e-7, "sparse_cg_maxiter": 1000})
    info = {}
    ld = gla.calculate_random_logdet(KV, compute_device=device, args={
        "random_logdet_min_num_samples": 16}, info_out=info)
    log(f"gp_lin_alg on the stored K+V ({device}): CG + SLQ "
        f"{time.time() - t0:.2f} s, logdet {ld:.4f} ({info['num_samples']} "
        f"probes, relative error {info['relative_error']:.2e})")
    return xs[:, 0], ld


def stored_mcmc_steps(gp, hps):
    """A few MCMC steps on the stored-K model on the card: every step is a
    trial solve, with warm starts and preconditioner reuse switched on (the
    sequential linear-algebra state that only this method may carry)."""
    gp.args.update({"sparse_krylov_warm_start": True,
                    "sparse_preconditioner_refresh_interval": 4})
    bounds = np.array([[0.5, 2.0]] + [[1.8, 2.2]] * 3)
    np.random.seed(3)
    t0 = time.time()
    trained = gp.train(hyperparameter_bounds=bounds, method="mcmc",
                       max_iter=8, init_hyperparameters=hps)
    info = gp.kv.last_solve_info
    log(f"stored-K cross-check: train(method='mcmc', max_iter=8) on CUDA "
        f"{time.time() - t0:.2f} s, hps "
        f"{np.array2string(trained, precision=4)}; last trial solve "
        f"{info['iterations']} CG iterations, warm start "
        f"{info['warm_start']}, preconditioner reuse counter "
        f"{gp.kv.Preconditioner_reuse_counter}")
    if not (np.all(np.isfinite(trained)) and info["warm_start"]
            and info["preconditioned"]):
        raise AssertionError("MCMC on the stored-K path did not carry its "
                             "warm start and preconditioner")


def stored_matmat_case(K, k, gen):
    """``K @ X`` on K1 (bfloat16 storage: X as two bfloat16 halves) against
    the plain ``matmat`` in float32 and in float64 on the same stored tiles,
    timed beside the plain version and the BSR library call.  The bound
    counts the live tiles, the indices, X and the float32 output once; the
    kernel multiplies 2k columns for k (the two halves)."""
    import torch

    from fvgp_tpu_torch.ops import hopper_kernels as hk
    from fvgp_tpu_torch.parallel import block_sparse as bs
    n, nb, B = K.n, K.nb, K.block_size
    X = torch.randn((n, k), generator=gen, dtype=torch.float32).to(K.device)
    before = hk.chunked_spmm.launches
    got = K.matmat(X)
    if hk.chunked_spmm.launches != before + 1:
        raise AssertionError("BlockSparseMatrix.matmat did not launch K1 "
                             "once")
    s = K._store
    ref = bs._bsm_matmat_plain(s.rows, s.cols, s.tiles, X, nb, B)
    ref64 = bs._bsm_matmat_plain(s.rows, s.cols, s.tiles, X.double(), nb, B)
    scale = float(ref64.abs().max())
    err = float((got - ref).abs().max())
    err64 = float((got.double() - ref64).abs().max())
    plain64 = float((ref.double() - ref64).abs().max())
    del ref, ref64
    ms = cuda_ms(lambda: K.matmat(X))
    plain_ms = cuda_ms(lambda: bs._bsm_matmat_plain(s.rows, s.cols, s.tiles,
                                                    X, nb, B), reps=3)
    Xp = torch.zeros((nb * B, k), dtype=torch.float32, device=K.device)
    Xp[:n] = X
    lib_ms = bsr_library_ms(s.rows, s.cols, s.tiles, Xp, nb, B)
    live = K.nnz // (B * B)
    halves = 2 if s.tiles.dtype == torch.bfloat16 else 1
    rec = spmm_record(err, ms, plain_ms,
                      live * B * B * s.tiles.element_size()
                      + 2 * n * k * 4 + 8 * live,
                      2 * live * B * B * k * halves, str(s.tiles.dtype)[6:],
                      lib_ms)
    per_row = np.bincount(s.rows_h[s.rows_h < nb], minlength=nb)
    log(f"K1 from BlockSparseMatrix.matmat [{s.tiles.dtype}, B={B}, k={k}, "
        f"live {live}, tiles per row block median "
        f"{int(np.median(per_row))} / max {int(per_row.max())}]: vs plain "
        f"float32 {err:.3e} (tol "
        f"{KERNEL_RTOL * scale:.3e}), vs plain float64 {err64:.3e} (tol "
        f"{STORED_K1_F64_RTOL * scale:.3e} = {STORED_K1_F64_RTOL:g} x "
        f"max|ref| {scale:.3e}; the plain float32 version is {plain64:.3e} "
        f"off float64); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library {lib_ms} ms; {share(rec)}")
    if not (err <= KERNEL_RTOL * scale and err64 <= STORED_K1_F64_RTOL
            * scale):
        raise AssertionError(f"matmat on K1 (k={k}) disagrees with the plain "
                             f"matmat: {err} / {err64}")
    return rec


def stored_journey_model(N):
    """The stored-K journey's data and its public GP on the card: bfloat16
    tile storage, CG to 1e-4; returns (gp, x, y, 64 prediction points,
    hps)."""
    x, y, xp = journey_data(N)
    hps = np.array([1.0, 2.0, 2.0, 2.0])
    gp = stored_model(x, y, hps, "cuda",
                      {"gp2Scale_storage_dtype": "bfloat16",
                       "gp2Scale_solver_dtype": "bfloat16",
                       "sparse_cg_tol": 1e-4})
    return gp, x, y, xp[:64], hps


def stored_journey(N, traced_lml):
    """The stored-K journey at full width through the public GP (the main
    path of K1's second caller).  The kernel-vs-plain comparisons and the
    timings of the pieces run first, on a model of their own; only public
    calls run between the reset of the launch counts and their reading."""
    import torch

    from fvgp_tpu_torch.ops import hopper_kernels as hk
    times = {}
    records = stored_pieces(stored_journey_model(N)[0], times)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    hk.reset_launch_counts()
    gp, x, y, xp, hps = stored_journey_model(N)
    t0 = time.time()
    K = gp.K
    torch.cuda.synchronize()
    times["assemble_K_s"] = time.time() - t0
    ml = gp.marginal_likelihood
    t0 = time.time()
    trial = gp.log_likelihood(hps * 1.001)
    torch.cuda.synchronize()
    times["trial_lml_s"] = time.time() - t0
    trial_info = dict(gp.kv.last_solve_info)
    trial_var = ml.log_likelihood_variance()
    trial_pre = (gp.kv.Preconditioner_operator is not None,
                 gp.kv.Last_preconditioner_error)
    t0 = time.time()
    committed = gp.log_likelihood()
    torch.cuda.synchronize()
    times["committed_lml_s"] = time.time() - t0
    var = ml.log_likelihood_variance()
    info = dict(gp.kv.last_logdet_info)
    t0 = time.time()
    cov = gp.posterior_covariance(xp)
    torch.cuda.synchronize()
    times["posterior_covariance_64_s"] = time.time() - t0
    # one append: N is not a multiple of 128, so K is recomputed
    rng = np.random.default_rng(6)
    x_new = rng.uniform(0, x.max(), (1000, 3))
    y_new = np.sin(0.2 * x_new[:, 0])
    t0 = time.time()
    gp.update_gp_data(x_new, y_new, noise_variances_new=np.full(1000, 1e-2),
                      append=True)
    K2 = gp.K
    torch.cuda.synchronize()
    times["append_1000_s"] = time.time() - t0
    launches = launch_counts()

    # ---- what the path gave ----------------------------------------------
    live = K.nnz // 128 ** 2
    log(f"stored N={N}: K {K.shape}, tiles {tuple(K.tiles.shape)} "
        f"{K.tiles.dtype} ({K.tiles.numel() * 2 / 2**30:.2f} GiB), live "
        f"{live}, fill {K.sparsity():.3e}")
    if K.tiles.dtype != torch.bfloat16 or N % 128 == 0:
        raise AssertionError("the stored journey needs bfloat16 tiles and a "
                             "misaligned N")
    if float(K.tiles[live:].float().abs().max()) != 0.0:
        raise AssertionError("the padding tiles are not exactly zero")
    if not trial_pre[0] or trial_pre[1] is not None:
        raise AssertionError("the trial solve ran without its preconditioner:"
                             f" {trial_pre[1]}")
    log(f"stored N={N}: trial lml {trial:.4f} (variance {trial_var:.4e}, CG "
        f"{trial_info['iterations']} iterations, preconditioned "
        f"{trial_info['preconditioned']}); committed lml {committed:.4f} "
        f"(variance {var:.4e}, SLQ {info['num_samples']} probes of degree "
        f"{info['degree']}, relative error {info['relative_error']:.2e}); "
        f"traced mBCG lml at the same hyperparameters {traced_lml:.4f}")
    if not (np.isfinite(trial) and np.isfinite(committed) and var > 0
            and trial_var > 0):
        raise AssertionError("non-finite stored-K LML or no SLQ variance")
    # two estimators of one number: bfloat16 tiles in both, SLQ noise
    # sqrt(var) here, 32 CG iterations and 16 probes there
    if abs(committed - traced_lml) > 2e-2 * abs(traced_lml):
        raise AssertionError("the stored-K LML and the traced mBCG LML "
                             f"disagree: {committed} vs {traced_lml}")
    S, v = cov["S"], cov["v(x)"]
    if not (S.shape == (64, 64) and np.all(np.isfinite(S))
            and np.abs(S - S.T).max() <= 1e-2 and np.all(v >= 0.0)
            and np.allclose(np.diag(S), v)):
        raise AssertionError("the full posterior covariance is not a finite "
                             "symmetric 64 x 64 matrix")
    log(f"stored N={N}: posterior covariance 64 x 64, variance range "
        f"[{v.min():.3e}, {v.max():.3e}], asymmetry "
        f"{np.abs(S - S.T).max():.2e}")
    del K, cov
    rs = K2.matmat(torch.ones(N + 1000, device="cuda"))
    if not (K2.shape == (N + 1000, N + 1000) and K2.nnz > live * 128 ** 2
            and bool(torch.isfinite(rs).all()) and float(rs.min()) >= 1.0):
        raise AssertionError("update_gp_data(append=True) did not give the "
                             "covariance of the extended data")
    log(f"stored N={N} peak device memory: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches on "
        f"this path (public calls only): {json.dumps(launches)}")
    # K1 serves the stored operator's CG and SLQ, K2 the committed fast
    # solver behind the committed LML and the posterior covariance
    for name in ("chunked_spmm", "row_chunk_sums"):
        if launches[name] < 1:
            raise AssertionError(f"{name} never launched on the stored-K "
                                 "path")
    if launches["block_spmv"] != 0 or launches["dense_covariance"] != 0:
        raise AssertionError("a kernel with no call on the stored-K journey "
                             "launched on it")
    # the appended points are not sorted in space, so the last row blocks
    # of the recomputed K own many more tiles than the others
    gen = torch.Generator().manual_seed(10)
    records["k1_appended"] = stored_matmat_case(K2, 1, gen)
    log(f"stored N={N} phase times: " + json.dumps(
        {k: round(v, 4) for k, v in times.items()}))
    return launches, records


def stored_pieces(gp, times):
    """Outside the counted journey, on a model of the same configuration:
    ``K @ X`` on K1 against the plain ``matmat`` at k = 1, the SLQ batch
    width and the 64 columns of a posterior solve, then the pieces of the
    LML on the committed K+V timed alone — CG with and without the
    preconditioner, the SLQ log-determinant."""
    import torch
    K = gp.K
    n = K.n
    gen = torch.Generator().manual_seed(9)
    T = int(K.tiles.shape[0])
    k_slq = max(4, min(32, (1 << 28) // max(T * 128 * 4, 1)))
    records = {f"k{k}": stored_matmat_case(K, k, gen)
               for k in (1, k_slq, 64)}
    torch.cuda.empty_cache()
    KV = gp.kv.KV
    ym = gp.kv._y_minus(gp.kv._m_vec)
    iters = {}
    for mode in ("sparseCGpre", "sparseCG"):
        t0 = time.time()
        sol = gp.kv._solve_with(mode, KV, ym)
        torch.cuda.synchronize()
        times[f"{mode}_s"] = time.time() - t0
        iters[mode] = gp.kv.last_solve_info["iterations"]
        res = float(torch.linalg.norm(KV.matmat(sol) - ym)
                    / torch.linalg.norm(ym))
        log(f"stored N={n}: {mode} {iters[mode]} iterations, "
            f"{times[mode + '_s']:.3f} s, true relative residual {res:.2e}")
        if not res <= 1e-3:
            raise AssertionError(f"{mode} did not solve K+V: residual {res}")
    if not iters["sparseCGpre"] < iters["sparseCG"]:
        raise AssertionError(f"the preconditioner did not cut the "
                             f"iterations: {iters}")
    t0 = time.time()
    gp.kv._random_logdet(KV)
    torch.cuda.synchronize()
    times["slq_logdet_s"] = time.time() - t0
    return records


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
    slice_cross_check()
    log(f"slice cross-check phase: {time.time() - t0:.1f} s")
    t0 = time.time()
    sparse_launches, traced_lml, slice_launches = full_journey(1_000_000)
    log(f"gp2Scale journey and slice phase: {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.time()
    stored_cross_check()
    log(f"stored-K cross-check phase: {time.time() - t0:.1f} s")
    t0 = time.time()
    stored_launches, stored_records = stored_journey(1_000_000, traced_lml)
    log(f"stored-K journey phase: {time.time() - t0:.1f} s")
    # each kernel's launches on the four paths, each read just after its
    # run: K4's ops entry, the dense journey, the gp2Scale journey, the
    # stored-K journey
    paths = [spmv_launches, dense_launches, sparse_launches,
             slice_launches["slq"], slice_launches["two_level"],
             stored_launches]
    launches = {name: sum(p[name] for p in paths) for name in REPLACES}
    for kern, name in (("K1", "chunked_spmm"), ("K2", "row_chunk_sums")):
        log(f"{kern} launches by path: " + json.dumps(
            {"gp2Scale journey": sparse_launches[name],
             "SLQ solver (3 LML+grad)": slice_launches["slq"][name],
             "two-level variance": slice_launches["two_level"][name],
             "stored-K journey": stored_launches[name]}))
    log("K1 at the SLQ batch width (k = 16, N = 1M structure): "
        + json.dumps(records.pop("k1_slq_batch")))
    log("K1 from BlockSparseMatrix at the stored-K journey's shapes: "
        + json.dumps(stored_records))

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
