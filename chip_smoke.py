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
   bfloat16: the shape of its launches on that path), K5
   ``tile_covariance`` and ``tile_covariance_vjp`` at the same structure
   (float32 and bfloat16 tiles), K2 ``row_chunk_sums``
   at committed-solver shapes (B=128, C=8; c=128 in bfloat16 and float32,
   the journeys' widths c=8, c=512 and c=64 in bfloat16, and the
   gp2scale-predict cell's c=512, 256 and 8 in float32), and K3
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
   D=3, bfloat16 solver, 16 probes — construction, LML+gradient (1 + 2
   timed), train(method="local", max_iter=1), posterior_mean and
   posterior_covariance(variance_only=True) on 500 points; then 7d. the
   gp2scale-predict cell's path at the same data and h0 in float32: one
   500-point request counted (K2 alone, the CG's dropped columns, eight
   variances against the same points solved alone);
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

Since the posterior-API slice also: 5b. the posterior API against the CPU
in float64 — at dense N=2,000 every new method (posterior gradients, the
information-theory suite, the validation metrics) in float32 and float64 on
the card, ``kernel_dtype="float32"`` under float64, a custom ``[factor,
solve, logdet]`` on ``torch.linalg.cholesky`` with an append, a pickle round
trip; at gp2Scale N=10,000 the posterior gradients and the relative
information entropy in float32; 6b. on the dense journey's trained model
all 23 new methods on 200 points, each call counted; 7b. on the N=1M
journey's trained model the posterior gradients, KL divergence, relative
information entropy and posterior probability on 100 points and four
metrics on 500, each call counted.

Since the training slice also: 4b. on phase 4's CPU float64 model and
the card's float32 one, two steps of the gp2Scale Adam chain at the same
injected probes (K1 launches counted); 5c. the training pieces against the
CPU in float64 — the batched value-and-gradient of the dense LML (N=2,000,
four members, one not positive definite; card float32 and float64) and a
14-evaluation BO run on an analytic bowl (card float64); 6c. on the dense
journey's model ``train`` with ``"hgdl"`` (4 starts, 3 epochs: the
host-callable slice cut it from 10 to 5, the mesh slice to 3, to keep the
smoke's time), ``"adam"`` (20 steps), ``"bo"`` (14 evaluations) and an
asynchronous ``"mcmc"`` polled through ``update_hyperparameters`` and then
stopped, each call counted; 7c. on the N=1M journey's model ``train`` with
``"adam"`` (4 steps, within one device chain chunk) and ``"bo"`` (8
evaluations; the mesh slice cut them from 8 and 14), each call counted.

Since the host-callable slice also: 5d. against the CPU in float64 — the
formula gradient of a numpy host Matérn kernel (dense N=2,000, value and
gradient with and without ``ram_economy``, the central-difference Hessian
at N=500) and the default kernel's committed-state formula gradient against
its autograd gradient; scipy tridiagonal noise on a dense model (N=2,000);
a diagonal gp2Scale noise callable whose posterior runs on K2 (N=4,096,
counted); a non-Euclidean dense and gp2Scale GP (N=2,048 ragged
sequences); fvGP at 500 x 3 tasks with NaN gaps — and on the card alone the
same tridiagonal noise on a stored gp2Scale K (N=10,240): its merged K+V
against the dense float64 oracle, its SLQ LML (counted) against the exact
one; 6d. the multi-task climate configuration at full width (BASELINE
config 2: 2,500 inputs x 4 tasks, default kernel on K3, LML+gradient,
``train("local", 3)``, mean and variance at 500 x 4); 6e. the formula
gradient at the dense cell (N=10^4, ``ram_economy`` off and on, against
autograd) and a host kernel's value + gradient at N=4,000; 9b. structured
noise at N=10^6 on the stored-K journey's configuration (``from_scipy`` +
``merge`` + row sort timed alone; counted: a trial LML, mean and variance
at 64 points; then K1 on the merged float32 K+V against the plain product);
9c. non-Euclidean gp2Scale at N=4,096 ragged sequences (LML, posterior at
64 objects, an append of 64, counted).

Since the extensions slice also: 9d. the extensions against the CPU in
float64 at N <= 2,000 (``extensions_cross_check``: the deep-kernel GP, GPm,
GPLVM, GGMP at 1,000 stations with its EM weights, and the batched GGMP
path against the per-GP path on the card); 9e. the extensions at full
width, each call counted (``extensions_phases``): (a) the deep-kernel GP,
BASELINE config 4, at N = 10,000, D = 2 (LML+gradient, ``hgdl``, mean and
variance at 500 points; no K3 launch expected), (b) GPm at N = 10,000,
D = 6, Q = 3, L = 1 (LML, 20 Adam steps, mean and variance), (c) GPLVM at
N = 10,000, Q = 5, L = 1 (20 Adam steps, ``local``, mean, variance, both
latent gradients, entropy and mutual information at 500 latent points),
(d) GGMP at 5,000 stations x K = 3 and at 2,000 stations x 2 tasks on
fvGP components, per-GP and batched (initialization, ``local`` training
with density EM, mean, variance and pdf at 500 points).

Since the mesh slice (ROADMAP item 1.8, first part) also: in phase 3, K1
with its own output block count (rank 0 of 2 at the N=1M structure: its
rows against the gathered X of every block) against its plain version,
timed beside it and the rank's rectangular BSR ``torch.sparse.mm``; 10.
the mesh phase (``mesh_phase``), spawned ranks on the card: 2 gloo ranks
sharing it run the N=10,000 journey of phase 4 in float32 and with
bfloat16 streaming, held against one rank on the card and against phase
4's CPU float64 reference at the same probes, then the N=1M journey's
configuration of phase 7 across both ranks (construction, LML+gradient
twice, posterior_mean on 500 points; counted, times labelled as two ranks
time-sliced on one card); then side by side 4 gloo ranks as a 2 x 2 mesh
with the hierarchical halo forced and a one-rank NCCL world, each at
N=10,000 in float32 against the CPU.

Since the mesh slice's second part (ROADMAP item 1.8: the stored K over
the ranks) also: in phase 3, K1 with ``nb_out`` where the row-owned stored
N=1M K puts it (rank 0 of 2, bfloat16 storage, X as two bfloat16 halves,
k = 1 and 4) against its plain version, timed beside it and the rank's
BSR ``torch.sparse.mm``; in phase 10's pair world, the stored K at
N=10,240 in sparseCGpre, sparseMINRESpre, sparseCGpre_amg,
sparseCGpre_schwarz and sparseLU (float32) and sparseCGpre with bfloat16
storage — ``K @ X``, a trial LML, the full posterior covariance at 32
points — held bitwise across the ranks, against rank 0 alone and against
the CPU in float64 (computed by the parent while the ranks work), an
aligned 1,024-point append timed on both; then, after the N=1M journey,
the stored-K journey's configuration of phase 9 across both ranks
(assembly, a trial LML, a 64-point full covariance; counted), with the
recompute of a 1,024-point append.

Since the examples slice (ROADMAP item 1.9 and the last of item 1.8)
also: 11. the examples phase (``examples_phase``): the nine examples of
``fvgp_tpu_torch/examples`` on the card at the JAX examples' accelerator
sizes (``gp2scale_sparse`` at N = 20,000), each ``main()`` counted —
seconds, peak device memory, K1-K4 launches — ``multichip_mesh`` as 4
gloo ranks sharing the card (bitwise across the ranks); each example's
numbers at its first hyperparameters held against the same example in
float64 on the CPU (computed by a process of its own meanwhile) at the
PERF.md §2 bounds of its path, and the dense-family examples' in float64
on the card at 1e-8; 12. the kernel catalog's new functions on the card
(float64 and float32) against the CPU in float64, the ``_sparse``
Wendland kernel, ``covariance_csr`` evaluating on the card, the op-level
``assemble_tiles`` / ``tile_maxabs``; 13. ``train_async`` (``"adam"``,
``"mcmc"``, a stop) on 2 gloo ranks sharing the card, every poll bitwise
equal across the ranks.

Since the tier-objects slice also: 14. the tier phase (``tier_phase``): the
members of ``gp.kv``, ``gp.marginal_likelihood`` and ``gp.posterior`` on
the dense cell's model (N = 10^4, ``Chol``, float32) and on the stored K at
N = 10,240 (``sparseCGpre``, bfloat16 storage), their array inputs given
as host numpy arrays: ``compute_new_KVlogdet_KVinvY`` of both tiers,
``posterior.KVinvY`` / ``K`` / ``m``, ``addKV``, a custom ``[factor,
solve, logdet]`` mode through ``GP`` and ``resolve_linalg_mode``,
``default_matern_ard`` / ``wendland_anisotropic`` on the data as a card
tensor, and the host-made operands fed to the float32 model on the card
(``addKV`` of host K and V into ``compute_new_KVinvY``, ``default_matern_ard``
of numpy alone into ``compute_new_KVlogdet_KVinvY``), each held against the facade's own values at the PERF.md §2
float32 / stored-K bounds; counted as one path.

K4's entry point, phases 6-6e, 7-7c, 9-9c, 9e, 10's two N=1M journeys,
the nine examples of 11, the two counted pieces of 5d and 14 are the paths:
every kernel's launch counter is reset just before each and read just
after it, and the ``launches`` of a kernel is its sum over them.  K5's two
kernels are counted beside K1-K4 (``replaces`` null) and must launch on the
gp2Scale journey (the committed solver's assembly, its first
``posterior_mean``, counted on its own), under its training and on each
rank of the N=1M mesh journey.  The line before the
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
# every counted kernel and the Pallas kernel it replaces (K5 replaces none:
# the JAX package assembles the gp2Scale tiles in jnp)
REPLACES = {"chunked_spmm": "fvgp_tpu/ops/pallas_kernels.py:180",
            "row_chunk_sums": "fvgp_tpu/ops/pallas_kernels.py:354",
            "dense_covariance": "fvgp_tpu/ops/pallas_kernels.py:437",
            "block_spmv": "fvgp_tpu/ops/pallas_kernels.py:84",
            "tile_covariance": None, "tile_covariance_vjp": None}
K5 = ("tile_covariance", "tile_covariance_vjp")
# kernel vs plain version: both read identical (bf16-rounded) inputs and
# accumulate in float32, only in another order — 1e-4 of the output scale
KERNEL_RTOL = 1e-4
# K4 writes bfloat16: the two float32 sums may round to neighbouring
# bfloat16 values (one ulp is 2^-8 relative) — 1e-2 of the output scale
K4_BF16_RTOL = 1e-2
# float32 K2 (3xTF32) against float64 sums of the same products: within
# twice the plain float32 version's own error, or 1e-6 (about eight float32
# ulps) of the output's scale where that error is smaller — the bound that
# tests/test_torch_k2_body.py holds the body to
K2_F64_RTOL = 1e-6
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
        m = re.search(r"Compiling entry function '\w*?((?:segment_mma_"
                      r"kernel_wgmma_tf32|(?:segment_mma|chunk_sums_wgmma|"
                      r"dense_cov|tile_cov|tile_cov_vjp)_kernel)I\w*?E)Ev",
                      line)
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
    """Every counted kernel's launch counter, read now."""
    from fvgp_tpu_torch.ops import hopper_kernels as hk
    return {name: getattr(hk, name).launches for name in REPLACES}


def bsr_library_ms(rows, cols, tiles, X, nb, B, nb_out=None):
    """Time of one ``torch.sparse.mm`` of a ``sparse_bsr_tensor`` built
    once (build excluded) from the live tiles — the library call that
    computes K1's and K4's product (``nb_out`` row blocks against X's
    ``nb``; default square) — or None where the library refuses the
    dtype.  Timed here only; the port never calls it."""
    import torch
    nb_out = nb if nb_out is None else nb_out
    live = (rows < nb_out) & (cols < nb)
    r, c, t = rows[live], cols[live], tiles[live]
    order = torch.argsort(r.long() * (nb + 1) + c.long())
    r, c, t = r[order], c[order], t[order]
    crow = torch.searchsorted(r, torch.arange(nb_out + 1, device=r.device,
                                              dtype=r.dtype))
    try:
        A = torch.sparse_bsr_tensor(crow.to(torch.int64), c.to(torch.int64),
                                    t.contiguous(),
                                    size=(nb_out * B, nb * B))
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


def _max_err(a, b, step=16384):
    """max |a - b| in float32, a slice of tiles at a time."""
    return max(float((a[s:s + step].float() - b[s:s + step].float())
                     .abs().max()) for s in range(0, len(a), step))


def k5_flops(D):
    """float32 operations a tile value of K5 (forward, VJP), counted as
    the kernels write them, an fma as 2: the D differences and their fma
    sums, the square root, the Wendland polynomial's powers and Horner
    steps, the variance and both masks; the VJP adds the cotangent's
    weight, the second polynomial and the 1 + D sums."""
    return 3 * D + 15, 6 * D + 24


def k5_cases(x, nb, rows_p, cols_p, hps, B, device):
    """K5 at a training structure: the tile assembly and its VJP, in
    float32 and bfloat16 tiles, each against its plain version (the
    forward's max error over the signal variance, the VJP's relative
    error), timed beside it; bound by the live tiles' bytes, written once
    (the forward) or read once (the VJP), or by ``k5_flops`` at the
    float32 peak where that is larger.  Returns {tiles dtype: (forward
    record, VJP record)}."""
    import torch

    from fvgp_tpu_torch.ops import hopper_kernels as hk
    from fvgp_tpu_torch.ops.sparse_lml import make_padded_inputs
    xb, mask, _, _, _ = make_padded_inputs(x, np.zeros(len(x)),
                                           np.ones(len(x)), B,
                                           dtype=torch.float32, device=device)
    r = torch.as_tensor(rows_p).to(device)
    c = torch.as_tensor(cols_p).to(device)
    live = (r < nb) & (c < nb)
    rc, cc = r.clamp(max=nb - 1), c.clamp(max=nb - 1)
    h = torch.as_tensor(hps, dtype=torch.float32).to(device)
    n_live = int(live.sum())
    ops_fwd, ops_vjp = (n_live * B * B * f for f in k5_flops(x.shape[1]))
    gen = torch.Generator(device=device).manual_seed(5)
    out = {}
    for name, tdt in (("float32", torch.float32),
                      ("bfloat16", torch.bfloat16)):
        args = (xb, mask, rc, cc, live, h)
        n_bytes = n_live * B * B * torch.finfo(tdt).bits // 8
        tiles = hk.tile_covariance(*args, tdt)
        ref = hk.tile_covariance_reference(*args, tdt)
        err = _max_err(tiles, ref) / float(h[0])
        del ref
        ms = cuda_ms(lambda: hk.tile_covariance(*args, tdt))
        plain_ms = cuda_ms(lambda: hk.tile_covariance_reference(*args, tdt),
                           reps=2, warmup=1)
        fwd = record(err, ms, plain_ms, n_bytes, ops_fwd, "float32", None)
        del tiles
        tbar = torch.randn((len(r), B, B), generator=gen, device=device,
                           dtype=torch.float32).to(tdt)
        g = hk.tile_covariance_vjp(*args, tbar).double()
        g_ref = hk.tile_covariance_vjp_reference(*args, tbar).double()
        rel = float(torch.linalg.norm(g - g_ref) / torch.linalg.norm(g_ref))
        ms = cuda_ms(lambda: hk.tile_covariance_vjp(*args, tbar))
        plain_ms = cuda_ms(lambda: hk.tile_covariance_vjp_reference(
            *args, tbar), reps=2, warmup=1)
        vjp = record(rel, ms, plain_ms, n_bytes, ops_vjp, "float32", None)
        del tbar
        torch.cuda.empty_cache()
        log(f"K5 tile_covariance [{name} tiles, B={B}, T={len(r)}, live "
            f"{n_live}]: max_err/var {err:.3e}; kernel {fwd['ms']:.4f} ms, "
            f"plain {fwd['plain_ms']:.4f} ms; {share(fwd)}")
        log(f"K5 tile_covariance_vjp [{name} tiles]: rel_err {rel:.3e}; "
            f"kernel {vjp['ms']:.4f} ms, plain {vjp['plain_ms']:.4f} ms; "
            f"{share(vjp)}")
        if not (err <= 1e-5 if name == "float32" else err <= 2.0 ** -7):
            raise AssertionError(f"K5 ({name}) disagrees with its plain "
                                 f"version: {err}")
        if not rel <= 1e-4:
            raise AssertionError(f"K5 VJP ({name}) disagrees with its plain "
                                 f"version: {rel}")
        out[name] = (fwd, vjp)
    return out


def k1_rank_case(x, nb, rows_p, cols_p, hps, B, k, gen, device):
    """K1 with its own output block count: rank 0's rows of the N=1M
    journey's structure over two ranks (the blocking padded to a multiple
    of 2 and partitioned by row ownership, as the mesh facade does; Morton
    order keeps the two equal ranges within the layout's 5% balance)
    against the gathered X of every block — the mesh SpMM's local tail
    under the all-gather.  Held against its plain version, timed beside it
    and the rank's rectangular BSR ``torch.sparse.mm``; bound from the
    rank's live tiles, X and the rank's float32 output, each once."""
    import torch

    from fvgp_tpu_torch.ops import hopper_kernels as hk
    from fvgp_tpu_torch.parallel.partition import partition_schedule
    n_dev = 2
    nb2 = -(-nb // n_dev) * n_dev
    W = nb2 // n_dev
    live = rows_p < nb
    rp, cp, _, per = partition_schedule(rows_p[live], cols_p[live], nb2,
                                        n_dev)
    tiles, r, c = assemble(x, nb, B, rp[:per], cp[:per], hps,
                           torch.bfloat16, torch.float32, device)
    r_loc = torch.where(r < W, r, torch.full_like(r, W))
    cc = c.clamp(max=nb - 1)
    X = torch.randn((nb2 * B, k), generator=gen).to(device)
    mvd = torch.bfloat16
    got = hk.chunked_spmm(r_loc, cc, tiles, X, nb2, B, mv_dtype=mvd,
                          nb_out=W)
    ref = hk.chunked_spmm_reference(r_loc, cc, tiles, X, nb2, B,
                                    mv_dtype=mvd, nb_out=W)
    square = hk.chunked_spmm(r_loc, cc, tiles, X, nb2, B, mv_dtype=mvd)
    if got.shape != (W * B, k) or not torch.equal(got, square[:W * B]):
        raise AssertionError("K1 with nb_out is not the square launch's "
                             "first rows")
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    tol = KERNEL_RTOL * scale
    del got, ref, square
    ms = cuda_ms(lambda: hk.chunked_spmm(r_loc, cc, tiles, X, nb2, B,
                                         mv_dtype=mvd, nb_out=W))
    plain_ms = cuda_ms(lambda: hk.chunked_spmm_reference(
        r_loc, cc, tiles, X, nb2, B, mv_dtype=mvd, nb_out=W), reps=3)
    lib_ms = bsr_library_ms(r_loc, cc, tiles, X, nb2, B, nb_out=W)
    n_live = int((r < W).sum())
    rec = spmm_record(err, ms, plain_ms,
                      n_live * B * B * tiles.element_size()
                      + nb2 * B * k * 4 + W * B * k * 4 + 8 * n_live,
                      2 * n_live * B * B * k, "bfloat16", lib_ms)
    log(f"K1 chunked_spmm [rank 0 of 2 at the N=1M structure, nb_out={W} "
        f"of nb={nb2}, B={B}, k={k}, T={per}, live {n_live}]: max_abs_err "
        f"{err:.3e} (tol {tol:.3e}); kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library {lib_ms} ms (rectangular BSR); "
        f"{share(rec)}")
    if not (err <= tol):
        raise AssertionError(f"K1 (nb_out) disagrees with its plain "
                             f"version: {err} > {tol}")
    return rec


def k1_stored_rank_cases(x, nb, rows_p, cols_p, hps, B, gen, device):
    """K1 with ``nb_out`` where the row-owned stored K puts it: rank 0 of 2
    of the stored N=1M K (bfloat16 storage, ``W = ceil(nb / 2)`` row blocks
    of the unpadded grid, ``mesh.owned_rows``) against the whole X, which
    ``BlockSparseMatrix`` splits into two bfloat16 halves — the operands
    that ``_bsm_matmat`` hands the wrapper under a mesh, at k = 1 (CG) and
    k = 4 (the SLQ batch at N=1M).  Held against the plain version on the
    same operands, timed beside it and the rank's rectangular BSR
    ``torch.sparse.mm`` of the 2k bfloat16 columns; the bound counts the
    rank's live tiles, the indices, X and the rank's float32 output once
    and 2k columns of products, as ``stored_matmat_case`` does."""
    import torch

    from fvgp_tpu_torch.ops import hopper_kernels as hk
    W = -(-nb // 2)
    mine = rows_p < W
    tiles, r, c = assemble(x, nb, B, rows_p[mine], cols_p[mine], hps,
                           torch.bfloat16, torch.float32, device)
    r_loc = torch.where(r < W, r, torch.full_like(r, W))
    cc = c.clamp(max=nb - 1)
    n_live = int((r < W).sum())
    mvd = torch.bfloat16
    out = {}
    for k in (1, 4):
        X = torch.randn((nb * B, k), generator=gen).to(device)
        hi = X.to(torch.bfloat16).float()
        Xs = torch.cat([hi, X - hi], 1)

        def launch():
            y = hk.chunked_spmm(r_loc, cc, tiles, Xs, nb, B, mv_dtype=mvd,
                                nb_out=W)
            return y[:, :k] + y[:, k:]

        got = launch()
        y = hk.chunked_spmm_reference(r_loc, cc, tiles, Xs, nb, B,
                                      mv_dtype=mvd, nb_out=W)
        ref = y[:, :k] + y[:, k:]
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        tol = KERNEL_RTOL * scale
        del got, ref, y
        ms = cuda_ms(launch)
        plain_ms = cuda_ms(lambda: hk.chunked_spmm_reference(
            r_loc, cc, tiles, Xs, nb, B, mv_dtype=mvd, nb_out=W), reps=3)
        lib_ms = bsr_library_ms(r_loc, cc, tiles, Xs, nb, B, nb_out=W)
        rec = spmm_record(err, ms, plain_ms,
                          n_live * B * B * tiles.element_size()
                          + nb * B * k * 4 + W * B * k * 4 + 8 * n_live,
                          2 * n_live * B * B * 2 * k, "bfloat16", lib_ms)
        log(f"K1 chunked_spmm [the stored N=1M K, rank 0 of 2: nb_out={W} "
            f"of nb={nb}, B={B}, k={k} as two bfloat16 halves, T="
            f"{len(r)}, live {n_live}]: max_abs_err {err:.3e} (tol "
            f"{tol:.3e}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {lib_ms} ms (rectangular BSR, 2k columns); "
            f"{share(rec)}")
        if not (err <= tol):
            raise AssertionError(f"K1 (stored, nb_out, k={k}) disagrees "
                                 f"with its plain version: {err} > {tol}")
        out[f"k{k}"] = rec
    return out


def k2_case(label, tiles, cc, Xb, B, C, n_chunks, nb):
    """K2 against its plain version, timed beside the plain version and
    the library yardstick: one ``torch.einsum('ncij,ncjk->nik')`` over the
    tiles and the X blocks gathered through cols beforehand (the gather
    excluded, as the BSR build is for K1; cuBLAS writes the input dtype).
    Bound: live tiles, cols, X and the float32 output, each once.  Float32
    also gives the kernel's and the plain version's errors against float64
    (:func:`k2_float64_check`)."""
    import torch

    from fvgp_tpu_torch.ops import hopper_kernels as hk
    c_w = Xb.shape[2]
    got = hk.row_chunk_sums(tiles, cc, Xb, B, C=C)
    ref = hk.row_chunk_sums_reference(tiles, cc, Xb, B, C=C)
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    tol = KERNEL_RTOL * scale
    err64 = (k2_float64_check(f"{label}, c={c_w}", got, ref,
                              k2_float64(tiles, cc, Xb, B, C))
             if tiles.dtype == torch.float32 else None)
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
    if err64 is not None:
        rec["float64_err"] = err64
    f64_line = (f"; against float64 {json.dumps(err64)}" if err64 else "")
    log(f"K2 row_chunk_sums [{label}, B={B}, C={C}, c={c_w}, n_chunks="
        f"{n_chunks}]: max_abs_err {err:.3e} (tol {tol:.3e}); kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library "
        f"{lib_ms:.4f} ms (einsum over gathered X, max_abs_err "
        f"{lib_err:.3e}); {share(rec)}{f64_line}")
    if not (err <= tol):
        raise AssertionError(f"K2 ({label}) disagrees with its plain "
                             f"version: {err} > {tol}")
    if not (lib_err <= K4_BF16_RTOL * scale):
        raise AssertionError(f"the K2 library yardstick ({label}) computes "
                             f"another function: {lib_err}")
    return rec


def k2_float64_check(label, got, plain, f64):
    """Float32 K2's max error against float64, and the plain version's;
    raises past the limit of :data:`K2_F64_RTOL`."""
    err = {"kernel": float((got.double() - f64).abs().max()),
           "plain": float((plain.double() - f64).abs().max()),
           "scale": float(f64.abs().max())}
    lim = max(2.0 * err["plain"], K2_F64_RTOL * err["scale"])
    if not err["kernel"] <= lim:
        raise AssertionError(f"float32 K2 ({label}) is less accurate than "
                             f"float32 against float64: {err}, limit {lim}")
    return err


def k2_float64(tiles, cc, Xb, B, C):
    """K2's function in float64, a chunk at a time."""
    import torch
    nb = Xb.shape[0]
    out = []
    for s in range(0, tiles.shape[0], 512 * C):
        t = tiles[s:s + 512 * C].double()
        xg = Xb[cc[s:s + 512 * C].long().clamp(max=nb - 1)].double()
        out.append(torch.bmm(t, xg).view(-1, C, B, Xb.shape[2]).sum(1))
    return torch.cat(out)


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
    records["k5"] = k5_cases(x, nb, rows_p, cols_p, hps1, B1, device)
    # the kernels line: the float32 tiles of the benchmark's configuration
    records["tile_covariance"], records["tile_covariance_vjp"] = \
        records["k5"]["float32"]
    records["k1_rank"] = k1_rank_case(x, nb, rows_p, cols_p, hps1, B1, k,
                                      gen, device)
    torch.cuda.empty_cache()
    records["k1_stored_rank"] = k1_stored_rank_cases(x, nb, rows_p, cols_p,
                                                     hps1, B1, gen, device)
    torch.cuda.empty_cache()
    # ---- K2 at committed-solver shapes: c=128 in both dtypes; in
    # bfloat16 the N=1M journey's widths (posterior mean 8, variance 512)
    # and the stored-K journey's (a 64-point full covariance: 64); in
    # float32 the gp2scale-predict cell's widths (its variance solve
    # starts at 512 columns and drops converged ones down to 8)
    B, C = 128, 8
    hps2 = np.array([1.0, 2.0, 2.0, 2.0])
    x, nb, rows_p, cols_p = bench_structure(N, B, hps2, seed=1)
    live = rows_p < nb
    rows_a, cols_a, rowsc, n_chunks = hk.row_aligned_schedule(
        rows_p[live], cols_p[live], nb, C=C)
    records["k2"] = {}
    for name, tdt, widths in (("bfloat16", torch.bfloat16,
                               (128, 8, 512, 64)),
                              ("float32", torch.float32, (128, 512, 256, 8))):
        tiles, r, cc = assemble(x, nb, B, rows_a, cols_a, hps2, tdt,
                                torch.float32, device)
        for c_w in widths:
            Xb = torch.randn((nb, B, c_w), generator=gen).to(tdt).to(device)
            records["k2"][f"{name} c={c_w}"] = k2_case(name, tiles, cc, Xb,
                                                       B, C, n_chunks, nb)
            del Xb
        del tiles
    # the kernels line: the float32 variance width of the benchmark's
    # gp2scale-predict configuration
    records["row_chunk_sums"] = records["k2"]["float32 c=512"]
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
    """LML+grad, posterior mean and variance through the public GP, and
    the model."""
    from fvgp_tpu_torch import GP
    gp = GP(x, y, init_hyperparameters=hps,
            noise_variances=np.full(len(x), 1e-2), gp2Scale=True,
            compute_device=device, linalg_mode="sparseCGpre", args=args)
    val, grad = gp.marginal_likelihood.log_likelihood_value_and_gradient(hps)
    mean = gp.posterior_mean(xp)["m(x)"]
    var = gp.posterior_covariance(xp, variance_only=True)["v(x)"]
    return val, grad, mean, var, gp


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
    models = {"ref": ref[4]}
    for name, extra in (("float32", {}),
                        ("bfloat16", {"gp2Scale_solver_dtype": "bfloat16"})):
        t0 = time.time()
        got = run_journey(x, y, xp, hps, "cuda", {**base, **extra})
        models.setdefault("card", got[4])
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
    adam_chain_cross_check(models, hps)
    return ref[:4]


def slice_cross_check():
    """The gp2Scale solver options at N=10,000: the SLQ training solver's
    LML and gradient and the two-level posterior variance (64 points) on
    CUDA, float32 and bfloat16 streaming, against the CPU in float64 at the
    same probes (fresh models draw the same seeds); then the gp2Scale
    Hessian (mBCG, central differences of 8 gradients) in float32 at
    N=2,500 (its CPU float64 reference took ~50 s of the smoke at
    N=10,000)."""
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

    def model(device, extra, x=x, y=y):
        return GP(x, y, init_hyperparameters=hps,
                  noise_variances=np.full(len(x), 1e-2), gp2Scale=True,
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
    hess, N = {}, 2_500
    xh, yh, _ = journey_data(N, seed=2)
    for device in ("cpu", "cuda"):
        t0 = time.time()
        hess[device] = model(device, {}, xh, yh).marginal_likelihood \
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


def dense_model(x, y, hps, device, args=None):
    from fvgp_tpu_torch import GP
    return GP(x, y, init_hyperparameters=hps,
              noise_variances=np.full(len(x), 1e-2), compute_device=device,
              linalg_mode="Chol", args=args)


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
    api_launches = dense_api_phase(gp, xp, lambda: dense_model(
        x, y, gp.hyperparameters, "cuda", {"dtype": "float64"}))
    return launches, api_launches, dense_training_phase(gp)


# ---------------------------------------------------------------------------
# the posterior and information API (the methods an experiment loop calls
# after every fit)
# ---------------------------------------------------------------------------

# each output against the CPU in float64, as its largest absolute error over
# the largest |output| ("of the scale").  Set before the first run on the
# card from the same comparison on the CPU, float32 against float64 (plain
# versions, dense N=2,000, 64 points): about 30x the CPU's float32 error,
# at least 1e-4 (CPU float32: mean gradient 7.2e-6, variance gradient
# 4.4e-6, KL 5.6e-7, RIE 2.6e-6, per-point RIE 1.7e-5, probability 2.5e-5,
# its mean 4.6e-6, joint gradient 1.1e-6, entropy 1.8e-7, its gradient
# 2.7e-5, mutual information 2.1e-6, total correlation 4.6e-6, metrics
# <= 4.3e-6).  A coverage fraction moves by 1/64 per point that crosses an
# interval's edge: two points allowed.  The difference quotients of
# k(x*, x*) are taken in float64 in both.  Float64 on the card against the
# CPU: 1e-10, and 1e-8 for the outputs built from the quotients (they divide
# ~1e-16 of K3 against the plain formula by 1e-6, and the entropy gradient
# multiplies by ~S⁻¹).  Tightened from 1e-6 after the first two runs on the
# card (H100, 700 W) measured at most 7.1e-14 and, for the quotients,
# 1.3e-10, so that a float32 computation (CPU float32 >= 1.8e-7 above) fails.
_COVERAGE = {"picp": 0.05, "coverage_curve": 0.05}
_QUOTIENTS = ("posterior_covariance_grad", "joint_gp_prior_grad",
              "gp_entropy_grad")
API_BOUNDS = {
    "float32": {"posterior_mean_grad": 3e-4, "posterior_covariance_grad": 2e-4,
                "gp_kl_div": 1e-4, "gp_relative_information_entropy": 1e-4,
                "gp_relative_information_entropy_set": 5e-4,
                "posterior_probability": 8e-4,
                "posterior_probability_mu": 2e-4,
                "joint_gp_prior_grad": 1e-4, "gp_entropy": 1e-4,
                "gp_entropy_grad": 1e-3, "gp_mutual_information": 1e-4,
                "gp_total_correlation": 2e-4, "crps": 1e-4, "nrmse": 1e-4,
                "nlpd": 1e-4, "mpiw": 1e-4, "interval_score": 1e-4,
                "mae": 2e-4, "mape": 2e-4, "msll": 1e-4, "gaussian_1d": 1e-4,
                **_COVERAGE},
    "float64": {}}
API_BOUNDS["float64"] = {**dict.fromkeys(API_BOUNDS["float32"], 1e-10),
                         **dict.fromkeys(_QUOTIENTS, 1e-8), **_COVERAGE}
# gp2Scale N=10,000, float32 against the CPU in float64: the committed CG's
# exit sets the error (CPU float32: mean gradient 2.3e-4, variance gradient
# 4.8e-6, RIE 1.5e-5 of the scale)
GP2_API_BOUNDS = {"posterior_mean_grad": 1e-2,
                  "posterior_covariance_grad": 1e-3,
                  "gp_relative_information_entropy": 1e-3}
# ∂k/∂x (forward-mode AD, exact) on the card against the CPU in float64, of
# the scale: float32 rounds the inputs and the kernel (CPU float32 ~1e-6)
D_KERNEL_DX_BOUNDS = {"float32": 1e-4, "float64": 1e-10}
# a pickled and loaded GP against the one pickled (same device, same
# arithmetic)
PICKLE_BOUND = 1e-6


def host64(t):
    return t.detach().cpu().double().numpy()


def api_test_points(xp, n_pred, n_test):
    """Prediction points, and test points with their noiseless targets (the
    dense cell's function)."""
    x_test = xp[n_pred:n_pred + n_test]
    y_test = np.sin(x_test[:, 0]) + 0.25 * x_test[:, 1]
    return xp[:n_pred], x_test, y_test


# The 23 new methods: name -> (the public call on (gp, xp, comp, x_test,
# y_test), the keys of its return value that are held).  The cross-checks
# and the two counted phases all read this one table.  None holds the
# return value itself; a second key is held as "<name>_<key>".  The plot
# draws nothing to compare.  The joint-prior family factors or slogdets
# K + 1e-9 I, which the dense cell's N=10,000 makes numerically singular in
# float32: in the dense phase it is measured against the card's float64.
API_CALLS = {
    "posterior_mean_grad":
        (lambda gp, xp, comp, xt, yt: gp.posterior_mean_grad(xp), ("dm/dx",)),
    "posterior_covariance_grad":
        (lambda gp, xp, comp, xt, yt: gp.posterior_covariance_grad(xp),
         ("dv/dx",)),
    "joint_gp_prior_grad":
        (lambda gp, xp, comp, xt, yt: gp.joint_gp_prior_grad(xp, 0),
         ("dS/dx",)),
    "gp_entropy": (lambda gp, xp, comp, xt, yt: gp.gp_entropy(xp), None),
    "gp_entropy_grad":
        (lambda gp, xp, comp, xt, yt: gp.gp_entropy_grad(xp, 0), None),
    "gp_mutual_information":
        (lambda gp, xp, comp, xt, yt: gp.gp_mutual_information(xp),
         ("mutual information",)),
    "gp_total_correlation":
        (lambda gp, xp, comp, xt, yt: gp.gp_total_correlation(xp),
         ("total correlation",)),
    "gp_kl_div":
        (lambda gp, xp, comp, xt, yt: gp.gp_kl_div(xp, *comp), ("kl-div",)),
    "gp_relative_information_entropy":
        (lambda gp, xp, comp, xt, yt: gp.gp_relative_information_entropy(xp),
         ("RIE",)),
    "gp_relative_information_entropy_set":
        (lambda gp, xp, comp, xt, yt:
            gp.gp_relative_information_entropy_set(xp[:8]), ("RIE",)),
    "posterior_probability":
        (lambda gp, xp, comp, xt, yt: gp.posterior_probability(xp, *comp),
         ("probability", "mu")),
    "crps": (lambda gp, xp, comp, xt, yt: gp.crps(xt, yt), (0,)),
    "nrmse": (lambda gp, xp, comp, xt, yt: gp.nrmse(xt, yt), None),
    "nlpd": (lambda gp, xp, comp, xt, yt: gp.nlpd(xt, yt), None),
    "picp": (lambda gp, xp, comp, xt, yt: gp.picp(xt, yt), None),
    "coverage_curve":
        (lambda gp, xp, comp, xt, yt: gp.coverage_curve(xt, yt),
         ("measured_coverage",)),
    "mpiw": (lambda gp, xp, comp, xt, yt: gp.mpiw(xt), None),
    "interval_score":
        (lambda gp, xp, comp, xt, yt: gp.interval_score(xt, yt), None),
    "mae": (lambda gp, xp, comp, xt, yt: gp.mae(xt, yt), None),
    "mape": (lambda gp, xp, comp, xt, yt: gp.mape(xt, yt), None),
    "msll": (lambda gp, xp, comp, xt, yt: gp.msll(xt, yt), None),
    "plot_observed_vs_predicted":
        (lambda gp, xp, comp, xt, yt: gp.plot_observed_vs_predicted(xt, yt),
         ()),
    "gaussian_1d":
        (lambda gp, xp, comp, xt, yt: gp.gaussian_1d(yt, 0.1, 0.7), None)}
JOINT_FAMILY = ("joint_gp_prior_grad", "gp_entropy", "gp_entropy_grad",
                "gp_mutual_information", "gp_total_correlation")
HELD = tuple(name for name, (_, keys) in API_CALLS.items() if keys != ())


def api_outputs(name, out):
    """The held outputs of ``name``'s return value ``out``, by name."""
    keys = API_CALLS[name][1]
    if keys is None:
        return {name: out}
    return {name if i == 0 else f"{name}_{k}": out[k]
            for i, k in enumerate(keys)}


def api_values(gp, args, names=HELD):
    """The held outputs of ``names`` at ``args = (xp, comp, x_test,
    y_test)`` as float64 arrays, by name."""
    out = {}
    for name in names:
        out.update(api_outputs(name, API_CALLS[name][0](gp, *args)))
    return {k: np.asarray(v, dtype=np.float64) for k, v in out.items()}


def scale_err(got, ref):
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def held(tag, errs, bounds):
    """Log each error beside its bound; raise where one is exceeded (names
    without a bound are measured only)."""
    log(f"{tag}: " + ", ".join(
        f"{k} {v:.3e}" + (f" (bound {bounds[k]:g})" if k in bounds
                          else " (measured)") for k, v in errs.items()))
    bad = [k for k, v in errs.items() if k in bounds and not v <= bounds[k]]
    if bad:
        raise AssertionError(f"{tag} out of bounds: {bad}")


def posterior_api_cross_check(card="cuda"):
    """The posterior API on the card against the CPU in float64: at dense
    N=2,000 every new method in float32 and float64, ``kernel_dtype=
    "float32"`` under float64, a custom mode on ``torch.linalg.cholesky``
    and a pickle round trip; at gp2Scale N=10,000 (float32) the posterior
    gradients and the relative information entropy.  ``card="cpu"`` (with
    the plain versions) rehearses the comparison."""
    import pickle

    import torch

    from fvgp_tpu_torch import GP
    from fvgp_tpu_torch.ops import hopper_kernels as hk
    x, y, xp_all = dense_cell_data(2_000, seed=8)
    xp, x_test, y_test = api_test_points(xp_all, 64, 64)
    hps = np.array([1.0, 1.5, 1.5, 1.5])

    def model(device, **kw):
        return GP(x, y, init_hyperparameters=hps,
                  noise_variances=np.full(len(x), 1e-2),
                  compute_device=device, linalg_mode=kw.pop("mode", "Chol"),
                  **kw)

    t0 = time.time()
    ref_gp = model("cpu")
    ref_mean = ref_gp.posterior_mean(xp)["m(x)"]
    comp = (ref_mean + 0.01 * np.random.default_rng(3).standard_normal(64),
            0.05 * np.eye(64))
    args = (xp, comp, x_test, y_test)
    ref = api_values(ref_gp, args)
    log(f"posterior API cross-check N=2000: CPU float64 "
        f"{time.time() - t0:.2f} s; " + ", ".join(
            f"{k} {float(np.ravel(ref[k])[0]):.6g}" for k in
            ("gp_entropy", "gp_kl_div", "gp_relative_information_entropy",
             "gp_total_correlation", "posterior_probability")))
    for dtype in ("float32", "float64"):
        t0 = time.time()
        gp = model(card, args={"dtype": dtype})
        got = api_values(gp, args)
        errs = {k: scale_err(got[k], ref[k]) for k in ref}
        held(f"posterior API N=2000 {card} {dtype} vs CPU float64 "
             f"({time.time() - t0:.2f} s)", errs, API_BOUNDS[dtype])
        # ∂k/∂x by forward-mode AD: K3 must refuse the dual input (its
        # launch would drop the tangent), so no launch and the CPU's value
        launched = hk.dense_covariance.launches
        dk = gp.prior.d_kernel_dx(xp, gp.x_data, 1, hps)
        launched = hk.dense_covariance.launches - launched
        dk_ref = ref_gp.prior.d_kernel_dx(xp, ref_gp.x_data, 1, hps)
        held(f"d_kernel_dx N=2000 x 64 {card} {dtype} vs CPU float64 "
             f"({launched} K3 launches)",
             {"d_kernel_dx": scale_err(host64(dk), host64(dk_ref))},
             {"d_kernel_dx": D_KERNEL_DX_BOUNDS[dtype]})
        if launched:
            raise AssertionError("K3 launched on a dual input")
    # kernel_dtype="float32" under float64 linear algebra: K3 in float32
    launched = hk.dense_covariance.launches
    gp = model(card, args={"dtype": "float64", "kernel_dtype": "float32"})
    launched = hk.dense_covariance.launches - launched
    k_err = float((gp.prior.K.cpu() - ref_gp.prior.K).abs().max())
    lml_err = abs(gp.log_likelihood() - ref_gp.log_likelihood()) \
        / abs(ref_gp.log_likelihood())
    held(f"kernel_dtype=float32 under float64 on {card} ({launched} K3 "
         "launches)", {"K": k_err, "lml": lml_err},
         {"K": 1e-5, "lml": DENSE_BOUNDS["lml"]})
    if not (k_err > 0.0 and (launched > 0 or card == "cpu")):
        raise AssertionError("kernel_dtype did not change the dense sweep")
    # a custom [factor, solve, logdet] on torch tensors of the card
    mode = [torch.linalg.cholesky,
            lambda L, b: torch.cholesky_solve(b.reshape(len(L), -1),
                                              L).reshape(b.shape),
            lambda L: 2.0 * torch.sum(torch.log(torch.diagonal(L)))]
    gp = model(card, mode=mode, args={"dtype": "float32"})
    xn = xp_all[200:264]
    yn = np.sin(xn[:, 0]) + 0.25 * xn[:, 1]
    errs = {"lml": abs(gp.log_likelihood() - ref_gp.log_likelihood())
            / abs(ref_gp.log_likelihood()),
            "var": float(np.abs(
                gp.posterior_covariance(xp, variance_only=True)["v(x)"]
                - ref_gp.posterior_covariance(xp, variance_only=True)["v(x)"]
            ).max())}
    ref_app = model("cpu")
    for m in (gp, ref_app):
        m.update_gp_data(xn, yn, noise_variances_new=np.full(64, 1e-2))
    errs["append_mean"] = float(np.abs(gp.posterior_mean(xp)["m(x)"]
                                       - ref_app.posterior_mean(xp)["m(x)"])
                                .max())
    held(f"custom mode (torch.linalg.cholesky) on {card} float32 vs CPU "
         "float64 Chol", errs, {"lml": DENSE_BOUNDS["lml"],
                                "var": DENSE_BOUNDS["var"],
                                "append_mean": DENSE_BOUNDS["mean"]})
    # a pickle round trip on the card
    gp = model(card)
    before = (gp.log_likelihood(), gp.posterior_mean(xp)["m(x)"],
              gp.posterior_covariance(xp, variance_only=True)["v(x)"])
    blob = pickle.dumps(gp)
    back = pickle.loads(blob)
    after = (back.log_likelihood(), back.posterior_mean(xp)["m(x)"],
             back.posterior_covariance(xp, variance_only=True)["v(x)"])
    errs = {k: scale_err(np.asarray(a), np.asarray(b))
            for k, a, b in zip(("lml", "mean", "var"), after, before)}
    if back.device != gp.device or b"_rebuild_tensor" in blob:
        raise AssertionError("the pickle holds tensors or moved the device")
    held(f"pickle round trip on {card} ({len(blob) / 2**20:.1f} MiB, device "
         f"{back.device})", errs, dict.fromkeys(errs, PICKLE_BOUND))
    gp2scale_api_cross_check(card)


def gp2scale_api_cross_check(card):
    """The gp2Scale posterior gradients and relative information entropy at
    N=10,000 (64 points): the card in float32 against the CPU in float64."""
    from fvgp_tpu_torch import GP
    N = 10_000
    x, y, xp = journey_data(N, seed=2)
    xp = xp[:64]
    hps = np.array([1.0, 2.0, 2.0, 2.0])
    base = {"gp2Scale_block_size": 128, "sparse_cg_maxiter": 64,
            "gp2Scale_structure_cache_dir": False}
    out = {}
    for device, extra in (("cpu", {}), (card, {"dtype": "float32"})):
        t0 = time.time()
        gp = GP(x, y, init_hyperparameters=hps,
                noise_variances=np.full(N, 1e-2), gp2Scale=True,
                compute_device=device, linalg_mode="sparseCGpre",
                args={**base, **extra})
        dtype = extra.get("dtype", "float64")
        out[dtype] = api_values(gp, (xp, None, None, None), GP2_API_BOUNDS)
        log(f"posterior API gp2Scale N={N} {device} {dtype}: "
            f"{time.time() - t0:.2f} s, RIE "
            f"{float(out[dtype]['gp_relative_information_entropy']):.6g}")
    ref, got = out["float64"], out["float32"]
    held(f"posterior API gp2Scale N={N} {card} float32 vs CPU float64",
         {k: scale_err(got[k], ref[k]) for k in ref}, GP2_API_BOUNDS)


def api_phase(tag, gp, names, args, kernel):
    """The public calls ``names`` of ``API_CALLS`` at ``args``, each
    counted on its own (the counts set to 0 just before it, read just
    after): logs seconds, the launches of ``kernel`` and peak device memory
    per call; returns every kernel's summed launches and the held outputs,
    which must be finite."""
    import torch
    total, values, rows = {name: 0 for name in REPLACES}, {}, []
    for name in names:
        torch.cuda.reset_peak_memory_stats()
        val, secs, got = counted(lambda: API_CALLS[name][0](gp, *args))
        for k in REPLACES:
            total[k] += got[k]
        values.update(api_outputs(name, val))
        rows.append({"method": name, "s": round(secs, 4),
                     kernel: got[kernel], "peak_GiB": round(
                         torch.cuda.max_memory_allocated() / 2**30, 2)})
    for row in rows:
        log(f"{tag}: " + json.dumps(row))
    log(f"{tag}: {len(names)} methods, {total[kernel]} {kernel} launches, "
        f"{sum(r['s'] for r in rows):.2f} s in all")
    values = {k: np.asarray(v, dtype=np.float64) for k, v in values.items()}
    bad = [k for k, v in values.items() if not np.all(np.isfinite(v))]
    if bad:
        raise AssertionError(f"{tag}: non-finite {bad}")
    if total[kernel] < 1:
        raise AssertionError(f"{kernel} never launched on the {tag}")
    return total, values


def dense_api_phase(gp, xp_all, model64):
    """All 23 new methods on the dense journey's trained model (N=10,000,
    float32): 200 prediction points (8 for the per-point relative
    information entropy) and 200 test points for the metrics; then,
    uncounted, the joint-prior family on ``model64()``, the same model in
    float64."""
    xp, x_test, y_test = api_test_points(xp_all, 200, 200)
    args = (xp, (gp.posterior_mean(xp)["m(x)"], 0.05 * np.eye(len(xp))),
            x_test, y_test)
    total, values = api_phase("dense N=10000 posterior API", gp, API_CALLS,
                              args, "dense_covariance")
    ref = api_values(model64(), args, JOINT_FAMILY)
    log("dense N=10000 posterior API, the joint-prior family in float32 "
        "against the card's float64 (measured, not held): " + ", ".join(
            f"{k} {float(np.ravel(values[k])[0]):.6g} / "
            f"{float(np.ravel(v)[0]):.6g} ("
            f"{scale_err(values[k], v):.3e} of the scale)"
            for k, v in ref.items()))
    if values["posterior_mean_grad"].shape != (200, 3):
        raise AssertionError("dense posterior API: wrong gradient shape")
    return total


def gp2scale_api_phase(gp, xp_all):
    """The gp2Scale posterior API on the N=1M journey's trained model: the
    posterior gradients, the KL divergence, the relative information
    entropy and the posterior probability on 100 points, four metrics on
    500."""
    xp = xp_all[:100]
    args = (xp, (gp.posterior_mean(xp)["m(x)"], 0.05 * np.eye(len(xp))),
            xp_all, np.sin(0.2 * xp_all[:, 0]))
    names = ("posterior_mean_grad", "posterior_covariance_grad", "gp_kl_div",
             "gp_relative_information_entropy", "posterior_probability",
             "crps", "nlpd", "picp", "msll")
    total, values = api_phase(f"gp2Scale N={len(gp.x_data)} posterior API",
                              gp, names, args, "row_chunk_sums")
    if values["posterior_covariance_grad"].shape != (100, 3):
        raise AssertionError("gp2Scale posterior API: wrong gradient shape")
    return total


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
    for i in range(2):
        val, grad = ml.log_likelihood_value_and_gradient(
            hps * (1.0 + 1e-4 * (i + 1)))
    torch.cuda.synchronize()
    times["lml_grad_s_per_eval"] = (time.time() - t0) / 2
    log(f"N={N}: lml {val:.4f}, grad {np.array2string(grad, precision=4)}")
    bounds = np.array([[0.1, 10.0]] + [[1.5, 2.5]] * 3)
    t0 = time.time()
    trained = gp.train(hyperparameter_bounds=bounds, method="local",
                       max_iter=1)
    torch.cuda.synchronize()
    times["train_local_1_s"] = time.time() - t0
    if not np.all(np.isfinite(trained)):
        raise AssertionError(f"non-finite trained hps {trained}")
    t0 = time.time()
    k5_before = hk.tile_covariance.launches
    pm = gp.posterior_mean(xp)["m(x)"]
    torch.cuda.synchronize()
    times["posterior_mean_500_s"] = time.time() - t0
    committed_k5 = hk.tile_covariance.launches - k5_before
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
        f"launches in this phase: {json.dumps(launches)}; K5 in the "
        f"committed solver's assembly (the first posterior_mean): "
        f"{committed_k5}")
    for name in ("chunked_spmm", "row_chunk_sums", *K5):
        if launches[name] < 1:
            raise AssertionError(f"{name} never launched on the main path")
    if committed_k5 < 1:
        raise AssertionError("the committed solver's assembly did not take "
                             "K5")
    if launches["block_spmv"] != 0:
        raise AssertionError("block_spmv launched on the gp2Scale journey, "
                             "which has no call to it")
    slice_launches = slice_phase(gp, xp, pv, hps)
    # back to the journey's own preconditioner (the slice phase left
    # two-level set)
    gp.args.pop("gp2Scale_posterior_precond", None)
    slice_launches["posterior_api"] = gp2scale_api_phase(gp, xp)
    slice_launches["training"] = gp2scale_training_phase(gp)
    return launches, lml_at_hps, slice_launches


def committed_posterior_phase(N):
    """The gp2scale-predict cell's path at full size: a gp2Scale GP at the
    journey's data and h0 in the port's default precision on the card
    (float32), its committed state made by a first request (the structure
    pass, K5's assembly, the refined weights); then one request counted,
    ``posterior_mean`` and ``posterior_covariance(variance_only=True)`` at
    the journey's 500 points.  Its variance solve must run on K2 alone and
    drop converged columns (fewer column products than trips x 512), and
    eight of its variances must match those points' variances solved
    alone, at a width the CG never narrows."""
    import torch

    from fvgp_tpu_torch import GP
    from fvgp_tpu_torch.utils import trace
    x, y, xp = journey_data(N)
    h0 = np.array([1.0, 2.0, 2.0, 2.0])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    gp = GP(x, y, init_hyperparameters=h0,
            noise_variances=np.full(len(x), 1e-2), gp2Scale=True,
            compute_device="cuda",
            args={"gp2Scale_block_size": 128, "sparse_cg_maxiter": 32,
                  "random_logdet_fixed_probes": 16,
                  "gp2Scale_structure_cache_dir": False})
    gp.posterior_mean(xp)
    gp.posterior_covariance(xp, variance_only=True)
    torch.cuda.synchronize()
    first_s = time.time() - t0
    trace.reset()

    def request():
        return (gp.posterior_mean(xp)["m(x)"],
                gp.posterior_covariance(xp, variance_only=True)["v(x)"])

    (pm, pv), request_s, launches = counted(request)
    counts = trace.counters()
    info = dict(gp.kv.last_solve_info)
    idx = np.arange(0, 500, 63)
    pv8 = gp.posterior_covariance(xp[idx], variance_only=True)["v(x)"]
    err8 = float(np.max(np.abs(pv8 - pv[idx]))) / h0[0]
    log(f"committed posterior, float32, N={N}: first request (structure, "
        f"assembly, weights) {first_s:.3f} s, a counted request "
        f"{request_s:.4f} s; solve {json.dumps(info)}; counters "
        f"{json.dumps(counts)}; launches {json.dumps(launches)}; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB; 8 variances alone against the request's: {err8:.3e} of h0")
    if gp.kv.dtype != torch.float32 or info["method"] != "committed_pcg":
        raise AssertionError(f"the committed posterior ran in "
                             f"{gp.kv.dtype} by {info['method']}")
    if not (pm.shape == (500,) and pv.shape == (500,)
            and np.all(np.isfinite(pm)) and np.all(np.isfinite(pv))
            and np.all(pv >= 0.0)):
        raise AssertionError("committed posterior mean/variance not finite "
                             "or of the wrong shape")
    if launches["row_chunk_sums"] < 1 or launches["chunked_spmm"] \
            or launches["block_spmv"]:
        raise AssertionError(f"the committed posterior's solve left K2: "
                             f"{launches}")
    if not counts.get("cg_columns", 0) < 512 * counts["cg_iterations"]:
        raise AssertionError(f"the committed CG dropped no column: {counts}")
    # every K2 launch of the float32 request counted on the wgmma body
    if counts.get("k2_wgmma_launches", 0) != launches["row_chunk_sums"]:
        raise AssertionError(f"the committed posterior's K2 launches are not "
                             f"all on its wgmma body: {counts}, {launches}")
    # the cell's variance limit is 1.5e-4: a misplaced or dropped column
    # reads O(1)
    if not err8 <= 1e-4:
        raise AssertionError(f"the compacted variance solve disagrees with "
                             f"a narrow one: {err8}")
    log("K2 at the committed N=1M shape (float32, C = 8, c = 512, sliced "
        "as the solver slices it): " + json.dumps(committed_k2_record(gp)))
    return launches


def committed_k2_record(gp, c=512):
    """One product of the committed solver's operator at the variance
    solve's first width, on its own tiles and schedule, in the slices that
    ``_spmv_scan_fused`` launches: float32 K2's time, the bound and share,
    the plain version's time, the kernel's max error against the plain
    version (and, on the first four slices, against float64, beside the
    plain version's).  The padding tiles (column nb), which the kernel
    skips, must be exactly zero."""
    import torch

    from fvgp_tpu_torch.ops import hopper_kernels as hk
    from fvgp_tpu_torch.ops.sparse_lml import _assembly_chunk
    ctx = gp.kv._fast_solver_ctx
    tiles, cols = ctx["tiles"], ctx["scols"]
    B, C = tiles.shape[1], 8
    nb = ctx["n_pad"] // B
    n_chunks = tiles.shape[0] // C
    M = _assembly_chunk(n_chunks, target=min(max(32, (256 << 20)
                                                 // (B * c * 4)), 4096))
    gen = torch.Generator().manual_seed(7)
    Xb = torch.randn((nb, B, c), generator=gen).cuda()
    slices = [(tiles[s * C:(s + M) * C], cols[s * C:(s + M) * C])
              for s in range(0, n_chunks, M)]
    err, scale, pad_tiles, pad_nonzero, err64 = 0.0, 0.0, 0, 0, []
    for i, (t, cc) in enumerate(slices):
        pad = cc >= nb
        pad_tiles += int(pad.sum())
        pad_nonzero += int(torch.count_nonzero(t[pad]))
        got = hk.row_chunk_sums(t, cc, Xb, B, C=C)
        ref = hk.row_chunk_sums_reference(t, cc, Xb, B, C)
        err = max(err, float((got - ref).abs().max()))
        scale = max(scale, float(ref.abs().max()))
        if i < 4:
            err64.append(k2_float64_check(f"N=1M slice {i}", got, ref,
                                          k2_float64(t, cc, Xb, B, C)))
        del got, ref
    if pad_nonzero:
        raise AssertionError(f"the committed solver's padding tiles are not "
                             f"zero: {pad_nonzero} nonzero entries in "
                             f"{pad_tiles} tiles")
    if not err <= KERNEL_RTOL * scale:
        raise AssertionError(f"K2 at the committed shape disagrees with its "
                             f"plain version: {err} > {KERNEL_RTOL * scale}")
    ms = cuda_ms(lambda: [hk.row_chunk_sums(t, cc, Xb, B, C=C)
                          for t, cc in slices], reps=3, warmup=1)
    plain_ms = cuda_ms(lambda: [hk.row_chunk_sums_reference(
        t, cc, Xb, B, C) for t, cc in slices], reps=1, warmup=1)
    live = int((cols < nb).sum())
    bound_ms, bound_by = bound(live * B * B * 4 + 4 * len(cols)
                               + nb * B * c * 4 + n_chunks * B * c * 4,
                               3 * 2 * live * B * B * c, "tf32")
    return {"slices": len(slices), "chunks_per_slice": M, "live_tiles": live,
            "padding_tiles": pad_tiles, "padding_nonzero": pad_nonzero,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "share": 100.0 * bound_ms / ms,
            "max_abs_err": err, "tol": KERNEL_RTOL * scale,
            "float64_err": {k: max(e[k] for e in err64)
                            for k in ("kernel", "plain", "scale")}}


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


# ---------------------------------------------------------------------------
# the training methods (hgdl, adam, bo, asynchronous runs)
# ---------------------------------------------------------------------------

# the batched value-and-gradient of the dense LML at N=2,000 on the card
# against the CPU in float64: relative value and relative 2-norm of each
# member's gradient — float32 under the dense journey's LML and gradient
# bounds; float64 1e-9 (cuSOLVER against LAPACK, the same formula; the CPU's
# own batched against single-member evaluations agree at 1e-13)
TRAIN_BVG_BOUNDS = {"float32": {"value": 1e-4, "grad": 1e-3},
                    "float64": {"value": 1e-9, "grad": 1e-9}}
# two steps of the gp2Scale Adam chain at N=10,000, float32 on the card
# against float64 on the CPU at the same probes.  The moments carry the
# gradient: m and v are held relative to their 2-norms at 1e-5, a hundred
# times the gradient's measured relative error on the same models (the
# gp2Scale cross-check, 9.6e-8 on an H100).  An early Adam step is about
# lr·sign(g) and barely reads the gradient's size, so θ (absolute) is held
# at 1e-5, a hundred times its measured 5.6e-8 to 9.3e-8; the per-step -LML
# (relative) at 3e-5, ten times its measured 3.0e-6 (the journey's LML
# error on the same models)
TRAIN_CHAIN_BOUNDS = {"theta": 1e-5, "m": 1e-5, "v": 1e-5, "fvals": 3e-5}
# a BO run on an analytic bowl, card float64 against CPU float64: the whole
# proposal sequence in the unit cube.  On the CPU a relative perturbation of
# 1e-15 of the objective moves the 14-point sequence by at most 4.1e-12 (1e-11:
# 2.3e-10), so rounding differences of the card's float64 stay far below
# 1e-6
TRAIN_BO_BOUND = 1e-6
TRAIN_BOX = np.array([[0.1, 10.0]] + [[0.5, 5.0]] * 3)


def _bowl(h):
    """An analytic bowl over the training box, its minimum at
    (0.3, 2.0, 1.2, 3.0)."""
    c = np.array([0.3, 2.0, 1.2, 3.0])
    return float(np.sum(((h - c) / (TRAIN_BOX[:, 1]
                                    - TRAIN_BOX[:, 0])) ** 2) * 10.0)


def training_cross_check(card="cuda"):
    """The training slice's pieces on the card against the CPU in float64:
    the batched value-and-gradient (dense N=2,000, four members, one of them
    not positive definite) and a 14-evaluation BO run on an analytic bowl
    (float64); the Adam chain's is ``adam_chain_cross_check``.
    ``card="cpu"`` rehearses it without a card."""
    from fvgp_tpu_torch.models.gp_bo import bayesian_optimize
    x, y, _ = dense_cell_data(2_000, seed=8)
    P = np.array([[1.0, 1.5, 1.5, 1.5], [2.0, 1.0, 2.0, 0.7],
                  [-1.0, 1.5, 1.5, 1.5], [0.5, 3.0, 1.0, 2.0]])
    out = {}
    for name, device, args in (("cpu", "cpu", None),
                               ("float32", card, {"dtype": "float32"}),
                               ("float64", card, {"dtype": "float64"})):
        gp = dense_model(x, y, P[0], device, args)
        ml = gp.marginal_likelihood
        t0 = time.time()
        vals, grads = ml.batched_value_and_grad_device()(P)
        out[name] = (host64(vals), host64(grads))
        per_member = getattr(ml, "_vg_member_bytes", (None, 0))[1]
        log(f"training cross-check: batched value-and-gradient N=2000 "
            f"{name} ({device}): {time.time() - t0:.3f} s, values "
            f"{np.array2string(out[name][0], precision=4)}"
            + (f", one member's measured peak {per_member / 2**30:.3f} GiB"
               if per_member else ""))
    ref_v, ref_g = out["cpu"]
    ok = np.isfinite(ref_v)
    for name in ("float32", "float64"):
        v, g = out[name]
        if not np.array_equal(np.isnan(v), np.isnan(ref_v)):
            raise AssertionError(f"batched value-and-gradient {name}: the "
                                 f"failed member differs ({v} vs {ref_v})")
        errs = {"value": float(np.max(np.abs(v[ok] - ref_v[ok])
                                      / np.abs(ref_v[ok]))),
                "grad": float(np.max(np.linalg.norm(g[ok] - ref_g[ok], axis=1)
                                     / np.linalg.norm(ref_g[ok], axis=1)))}
        bounds = TRAIN_BVG_BOUNDS[name]
        log(f"training cross-check: batched value-and-gradient {name} vs "
            f"CPU float64: " + ", ".join(
                f"{k} {errs[k]:.3e} (bound {bounds[k]:g})" for k in errs))
        if not all(errs[k] <= bounds[k] for k in errs):
            raise AssertionError(f"batched value-and-gradient {name} out of "
                                 f"bounds: {errs}")

    traces = {}
    for key, device in (("ref", "cpu"), ("card", card)):
        t0 = time.time()
        _, info = bayesian_optimize(_bowl, TRAIN_BOX,
                                    np.array([0.5, 1.0, 4.0, 1.0]),
                                    max_iter=14, bo_args={"seed": 1},
                                    device=device)
        traces[key] = info["trace u"]
        log(f"training cross-check: BO on a bowl, {device} float64: "
            f"{time.time() - t0:.2f} s, best f(x) {info['f(x)']:.6f} after "
            f"{info['n_evaluations']} evaluations")
    err = float(np.abs(traces["card"] - traces["ref"]).max())
    log(f"training cross-check: BO proposal sequence {card} vs CPU: max "
        f"|u| difference {err:.3e} (bound {TRAIN_BO_BOUND:g})")
    if not (traces["card"].shape == traces["ref"].shape
            and err <= TRAIN_BO_BOUND):
        raise AssertionError("the BO proposal sequence differs on the card")


def adam_chain_cross_check(models, hps):
    """Two steps of the gp2Scale Adam chain on the gp2Scale cross-check's
    models (N=10,000, the CPU's float64 ``models["ref"]`` and the card's
    float32 ``models["card"]``) at the same injected probes, K1 launches
    counted."""
    import torch
    bounds = np.array([[0.1, 10.0]] + [[1.5, 2.5]] * 3)
    entry = next(iter(models["ref"].marginal_likelihood._sparse_cache
                      .values()))
    rng = np.random.default_rng(4)
    Zs = [rng.choice([-1.0, 1.0], (entry["xb"].shape[0] * 128, 16))
          for _ in range(2)]
    chains = {}
    for key, gp in models.items():
        torch.cuda.synchronize()
        hk_counts0 = launch_counts()["chunked_spmm"]
        t0 = time.time()
        chains[key] = gp.marginal_likelihood.sparse_adam_steps(
            hps, np.zeros(4), np.zeros(4), 0, 2, bounds=bounds,
            probe_source=lambda step: Zs[step])
        torch.cuda.synchronize()
        k1 = launch_counts()["chunked_spmm"] - hk_counts0
        log(f"Adam chain cross-check N={len(gp.x_data)} {gp.device} "
            f"{str(gp.prior.dtype).replace('torch.', '')}, 2 steps: "
            f"{time.time() - t0:.2f} s, theta "
            f"{np.array2string(chains[key][0], precision=6)}, K1 launches "
            f"{k1}")
        if gp.device.type == "cuda" and k1 < 2:
            raise AssertionError("the Adam chain did not launch K1")
    (th_c, m_c, v_c, f_c), (th_g, m_g, v_g, f_g) = (chains["ref"],
                                                    chains["card"])
    errs = {"theta": float(np.abs(th_g - th_c).max()),
            "m": float(np.linalg.norm(m_g - m_c) / np.linalg.norm(m_c)),
            "v": float(np.linalg.norm(v_g - v_c) / np.linalg.norm(v_c)),
            "fvals": float(np.max(np.abs(f_g - f_c) / np.abs(f_c)))}
    log("Adam chain cross-check, the card's float32 vs CPU float64: "
        + ", ".join(f"{k} {errs[k]:.3e} (bound {TRAIN_CHAIN_BOUNDS[k]:g})"
                    for k in errs))
    if not all(errs[k] <= TRAIN_CHAIN_BOUNDS[k] for k in errs):
        raise AssertionError(f"the Adam chain out of bounds: {errs}")


def _trained(tag, hps):
    if not (isinstance(hps, np.ndarray) and np.all(np.isfinite(hps))):
        raise AssertionError(f"{tag}: non-finite hyperparameters {hps}")


def dense_training_phase(gp):
    """The training methods on the dense journey's model (N=10,000,
    float32), each a counted public call: hgdl (4 starts, 3 epochs since
    the mesh slice, which cut it from 5 to keep the smoke's time), adam
    (20 steps), bo (14 evaluations) and an asynchronous mcmc polled through
    ``update_hyperparameters`` then stopped.  K3 must launch under bo and
    under the asynchronous run.  Returns every kernel's summed launches."""
    import torch
    total = {name: 0 for name in REPLACES}
    rows = []
    calls = (("hgdl", dict(pop_size=4, max_iter=3)),
             ("adam", dict(max_iter=20)),
             ("bo", dict(max_iter=14)))
    ml = gp.marginal_likelihood
    for method, kw in calls:
        torch.cuda.reset_peak_memory_stats()
        hps, secs, got = counted(lambda: gp.train(
            hyperparameter_bounds=TRAIN_BOX, method=method, **kw))
        _trained(f"dense train({method})", hps)
        peak = torch.cuda.max_memory_allocated() / 2**30
        rows.append((method, secs, got, hps, peak))
        if method == "hgdl":
            log(f"dense N={len(gp.x_data)} hgdl: one member's measured peak "
                f"{getattr(ml, '_vg_member_bytes', (0, 0))[1] / 2**30:.3f} "
                f"GiB (0 on the CPU: not measured), "
                f"{ml._vg_chunk} members a chunk")
    torch.cuda.reset_peak_memory_stats()

    def async_mcmc():
        opt = gp.train(hyperparameter_bounds=TRAIN_BOX, method="mcmc",
                       max_iter=100_000, asynchronous=True)
        polled = []
        deadline = time.time() + 3.0
        while time.time() < deadline:
            time.sleep(0.25)
            if opt.get_latest():
                polled.append(gp.update_hyperparameters(opt))
        gp.stop_training(opt)
        gp.kill_client(opt)
        if not opt.is_done():
            raise AssertionError("the asynchronous mcmc did not stop")
        if "error" in opt.actor.get_latest():
            raise AssertionError(f"the asynchronous mcmc failed: "
                                 f"{opt.actor.get_latest()['error']}")
        if not polled:
            raise AssertionError("the asynchronous mcmc published nothing")
        return polled[-1], len(polled), len(opt.actor._sampler.trace["f(x)"])

    (hps, n_polls, n_steps), secs, got = counted(async_mcmc)
    _trained("dense asynchronous mcmc", hps)
    rows.append((f"mcmc async ({n_polls} polls, {n_steps} steps)", secs, got,
                 hps, torch.cuda.max_memory_allocated() / 2**30))
    n = len(gp.x_data)
    for method, secs, got, hps, peak in rows:
        for k in REPLACES:
            total[k] += got[k]
        log(f"dense N={n} train({method}): {secs:.2f} s, peak {peak:.2f} "
            f"GiB, hps {np.array2string(hps, precision=4)}, launches "
            f"{json.dumps(got)}")
    for method, _, got, _, _ in rows[2:]:
        if gp.device.type == "cuda" and got["dense_covariance"] < 1:
            raise AssertionError(f"K3 did not launch under train({method})")
    return total


def gp2scale_training_phase(gp):
    """The training methods on the N=1M journey's model after its
    training: adam (4 steps, within one device chain chunk; K1 launches per
    step) and bo (8 evaluations on the estimator's variance), each a
    counted public call.  The mesh slice cut them from 8 and 14 to keep the
    smoke's time.  Returns every kernel's summed launches."""
    import torch
    bounds = np.array([[0.1, 10.0]] + [[1.5, 2.5]] * 3)
    total = {name: 0 for name in REPLACES}
    for method, max_iter in (("adam", 4), ("bo", 8)):
        torch.cuda.reset_peak_memory_stats()
        hps, secs, got = counted(lambda: gp.train(
            hyperparameter_bounds=bounds, method=method, max_iter=max_iter))
        _trained(f"gp2Scale train({method})", hps)
        for k in REPLACES:
            total[k] += got[k]
        extra = ""
        if method == "adam":
            extra = (f", K1 launches per step "
                     f"{got['chunked_spmm'] / max_iter:.1f}")
        else:
            info = gp.bo_info
            extra = (f", {info['n_evaluations']} evaluations, stopping "
                     f"reason {info['stopping reason']!r}, observation noise "
                     f"variance {info['observation noise variance']}")
        log(f"N={len(gp.x_data)} train({method}, max_iter={max_iter}): "
            f"{secs:.2f} s, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, hps "
            f"{np.array2string(hps, precision=4)}, launches "
            f"{json.dumps(got)}{extra}")
        if gp.device.type == "cuda" and got["chunked_spmm"] < 1:
            raise AssertionError(f"K1 did not launch under gp2Scale "
                                 f"train({method})")
        if gp.device.type == "cuda" and got["tile_covariance"] < 1:
            raise AssertionError(f"K5 did not launch under gp2Scale "
                                 f"train({method})")
    if gp.device.type == "cuda" and total["tile_covariance_vjp"] < 1:
        raise AssertionError("K5's VJP did not launch under gp2Scale "
                             "training")
    return total


def stored_model(x, y, hps, device, extra, mode="sparseCGpre"):
    """The stored-K gp2Scale model: the traced LML off, sparseCGpre unless
    another mode is named."""
    from fvgp_tpu_torch import GP
    return GP(x, y, init_hyperparameters=hps,
              noise_variances=np.full(len(x), 1e-2), gp2Scale=True,
              compute_device=device, linalg_mode=mode,
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


# ---------------------------------------------------------------------------
# host callables and non-Euclidean input (ROADMAP item 1.6): the formula /
# finite-difference gradient engine, structured noise on a dense and a
# block-sparse K, list inputs, fvGP
# ---------------------------------------------------------------------------

# the card's float32 against the CPU in float64 (relative for values and
# gradients — the gradient as a relative 2-norm —, absolute for posterior
# means of O(1) scale, relative to the largest reference variance for the
# variances, which are as small as 1e-3).  Set before the first run on the
# card from the same checks on the CPU in float32 against float64
# (``item16_cross_check("cpu")``): the host Matérn kernel's value 2.2e-6
# and formula gradient 1.1e-6 (1.3e-6 under ram_economy) at N=2,000, its
# central-difference Hessian 1.8e-4 at N=500 (the step 1e-3·|h| divides
# the gradient's rounding), the default kernel's committed-state formula
# gradient against its autograd gradient 9.5e-7, the structured-noise
# dense model 9.1e-7 / 1.7e-6 / 2.7e-6 / 1.1e-6, the diagonal noise
# callable's mean 4.2e-5, the non-Euclidean models and fvGP below 1e-5,
# the variances' relative reading 1.3e-6-5.3e-5 — the dense bounds of the
# journey, and 1e-2 for the Hessian
ITEM16_BOUNDS = {"lml": 1e-4, "grad": 1e-3, "mean": 1e-3, "var": 1e-3,
                 "hessian": 1e-2, "formula_vs_autograd": 1e-3}
# the stored gp2Scale K+V with scipy noise (float32 tiles) against the dense
# float64 oracle on the card: the tiles are evaluated in float32 — whitened
# coordinates of up to ~10 round at ~6e-7, and the Wendland kernel's slope
# is O(10) — so 1e-5 absolute (the first run on an H100 held 1e-6, a bound
# that assumed one rounding per entry, and measured 2.7e-6); the LML within
# 4 SLQ standard deviations plus the float32 solve's 1e-4 of |LML|
ITEM16_KV_BOUND = 1e-5
ITEM16_SLQ_SIGMAS = 4.0


def banded_noise(n, level=0.05, coupling=0.02):
    """The structured noise of the JAX suite (tests/test_structured_noise.py):
    SPD tridiagonal, dominant diagonal, as a scipy CSR matrix."""
    import scipy.sparse as sps
    off = np.full(n - 1, coupling)
    return sps.diags([off, np.full(n, level), off], [-1, 0, 1]).tocsr()


def np_matern(x1, x2, hps):
    """The default Matérn-3/2 ARD kernel as a host (numpy) callable."""
    x1 = np.asarray(x1, np.float64) / hps[1:]
    x2 = np.asarray(x2, np.float64) / hps[1:]
    d2 = (x1 * x1).sum(1)[:, None] + (x2 * x2).sum(1)[None, :] \
        - 2.0 * x1 @ x2.T
    d = np.sqrt(3.0 * np.maximum(d2, 0.0))
    return hps[0] * (1.0 + d) * np.exp(-d)


def ragged_sequences(N, seed=0, neighbours=40):
    """N ragged sequences (lengths 1-4) whose means lie on a line, sorted,
    ~``neighbours`` within the support of ``compact_object_kernel`` at
    lengthscale 2; targets from the means."""
    rng = np.random.default_rng(seed)
    span = N * 2.0 * 2.0 / neighbours
    c = np.sort(rng.uniform(0, span, N))
    x = [list(c[i] + 0.01 * rng.standard_normal(1 + i % 4)) for i in range(N)]
    y = np.sin(0.2 * c) + 0.05 * rng.standard_normal(N)
    return x, y, span


def compact_object_kernel(x1, x2, hps):
    """A compactly supported (Wendland) kernel over the sequences' means,
    vectorized over one tile: hps[0]·w(|m1 − m2| / hps[1])."""
    a = np.array([np.mean(s) for s in x1])
    b = np.array([np.mean(s) for s in x2])
    d = np.minimum(np.abs(a[:, None] - b[None, :]) / hps[1], 1.0)
    return hps[0] * (1.0 - d) ** 8 * (32.0 * d ** 3 + 25.0 * d ** 2
                                      + 8.0 * d + 1.0)


def _rel(a, b):
    return abs(a - b) / abs(b)


def _rel2(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / np.linalg.norm(np.asarray(b)))


def _maxabs(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def _var_errs(a, b):
    """A posterior variance against its reference: max |Δv| / max |v_ref|
    (held) and max |Δv| (measured only) — the variances of these checks
    are O(1e-3), so an absolute reading says little."""
    return {"var": _maxabs(a, b) / float(np.abs(np.asarray(b)).max()),
            "var_abs": _maxabs(a, b)}


def _card_args(card):
    """The card's arguments: float32 on CUDA; on the CPU (the rehearsal)
    float32 asked for explicitly."""
    return {} if card == "cuda" else {"dtype": "float32"}


def formula_gradient_cross_check(card="cuda"):
    """The formula gradient on the card against the CPU in float64: a numpy
    host Matérn kernel at dense N=2,000 (value and gradient at a trial
    vector, the committed-state gradient; ``ram_economy`` off and on), its
    central-difference Hessian at N=500, and the default kernel's
    committed-state formula gradient against its autograd gradient."""
    from fvgp_tpu_torch import GP
    x, y, xp = dense_cell_data(2_000, seed=8)
    hps = np.array([1.0, 1.5, 1.5, 1.5])
    trial = hps * 1.05
    nv = np.full(len(x), 1e-2)
    errs = {}
    for ram in (False, True):
        out = {}
        for key, device, args in (("cpu", "cpu", {}),
                                  ("card", card, _card_args(card))):
            t0 = time.time()
            gp = GP(x, y, init_hyperparameters=hps, noise_variances=nv,
                    kernel_function=np_matern, compute_device=device,
                    ram_economy=ram, args=dict(args))
            val, grad = gp.marginal_likelihood \
                .log_likelihood_value_and_gradient(trial)
            out[key] = (
                val, grad, gp.neg_log_likelihood_gradient())
            log(f"formula gradient cross-check: host Matérn kernel N=2000 "
                f"{device} {args.get('dtype', '')} ram_economy={ram}: lml "
                f"{val:.6f}, {time.time() - t0:.2f} s")
        ref, got = out["cpu"], out["card"]
        tag = "ram" if ram else "stack"
        errs[f"lml_{tag}"] = _rel(got[0], ref[0])
        errs[f"grad_{tag}"] = _rel2(got[1], ref[1])
        errs[f"committed_grad_{tag}"] = _rel2(got[2], ref[2])
    hess = {}
    for key, device, args in (("cpu", "cpu", {}),
                                  ("card", card, _card_args(card))):
        gp = GP(x[:500], y[:500], init_hyperparameters=hps,
                noise_variances=nv[:500], kernel_function=np_matern,
                compute_device=device, args=dict(args))
        hess[key] = gp.marginal_likelihood.neg_log_likelihood_hessian(hps)
    errs["hessian"] = float(np.linalg.norm(hess["card"] - hess["cpu"])
                            / np.linalg.norm(hess["cpu"]))
    gp = dense_model(x, y, hps, card, _card_args(card) or None)
    formula = gp.neg_log_likelihood_gradient()
    autograd = gp.neg_log_likelihood_gradient(hps)
    cpu = dense_model(x, y, hps, "cpu").neg_log_likelihood_gradient()
    errs["formula_vs_autograd"] = _rel2(formula, autograd)
    errs["default_committed_grad"] = _rel2(formula, cpu)
    bounds = {k: ITEM16_BOUNDS.get(k, ITEM16_BOUNDS[
        "lml" if k.startswith("lml") else "grad"]) for k in errs}
    held(f"formula gradient cross-check, {card} float32 vs CPU float64",
         errs, bounds)


def structured_noise_cross_check(card="cuda"):
    """Structured noise: the scipy tridiagonal noise on a dense model
    (N=2,000) on the card against the CPU in float64; on the card, the same
    noise on a stored gp2Scale K (N=10,240, float32 tiles): its merged K+V
    against the dense float64 oracle and its SLQ LML against the oracle's
    exact LML.  Returns the launches of the merged-operator LML."""
    import torch

    from fvgp_tpu_torch import GP
    from fvgp_tpu_torch.kernels import wendland_anisotropic
    x, y, xp = dense_cell_data(2_000, seed=9)
    hps = np.array([1.0, 1.5, 1.5, 1.5])

    def noise(xx, h):
        return banded_noise(len(xx))

    out = {}
    for key, device, args in (("cpu", "cpu", {}),
                                  ("card", card, _card_args(card))):
        gp = GP(x, y, init_hyperparameters=hps, noise_function=noise,
                compute_device=device, args=dict(args))
        out[key] = (
            gp.log_likelihood(), gp.neg_log_likelihood_gradient(),
            gp.posterior_mean(xp[:100])["m(x)"],
            gp.posterior_covariance(xp[:100], variance_only=True,
                                    add_noise=True)["v(x)"])
    ref, got = out["cpu"], out["card"]
    held(f"structured noise (scipy tridiagonal) dense N=2000, {card} float32 "
         "vs CPU float64",
         {"lml": _rel(got[0], ref[0]), "grad": _rel2(got[1], ref[1]),
          "mean": _maxabs(got[2], ref[2]), **_var_errs(got[3], ref[3])},
         ITEM16_BOUNDS)
    if card != "cuda":
        return None
    N = 10_240
    xs, ys, _ = journey_data(N, seed=4)
    hps = np.array([1.0, 2.0, 2.0, 2.0])
    gp = GP(xs, ys, init_hyperparameters=hps, noise_function=noise,
            gp2Scale=True, compute_device="cuda", linalg_mode="sparseCGpre",
            args={"gp2Scale_block_size": 128, "sparse_cg_tol": 1e-6,
                  "sparse_cg_maxiter": 1000,
                  "gp2Scale_structure_cache_dir": False})
    KV = gp.kv.KV
    if KV.tiles.dtype != torch.float32 or KV.device.type != "cuda":
        raise AssertionError(f"merged K+V {KV.tiles.dtype} on {KV.device}")
    xd = torch.as_tensor(np.asarray(gp.x_data), dtype=torch.float64,
                         device="cuda")
    oracle = wendland_anisotropic(xd, xd, torch.as_tensor(
        hps, dtype=torch.float64, device="cuda"))
    oracle += torch.as_tensor(banded_noise(N).toarray(), device="cuda")
    kv_err = float((KV.to_dense().double() - oracle).abs().max())
    L = torch.linalg.cholesky(oracle)
    ym = torch.as_tensor(np.asarray(gp.y_data)[:, 0] - np.mean(gp.y_data),
                         dtype=torch.float64, device="cuda")
    alpha = torch.cholesky_solve(ym[:, None], L)[:, 0]
    exact = float(-0.5 * (ym @ alpha + 2.0 * torch.log(torch.diagonal(L))
                          .sum() + N * np.log(2.0 * np.pi)))
    del oracle, L, xd
    torch.cuda.empty_cache()
    lml, secs, launches = counted(gp.log_likelihood)
    sd = float(np.sqrt(gp.marginal_likelihood.log_likelihood_variance()))
    log(f"structured noise gp2Scale N={N} on the card: merged K+V "
        f"{tuple(KV.tiles.shape)} {KV.tiles.dtype}, max |K+V - dense float64 "
        f"oracle| {kv_err:.3e} (bound {ITEM16_KV_BOUND:g}); SLQ lml "
        f"{lml:.4f} vs exact {exact:.4f}: |diff| {abs(lml - exact):.4f}, "
        f"bound {ITEM16_SLQ_SIGMAS:g} sd ({sd:.4f}) + 1e-4 |lml|; "
        f"{secs:.2f} s, CG {gp.kv.last_solve_info['iterations']} "
        f"iterations, launches {json.dumps(launches)}")
    if not (kv_err <= ITEM16_KV_BOUND and abs(lml - exact)
            <= ITEM16_SLQ_SIGMAS * sd + 1e-4 * abs(exact)):
        raise AssertionError("the merged K+V or its LML disagrees with the "
                             "dense oracle")
    if launches["chunked_spmm"] < 1:
        raise AssertionError("K1 never launched on the merged K+V")
    return launches


def diagonal_noise_cross_check(card="cuda"):
    """A gp2Scale noise callable that returns a per-point diagonal: the
    committed fast solver serves the posterior (K2 on the card), on the
    card against the CPU in float64 (N=4,096).  The card's posterior calls
    are counted: returns their launches."""
    from fvgp_tpu_torch import GP
    x, y, xp = journey_data(4_096, seed=5)
    xp = xp[:64]
    hps = np.array([1.0, 2.0, 2.0, 2.0])

    def noise(xx, h):
        return 0.01 + 0.01 * (np.asarray(xx)[:, 0] > np.median(xx[:, 0]))

    out, launches = {}, None
    for key, device, args in (("cpu", "cpu", {}),
                                  ("card", card, _card_args(card))):
        gp = GP(x, y, init_hyperparameters=hps, noise_function=noise,
                gp2Scale=True, compute_device=device,
                linalg_mode="sparseCGpre",
                args={"gp2Scale_block_size": 128, **args})
        if gp.kv._fast_sparse_solver() is None:
            raise AssertionError("the committed fast solver refused a "
                                 "diagonal noise callable")

        def post(gp=gp):
            return (gp.posterior_mean(xp)["m(x)"],
                    gp.posterior_covariance(xp, variance_only=True)["v(x)"])
        if device == "cuda":
            out[key], secs, launches = counted(post)
            log(f"diagonal noise callable gp2Scale N=4096 posterior on the "
                f"card: {secs:.2f} s, launches {json.dumps(launches)}")
        else:
            out[key] = post()
    ref, got = out["cpu"], out["card"]
    held(f"diagonal noise callable gp2Scale N=4096, {card} float32 vs CPU "
         "float64", {"mean": _maxabs(got[0], ref[0]),
                     **_var_errs(got[1], ref[1])}, ITEM16_BOUNDS)
    if launches is not None and launches["row_chunk_sums"] < 1:
        raise AssertionError("K2 never launched under the diagonal noise "
                             "callable")
    return launches


def non_euclidean_cross_check(card="cuda"):
    """Non-Euclidean input: N=2,048 ragged sequences with a host kernel, a
    dense GP and a gp2Scale GP (``sparseCGpre``, every tile pair scheduled,
    the host tile loop), on the card against the CPU in float64."""
    from fvgp_tpu_torch import GP
    x, y, _ = ragged_sequences(2_048, seed=1)
    xp = x[5::32]
    hps = np.array([1.0, 2.0])
    for name, extra in (("dense", {}),
                        ("gp2Scale", dict(gp2Scale=True,
                                          linalg_mode="sparseCGpre"))):
        out = {}
        for key, device, args in (("cpu", "cpu", {}),
                                  ("card", card, _card_args(card))):
            t0 = time.time()
            gp = GP(x, y, init_hyperparameters=hps,
                    noise_variances=np.full(len(x), 1e-2),
                    kernel_function=compact_object_kernel,
                    compute_device=device,
                    args={"gp2Scale_block_size": 128, "sparse_cg_tol": 1e-7,
                          "sparse_cg_maxiter": 1000, **args}, **extra)
            out[key] = (
                gp.log_likelihood(), gp.posterior_mean(xp)["m(x)"],
                gp.posterior_covariance(xp, variance_only=True)["v(x)"])
            log(f"non-Euclidean {name} N=2048 {device} "
                f"{args.get('dtype', '')}: {time.time() - t0:.2f} s")
        ref, got = out["cpu"], out["card"]
        held(f"non-Euclidean {name} N=2048, {card} float32 vs CPU float64",
             {"lml": _rel(got[0], ref[0]), "mean": _maxabs(got[1], ref[1]),
              **_var_errs(got[2], ref[2])}, ITEM16_BOUNDS)


def fvgp_cross_check(card="cuda"):
    """fvGP at 500 inputs x 3 tasks with NaN gaps, default kernel (K3 at
    D + 1 = 3 columns on the card), on the card against the CPU in float64:
    LML, gradient, task-major posterior mean and variance."""
    from fvgp_tpu_torch import fvGP
    rng = np.random.default_rng(12)
    x = rng.uniform(0, 5, (500, 2))
    base = np.sin(x[:, 0]) + 0.3 * np.cos(2 * x[:, 1])
    y = np.stack([base, 0.8 * base + 0.1, base ** 2], axis=1) \
        + 0.02 * rng.standard_normal((500, 3))
    y[rng.choice(500, 60, replace=False), 2] = np.nan
    y[rng.choice(500, 20, replace=False), 0] = np.nan
    hps = np.ones(4)
    xp, x_out = x[:40] + 0.05, np.arange(3.0)
    out = {}
    for key, device, args in (("cpu", "cpu", {}),
                                  ("card", card, _card_args(card))):
        f = fvGP(x, y, init_hyperparameters=hps, compute_device=device,
                 noise_variances=np.full_like(y, 1e-2), args=dict(args))
        val, grad = f.marginal_likelihood.log_likelihood_value_and_gradient(
            hps)
        m = f.posterior_mean(xp, x_out=x_out)["m(x)"]
        v = f.posterior_covariance(xp, x_out=x_out,
                                   variance_only=True)["v(x)"]
        if m.shape != (40, 3) or v.shape != (40, 3):
            raise AssertionError("fvGP posteriors are not task-major")
        out[key] = (val, grad, m, v)
    ref, got = out["cpu"], out["card"]
    held(f"fvGP 500 x 3 tasks ({len(f.x_data)} points), {card} float32 vs "
         "CPU float64", {"lml": _rel(got[0], ref[0]),
                         "grad": _rel2(got[1], ref[1]),
                         "mean": _maxabs(got[2], ref[2]),
                         **_var_errs(got[3], ref[3])}, ITEM16_BOUNDS)


def item16_cross_check(card="cuda"):
    """The item-1.6 cross-checks; ``card="cpu"`` rehearses them in float32
    on the CPU.  Returns the launches of the two counted pieces (the merged
    K+V's LML, the diagonal noise callable's posterior)."""
    formula_gradient_cross_check(card)
    merged = structured_noise_cross_check(card)
    diagonal = diagonal_noise_cross_check(card)
    non_euclidean_cross_check(card)
    fvgp_cross_check(card)
    return merged, diagonal


def multitask_phase():
    """(a) BASELINE config 2 at full width: the multi-task climate-like
    data, V=2,500 inputs, D=2, No=4 tasks, 10% NaN in one task; the default
    kernel on the card (K3 at D + 1 = 3 columns), float32.  LML+gradient,
    ``train("local", max_iter=3)``, posterior mean and variance at 500
    inputs x 4 tasks, every call counted."""
    import torch

    from fvgp_tpu_torch import fvGP
    rng = np.random.default_rng(1)
    V = 2_500
    x = rng.uniform(0, 5, (V, 2))
    base = np.sin(x[:, 0]) + 0.3 * np.cos(2 * x[:, 1])
    y = np.stack([base, 0.8 * base + 0.1, base ** 2, np.cos(base)], axis=1)
    y += 0.02 * rng.standard_normal(y.shape)
    y[rng.choice(V, V // 10, replace=False), 2] = np.nan
    xp = rng.uniform(0, 5, (500, 2))
    x_out = np.arange(4.0)
    hps = np.array([1.0, 1.0, 1.0, 1.0])
    torch.cuda.reset_peak_memory_stats()
    times, total = {}, {name: 0 for name in REPLACES}

    def step(key, fn):
        out, secs, launches = counted(fn)
        times[key] = secs
        for k in total:
            total[k] += launches[k]
        return out

    f = step("construction_s", lambda: fvGP(
        x, y, init_hyperparameters=hps, compute_device="cuda",
        noise_variances=np.full_like(y, 1e-3)))
    val, grad = step("lml_grad_s", lambda: f.marginal_likelihood
                     .log_likelihood_value_and_gradient(hps))
    bounds = np.array([[0.01, 10.0], [0.1, 10.0], [0.1, 10.0], [0.1, 10.0]])
    trained = step("train_local_3_s", lambda: f.train(
        hyperparameter_bounds=bounds, method="local", max_iter=3))
    m = step("posterior_mean_2000_s",
             lambda: f.posterior_mean(xp, x_out=x_out)["m(x)"])
    v = step("posterior_variance_2000_s", lambda: f.posterior_covariance(
        xp, x_out=x_out, variance_only=True)["v(x)"])
    n = f.data.point_number
    log(f"multi-task fvGP: {V} inputs x 4 tasks = {n} points, lml "
        f"{val:.4f}, grad {np.array2string(grad, precision=4)}, trained "
        f"hps {np.array2string(trained, precision=4)}, lml "
        f"{f.log_likelihood():.4f}; mean {m.shape}, variance {v.shape} "
        f"range [{v.min():.3e}, {v.max():.3e}]")
    log(f"multi-task fvGP phase times: " + json.dumps(
        {k: round(t, 4) for k, t in times.items()}) + "; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"launches {json.dumps(total)}")
    if not (n == 4 * V - V // 10 and m.shape == (500, 4)
            and v.shape == (500, 4) and np.all(np.isfinite(m))
            and np.all(v >= 0.0) and np.all(np.isfinite(trained))):
        raise AssertionError("the multi-task phase gave wrong shapes or "
                             "non-finite results")
    if total["dense_covariance"] < 1:
        raise AssertionError("K3 never launched under fvGP")
    return total


def formula_phase():
    """(b) The formula gradient at the dense cell (N=10^4, D=3, float32):
    ``neg_log_likelihood_gradient()`` at the committed state with
    ``ram_economy`` off and on, each against the autograd gradient of the
    same model, and one value + gradient of a numpy host kernel at
    N=4,000, every call counted."""
    import torch

    from fvgp_tpu_torch import GP
    x, y, _ = dense_cell_data(10_000)
    hps = np.array([1.0, 1.5, 1.5, 1.5])
    total = {name: 0 for name in REPLACES}
    times = {}
    for ram in (False, True):
        gp = GP(x, y, init_hyperparameters=hps,
                noise_variances=np.full(len(x), 1e-2), compute_device="cuda",
                linalg_mode="Chol", ram_economy=ram)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        g, secs, launches = counted(gp.neg_log_likelihood_gradient)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        times[f"formula_grad_ram_{ram}_s"] = secs
        for k in total:
            total[k] += launches[k]
        auto = gp.neg_log_likelihood_gradient(hps)
        err = _rel2(g, auto)
        log(f"formula gradient N=10000 ram_economy={ram}: "
            f"{np.array2string(g, precision=5)}, {secs:.3f} s, peak above "
            f"the model {peak:.2f} GiB; vs autograd {err:.3e} (bound "
            f"{ITEM16_BOUNDS['formula_vs_autograd']:g})")
        if not err <= ITEM16_BOUNDS["formula_vs_autograd"]:
            raise AssertionError("the formula gradient disagrees with "
                                 "autograd at the dense cell")
        del gp
        torch.cuda.empty_cache()
    xh, yh, _ = dense_cell_data(4_000, seed=3)
    gp = GP(xh, yh, init_hyperparameters=hps, kernel_function=np_matern,
            noise_variances=np.full(len(xh), 1e-2), compute_device="cuda")
    (val, grad), secs, launches = counted(
        lambda: gp.marginal_likelihood.log_likelihood_value_and_gradient(
            hps * 1.02))
    times["host_kernel_value_grad_4000_s"] = secs
    for k in total:
        total[k] += launches[k]
    rounded = {k: round(t, 4) for k, t in times.items()}
    log(f"host Matérn kernel N=4000 value + formula gradient: lml "
        f"{val:.4f}, grad {np.array2string(grad, precision=4)}, {secs:.3f} "
        f"s; phase times {json.dumps(rounded)}; launches "
        f"{json.dumps(total)}")
    if not (np.isfinite(val) and np.all(np.isfinite(grad))):
        raise AssertionError("non-finite host-kernel value or gradient")
    return total


def structured_noise_phase(N):
    """(c) Structured noise at N=10^6: the stored-K journey's configuration
    (bfloat16 tile storage, ``sparseCGpre``) with a noise callable that
    returns the scipy tridiagonal matrix.  Uncounted first: the
    ``from_scipy`` + ``merge`` + row sort piece timed alone on the
    committed K.  Counted: one trial LML, a posterior mean and variance at
    64 points.  After the counts are read: K1 on the merged K+V against the
    plain product and the library."""
    import torch

    from fvgp_tpu_torch import GP
    from fvgp_tpu_torch.ops import hopper_kernels as hk
    x, y, xp = journey_data(N)
    xp = xp[:64]
    hps = np.array([1.0, 2.0, 2.0, 2.0])

    def noise(xx, h):
        return banded_noise(len(xx))

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2**30
    gp = GP(x, y, init_hyperparameters=hps, noise_function=noise,
            gp2Scale=True, compute_device="cuda", linalg_mode="sparseCGpre",
            args={"gp2Scale_block_size": 128, "gp2Scale_traced_lml": False,
                  "gp2Scale_storage_dtype": "bfloat16",
                  "gp2Scale_solver_dtype": "bfloat16", "sparse_cg_tol": 1e-4,
                  "sparse_cg_maxiter": 500,
                  "gp2Scale_structure_cache_dir": False})
    times = {}
    t0 = time.time()
    K = gp.K
    torch.cuda.synchronize()
    times["assemble_K_s"] = time.time() - t0
    t0 = time.time()
    V = noise(gp.x_data, hps)
    times["noise_callable_s"] = time.time() - t0
    t0 = time.time()
    KV = gp.kv.addKV(K, V)
    torch.cuda.synchronize()
    times["from_scipy_merge_s"] = time.time() - t0
    t0 = time.time()
    KV._store.kernel_operands()
    torch.cuda.synchronize()
    times["row_sort_s"] = time.time() - t0
    merged = (tuple(KV.tiles.shape), str(KV.tiles.dtype), KV.nnz // 128 ** 2)
    del KV, V
    torch.cuda.empty_cache()
    log(f"structured noise N={N}: K {tuple(K.tiles.shape)} {K.tiles.dtype}; "
        f"merged K+V tiles {merged[0]} {merged[1]}, live {merged[2]}; "
        f"from_scipy + merge {times['from_scipy_merge_s']:.3f} s, row sort "
        f"{times['row_sort_s']:.3f} s, peak so far "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if merged[1] != "torch.float32":
        raise AssertionError("the merged K+V of bfloat16 K is not float32")
    hk.reset_launch_counts()
    t0 = time.time()
    trial = gp.log_likelihood(hps * 1.001)
    torch.cuda.synchronize()
    times["trial_lml_s"] = time.time() - t0
    trial_info = dict(gp.kv.last_solve_info)
    trial_var = gp.marginal_likelihood.log_likelihood_variance()
    t0 = time.time()
    pm = gp.posterior_mean(xp)["m(x)"]
    torch.cuda.synchronize()
    times["posterior_mean_64_s"] = time.time() - t0
    mean_info = dict(gp.kv.last_solve_info)
    t0 = time.time()
    pv = gp.posterior_covariance(xp, variance_only=True)["v(x)"]
    torch.cuda.synchronize()
    times["posterior_variance_64_s"] = time.time() - t0
    var_info = dict(gp.kv.last_solve_info)
    launches = launch_counts()
    log(f"structured noise N={N}: trial lml {trial:.4f} (variance "
        f"{trial_var:.4e}, CG {trial_info['iterations']} iterations); "
        f"posterior mean CG {mean_info['iterations']}, variance CG "
        f"{var_info['iterations']} iterations; mean range [{pm.min():.4f}, "
        f"{pm.max():.4f}], variance range [{pv.min():.3e}, {pv.max():.3e}]")
    log(f"structured noise N={N} phase times: " + json.dumps(
        {k: round(t, 4) for k, t in times.items()}) + "; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"({resident:.2f} GiB resident from earlier phases at its start); "
        f"launches (public calls only) {json.dumps(launches)}")
    if not (np.isfinite(trial) and trial_var > 0 and np.all(np.isfinite(pm))
            and np.all(pv >= 0.0) and pm.shape == (64,)):
        raise AssertionError("non-finite structured-noise LML or posterior")
    if gp.kv._fast_sparse_solver() is not None:
        raise AssertionError("the committed fast solver took structured "
                             "noise")
    if launches["chunked_spmm"] < 1:
        raise AssertionError("K1 never launched on the merged K+V")
    record = stored_matmat_case(gp.kv.KV, 1, torch.Generator().manual_seed(11))
    return launches, record


def non_euclidean_phase():
    """(d) Non-Euclidean gp2Scale at N=4,096 ragged sequences: a vectorized
    host kernel with compact support, B=128, float32 tiles,
    ``sparseCGpre``: the LML (stored-operator CG and SLQ on K1), posterior
    mean and variance at 64 objects and an append of 64 objects, counted."""
    import torch

    from fvgp_tpu_torch import GP
    x, y, span = ragged_sequences(4_096, seed=2)
    rng = np.random.default_rng(3)
    x_new = [list(c + 0.01 * rng.standard_normal(2))
             for c in np.sort(rng.uniform(0, span, 64))]
    y_new = rng.standard_normal(64) * 0.1
    xp = x[7::64]
    hps = np.array([1.0, 2.0])
    times, total = {}, {name: 0 for name in REPLACES}

    def step(key, fn):
        out, secs, launches = counted(fn)
        times[key] = secs
        for k in total:
            total[k] += launches[k]
        return out

    gp = step("construction_s", lambda: GP(
        x, y, init_hyperparameters=hps, noise_variances=np.full(len(x), 1e-2),
        kernel_function=compact_object_kernel, gp2Scale=True,
        compute_device="cuda", linalg_mode="sparseCGpre",
        args={"gp2Scale_block_size": 128, "sparse_cg_tol": 1e-5,
              "sparse_cg_maxiter": 1000}))
    K = step("assemble_K_s", lambda: gp.K)
    lml = step("lml_s", gp.log_likelihood)
    lml_info = dict(gp.kv.last_solve_info)
    pm = step("posterior_mean_64_s", lambda: gp.posterior_mean(xp)["m(x)"])
    pv = step("posterior_variance_64_s", lambda: gp.posterior_covariance(
        xp, variance_only=True)["v(x)"])
    step("append_64_s", lambda: gp.update_gp_data(
        x_new, y_new, noise_variances_new=np.full(64, 1e-2)))
    lml2 = step("lml_after_append_s", gp.log_likelihood)
    nb = K.nb
    log(f"non-Euclidean gp2Scale N=4096: K {K.shape}, {K.nnz // 128 ** 2} of "
        f"{nb * nb} tiles live (every pair scheduled), lml {lml:.4f} (CG "
        f"{lml_info['iterations']} iterations), after the append "
        f"{lml2:.4f}; mean range [{pm.min():.4f}, {pm.max():.4f}], "
        f"variance range [{pv.min():.3e}, {pv.max():.3e}]")
    log("non-Euclidean gp2Scale phase times: " + json.dumps(
        {k: round(t, 4) for k, t in times.items()})
        + f"; launches {json.dumps(total)}")
    if not (np.isfinite(lml) and np.isfinite(lml2)
            and gp.prior.K.shape == (4_160, 4_160)
            and np.all(np.isfinite(pm)) and np.all(pv >= 0.0)
            and K.nnz < nb * nb * 128 ** 2):
        raise AssertionError("the non-Euclidean gp2Scale phase gave wrong "
                             "results")
    if total["chunked_spmm"] < 1:
        raise AssertionError("K1 never launched on the non-Euclidean K")
    return total


# ---------------------------------------------------------------------------
# item 1.7: the extensions (deep kernel, GPm, GPLVM, GGMP)
# ---------------------------------------------------------------------------

# the extensions on the card against the CPU in float64.  In float64 on the
# card every output within 1e-8 (relative for the LML and its gradient, of
# the output's scale otherwise): the port's own parity bound, now with K3
# in float64 serving the no-grad covariances.  In float32, PERF.md section
# 2's dense bounds (LML relative, gradient relative 2-norm, mean absolute,
# variance of its largest value), held for GGMP (its K+V has a condition
# number ~1e3 at these sizes) and for the batched GGMP path against the
# per-GP path; the deep-kernel GP, GPm and GPLVM at N = 2,000 have K+V of
# condition number 1e5-2e5, where float32's unit roundoff times the
# condition number is ~1e-2: their float32 errors are printed beside the
# condition number, measured only (held to the dense bounds, three of the
# four models exceeded them on an H100 80GB HBM3 at 700 W: PERF.md)
EXT_BOUNDS = {"lml": 1e-4, "grad": 1e-3, "mean": 1e-3, "var": 1e-3,
              "mean_grad": 1e-3, "weights": 1e-3}
EXT64_BOUNDS = {k: 1e-8 for k in EXT_BOUNDS}


def deep_kernel_data(N, seed=2):
    """``examples/deep_kernel.py``'s data at N points (D = 2, a
    multiplicative structure) with 0.05 noise."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 2, (N, 2))
    y = np.sin(4 * x[:, 0] * x[:, 1]) + 0.05 * rng.standard_normal(N)
    return x, y, rng.uniform(0, 2, (500, 2))


def deep_kernel_model(x, y, device, args=None):
    """BASELINE config 4: ``WarpNet(2, 4, 4, 2)`` + Matérn-5/2, 44
    hyperparameters (random weights from a seed, then [1, 1]); its hgdl
    box."""
    from fvgp_tpu_torch import GP
    from fvgp_tpu_torch.models.deep_kernel_network import (WarpNet,
                                                           make_deep_kernel)
    net = WarpNet(2, 4, 4, 2)
    hps = np.concatenate([0.3 * np.random.default_rng(7).standard_normal(
        net.number_of_hps), [1.0, 1.0]])
    bounds = np.vstack([np.tile([-3.0, 3.0], (net.number_of_hps, 1)),
                        [[0.01, 10.0], [0.1, 10.0]]])
    gp = GP(x, y, init_hyperparameters=hps, compute_device=device,
            noise_variances=np.full(len(x), 1e-2),
            kernel_function=make_deep_kernel(net), args=dict(args or {}))
    return gp, hps, bounds


def gpm_data(N, seed=3):
    """``examples/manifold_gpm.py``'s data at N points: D = 6 inputs, Q = 3
    outputs of one latent direction."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, (N, 6))
    t = x @ np.array([1.0, -0.5, 0.25, 0.0, 0.0, 0.0])
    y = np.stack([np.sin(t), np.cos(t), 0.5 * t], axis=1)
    return x, y + 0.02 * rng.standard_normal(y.shape), \
        rng.uniform(-2, 2, (500, 6))


def gplvm_data(N, seed=0):
    """``examples/gplvm_latent.py``'s data at N points: a curve observed in
    Q = 5 dimensions."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, np.pi, N))
    Y = np.stack([np.sin(t), np.cos(t), np.sin(2 * t), np.cos(2 * t),
                  0.3 * t], axis=1)
    return Y + 0.01 * rng.standard_normal(Y.shape)


def ggmp_data(n, n_tasks=1):
    """``examples/ggmp_multitask.py``'s generator: n stations on [0, 10],
    per task a bimodal density (modes at c ± 0.6, variance 0.15, c =
    sin(x) for task 0 and cos(x) for task 1) on a 200-point grid; one
    task gives single-task stations."""
    from fvgp_tpu_torch.models.ggmp import gaussian_pdf
    x = np.linspace(0, 10, n).reshape(-1, 1)
    domain = np.linspace(-6, 6, 200)
    y = []
    for xi in x[:, 0]:
        tasks = []
        for t in range(n_tasks):
            c = np.sin(xi) if t == 0 else np.cos(xi)
            tasks.append((domain, 0.5 * gaussian_pdf(domain, c - 0.6, 0.15)
                          + 0.5 * gaussian_pdf(domain, c + 0.6, 0.15)))
        y.append(tasks if n_tasks > 1 else tasks[0])
    return x, y, domain


def ggmp_model(x, y, K, device, parallel, multi_task, args=None):
    """A GGMP of K components (constant mean, hps [1, 2, mean] single-task;
    fvGP's default mean and [1, 1, 1] multi-task), likelihoods and GPs
    initialized; ``args`` go to every component."""
    from fvgp_tpu_torch.models.ggmp import GGMP, hyperparameters
    if multi_task:
        hps = [np.ones(3) for _ in range(K)]
        bounds = [np.tile([0.01, 10.0], (3, 1)) for _ in range(K)]
    else:
        hps = [np.array([1.0, 2.0, 0.0]) for _ in range(K)]
        bounds = [np.array([[0.01, 10.0], [0.5, 10.0], [-10.0, 10.0]])
                  for _ in range(K)]
    hobj = hyperparameters(np.full(K, 1.0 / K), np.tile([0.0, 1.0], (K, 1)),
                           hps, bounds)
    g = GGMP(x, y, hps_obj=hobj, likelihood_terms=K,
             gp_init_kwargs={"compute_device": device,
                             "args": dict(args or {})},
             gp_eval_parallel=parallel)
    g.initLikelihoods()
    g.initGPs()
    return g


def _gpm_value_and_grad(m):
    import torch
    leaves = [p.detach().clone().requires_grad_(True) for p in m._params()]
    with torch.enable_grad():
        val = m._neg_lml(*leaves)
        grads = torch.autograd.grad(val, leaves)
    return -float(val), -np.concatenate([host64(g).ravel() for g in grads])


def _condition(KV, device):
    """The 2-norm condition number of a symmetric positive definite KV
    (float64 eigenvalues on ``device``)."""
    import torch
    ev = torch.linalg.eigvalsh(KV.detach().to(device, torch.float64))
    return float(ev[-1] / ev[0])


def _ext_errors(got, ref):
    """Errors of named outputs: relative for "lml", relative 2-norm for
    "grad", absolute for "mean" and "weights", of the largest value for
    "mean_grad" and "var" (with "var_abs" measured)."""
    errs = {}
    for key, r in ref.items():
        g = got[key]
        if key == "lml":
            errs[key] = _rel(g, r)
        elif key == "grad":
            errs[key] = _rel2(g, r)
        elif key == "var":
            errs.update(_var_errs(g, r))
        elif key == "mean_grad":
            errs[key] = _maxabs(g, r) / float(np.abs(np.asarray(r)).max())
        else:
            errs[key] = _maxabs(g, r)
    return errs


def _ext_compare(tag, evaluate, ref, card, hold32, cond):
    """``evaluate(device, args)`` -> named outputs on ``card`` in float32
    and float64 against ``ref``, the same outputs on the CPU in float64:
    the float64 errors held to ``EXT64_BOUNDS``, the float32 ones to
    ``EXT_BOUNDS`` where ``hold32`` (else measured), each printed beside
    ``cond``, the condition number of K+V.  Returns the float32 outputs."""
    out = {}
    for dname, args in (("float32", {"dtype": "float32"}),
                        ("float64", {"dtype": "float64"})):
        out[dname] = evaluate(card, args)
        bounds = EXT64_BOUNDS if dname == "float64" else (
            EXT_BOUNDS if hold32 else {})
        held(f"{tag}, {card} {dname} vs CPU float64, cond(K+V) {cond:.3e}",
             _ext_errors(out[dname], ref), bounds)
    return out["float32"]


def extensions_cross_check(card="cuda"):
    """The four extensions on the card against the CPU in float64 at
    N <= 2,000 (``_ext_compare``): the deep-kernel GP (LML, gradient, mean,
    variance), GPm (LML and its gradient in (W, log hps, log noise), mean,
    variance), GPLVM (LML, hyperparameter gradient, mean, its latent
    gradient, variance), GGMP at 1,000 stations x K = 3 per-GP and batched
    (component means and variances; the EM weights from the CPU's trained
    hyperparameters, density EM on each device's posteriors), and the
    batched GGMP path against the per-GP path on the card in float32.
    ``card="cpu"`` rehearses it, float32 asked for explicitly."""
    import torch

    from fvgp_tpu_torch import GPLVM, GPm
    x, y, xp = deep_kernel_data(2_000)

    def deep(device, args):
        gp, hps, _ = deep_kernel_model(x, y, device, args)
        val, grad = gp.marginal_likelihood \
            .log_likelihood_value_and_gradient(hps)
        if device == "cpu":
            deep.cond = _condition(gp.prior.K + torch.diag(gp.likelihood.V),
                                   card)
        return {"lml": val, "grad": grad,
                "mean": gp.posterior_mean(xp)["m(x)"],
                "var": gp.posterior_covariance(xp, variance_only=True)[
                    "v(x)"]}

    _ext_compare("deep-kernel GP N=2,000, 44 hps", deep, deep("cpu", {}),
                 card, False, deep.cond)

    x, y, xq = gpm_data(2_000)

    def gpm(device, args):
        m = GPm(x, y, manifold_dim=1, compute_device=device, args=args)
        val, grad = _gpm_value_and_grad(m)
        if device == "cpu":
            z = m._x @ m.W
            K = m.kernel(z, z, m._tensor(m.hyperparameters))
            gpm.cond = _condition(K + np.exp(m.log_noise) * torch.eye(
                len(K), dtype=K.dtype), card)
        return {"lml": val, "grad": grad, "mean": m.posterior_mean(xq),
                "var": m.posterior_variance(xq)}

    _ext_compare("GPm N=2,000, D=6, Q=3, L=1", gpm, gpm("cpu", {}), card,
                 False, gpm.cond)

    Y = gplvm_data(2_000)
    zq = np.linspace(-1.5, 1.5, 200)[:, None]

    def gplvm(device, args):
        m = GPLVM(Y, latent_dim=1, compute_device=device, args=args)
        if device == "cpu":
            K = m.kernel(m.X, m.X, m._tensor(m.hyperparameters))
            gplvm.cond = _condition(K + np.exp(m.log_noise) * torch.eye(
                len(K), dtype=K.dtype), card)
        return {"lml": m.log_likelihood(),
                "grad": m.neg_log_likelihood_gradient(),
                "mean": m.posterior_mean(zq)["m(x)"],
                "mean_grad": m.posterior_mean_grad(zq)["dm/dx"],
                "var": m.posterior_covariance(zq, variance_only=True)[
                    "v(x)"]}

    _ext_compare("GPLVM N=2,000, Q=5, L=1", gplvm, gplvm("cpu", {}), card,
                 False, gplvm.cond)

    x, y, _ = ggmp_data(1_000)
    xg = np.linspace(0, 10, 200).reshape(-1, 1)
    cpu = ggmp_model(x, y, 3, "cpu", False, False)
    cpu.train(method="local", max_iter=3, weight_max_iter=20)
    trained = [np.asarray(gp.hyperparameters) for gp in cpu.gps]
    cond = max(_condition(gp.prior.K + torch.diag(gp.likelihood.V), card)
               for gp in cpu.gps)
    mean, var = cpu._component_posteriors(xg)
    ref_g = {"mean": mean, "var": var,
             "weights": [lk.weight for lk in cpu.likelihoods]}

    def ggmp(parallel):
        def evaluate(device, args):
            g = ggmp_model(x, y, 3, device, parallel, False, args)
            g.train(init_hyperparameters=trained, method=lambda t: np.asarray(
                t.hyperparameters), weight_max_iter=20)
            mean, var = g._component_posteriors(xg)
            return {"mean": mean, "var": var,
                    "weights": [lk.weight for lk in g.likelihoods]}
        return evaluate

    got = {parallel: _ext_compare(
        f"GGMP 1,000 stations x K=3, {'batched' if parallel else 'per-GP'}",
        ggmp(parallel), ref_g, card, True, cond)
        for parallel in (False, True)}
    held(f"GGMP 1,000 stations x K=3, {card} float32 batched vs per-GP",
         _ext_errors({k: got[True][k] for k in ("mean", "var")},
                     {k: got[False][k] for k in ("mean", "var")}),
         EXT_BOUNDS)


def _stepper():
    """(step, times, total): ``step(key, fn)`` runs one counted public call,
    records its seconds under ``key`` and adds its launches to ``total``."""
    times, total = {}, {name: 0 for name in REPLACES}

    def step(key, fn):
        out, secs, launches = counted(fn)
        times[key] = secs
        for k in total:
            total[k] += launches[k]
        return out
    return step, times, total


def _phase_report(label, times, total):
    import torch
    log(f"{label} phase times: " + json.dumps(
        {k: round(t, 4) for k, t in times.items()}) + "; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"K3 launches {total['dense_covariance']}; launches "
        f"{json.dumps(total)}")


def deep_kernel_phase(N=10_000, hgdl_epochs=2):
    """(a) BASELINE config 4 at the dense cell's N = 10,000, D = 2: the
    deep-kernel GP (``WarpNet(2, 4, 4, 2)`` + Matérn-5/2, 44
    hyperparameters), float32 — construction, LML+gradient,
    ``train("hgdl", pop_size=4)`` with ``hgdl_epochs`` epochs, mean and
    variance at 500 points, every call counted.  A user kernel is not
    routed to K3: 0 launches expected."""
    import torch
    x, y, xp = deep_kernel_data(N)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step, times, total = _stepper()
    gp, hps, bounds = step("construction_s",
                           lambda: deep_kernel_model(x, y, "cuda"))
    val, grad = step("lml_grad_s", lambda: gp.marginal_likelihood
                     .log_likelihood_value_and_gradient(hps))
    step(f"train_hgdl_{hgdl_epochs}_s", lambda: gp.train(
        hyperparameter_bounds=bounds, method="hgdl", pop_size=4,
        max_iter=hgdl_epochs))
    lml = step("lml_s", lambda: gp.log_likelihood())
    m = step("posterior_mean_500_s", lambda: gp.posterior_mean(xp)["m(x)"])
    v = step("posterior_variance_500_s", lambda: gp.posterior_covariance(
        xp, variance_only=True)["v(x)"])
    log(f"deep-kernel GP N={N}: lml {val:.4f} -> {lml:.4f} after hgdl, "
        f"|grad| {np.linalg.norm(grad):.4e}; mean {m.shape}, variance "
        f"range [{v.min():.3e}, {v.max():.3e}]")
    _phase_report("deep-kernel GP", times, total)
    if not (np.isfinite(lml) and lml >= val and m.shape == (500,)
            and np.all(np.isfinite(m)) and np.all(v >= 0.0)
            and np.all(np.isfinite(grad))):
        raise AssertionError("the deep-kernel phase gave wrong shapes, "
                             "non-finite results or a lower LML")
    if total["dense_covariance"] != 0:
        raise AssertionError("a user kernel reached K3")
    return total


def gpm_phase(N=10_000, steps=20):
    """(b) GPm at ``examples/manifold_gpm.py``'s width: N = 10,000, D = 6,
    Q = 3, ``manifold_dim=1``, float32 — the LML, ``steps`` Adam steps,
    mean and variance at 500 points, every call counted (K3 serves the
    no-grad covariances)."""
    import torch

    from fvgp_tpu_torch import GPm
    x, y, xq = gpm_data(N)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step, times, total = _stepper()
    m = step("construction_s", lambda: GPm(x, y, manifold_dim=1,
                                           compute_device="cuda"))
    lml0 = step("lml_s", m.log_likelihood)
    step(f"train_adam_{steps}_s", lambda: m.train(max_iter=steps,
                                                  learning_rate=5e-2))
    lml = m.log_likelihood()
    mean = step("posterior_mean_500_s", lambda: m.posterior_mean(xq))
    var = step("posterior_variance_500_s", lambda: m.posterior_variance(xq))
    log(f"GPm N={N}: lml {lml0:.4f} -> {lml:.4f} after {steps} Adam "
        f"steps; mean {mean.shape}, variance range [{var.min():.3e}, "
        f"{var.max():.3e}]")
    _phase_report("GPm", times, total)
    if not (np.isfinite(lml) and mean.shape == (500, 3)
            and np.all(np.isfinite(mean)) and np.all(var >= 0.0)):
        raise AssertionError("the GPm phase gave wrong shapes or non-finite "
                             "results")
    if total["dense_covariance"] < 1:
        raise AssertionError("K3 never launched under GPm")
    return total


def gplvm_phase(N=10_000, steps=20):
    """(c) GPLVM at ``examples/gplvm_latent.py``'s width: N = 10,000, Q = 5,
    ``latent_dim=1``, float32 — ``steps`` Adam steps,
    ``train("local", max_iter=5)``, mean, variance and both latent
    gradients at 500 latent points, ``gp_entropy`` and
    ``gp_mutual_information`` (their 10,500² log-determinants in float64
    on the card), every call counted.  ``sample_latent`` is left out: at
    this width it is a 10^4-dimensional chain."""
    import torch

    from fvgp_tpu_torch import GPLVM
    Y = gplvm_data(N)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step, times, total = _stepper()
    m = step("construction_s", lambda: GPLVM(Y, latent_dim=1,
                                             compute_device="cuda"))
    lml0 = m.log_likelihood()
    step(f"train_adam_{steps}_s", lambda: m.train(max_iter=steps))
    bounds = np.array([[1e-2, 1e2], [1e-2, 1e2], [1e-5, 1.0]])
    step("train_local_5_s", lambda: m.train(
        method="local", hyperparameter_bounds=bounds, max_iter=5))
    lml = step("lml_s", m.log_likelihood)
    z = m.latent_coordinates[:, 0]
    zq = np.linspace(z.min(), z.max(), 500)[:, None]
    mean = step("posterior_mean_500_s", lambda: m.posterior_mean(zq)["m(x)"])
    var = step("posterior_variance_500_s", lambda: m.posterior_covariance(
        zq, variance_only=True)["v(x)"])
    dm = step("posterior_mean_grad_500_s",
              lambda: m.posterior_mean_grad(zq)["dm/dx"])
    dv = step("posterior_covariance_grad_500_s",
              lambda: m.posterior_covariance_grad(zq)["dv/dx"])
    ent = step("gp_entropy_500_s", lambda: m.gp_entropy(zq))
    mi = step("gp_mutual_information_500_s", lambda: m.gp_mutual_information(
        zq)["mutual information"])
    log(f"GPLVM N={N}: lml {lml0:.4f} -> {lml:.4f}, theta "
        f"{np.array2string(m.get_hyperparameters(), precision=4)}; mean "
        f"{mean.shape}, variance range [{var.min():.3e}, {var.max():.3e}], "
        f"dm/dx {dm.shape}, dv/dx {dv.shape}, entropy {ent:.4f}, mutual "
        f"information {mi:.4f}")
    _phase_report("GPLVM", times, total)
    if not (np.isfinite(lml) and mean.shape == (500, 5)
            and dm.shape == (500, 5, 1) and dv.shape == (500, 1)
            and all(np.all(np.isfinite(a)) for a in (mean, var, dm, dv))
            and np.all(var >= 0.0) and np.isfinite(ent) and np.isfinite(mi)):
        raise AssertionError("the GPLVM phase gave wrong shapes or "
                             "non-finite results")
    if total["dense_covariance"] < 1:
        raise AssertionError("K3 never launched under GPLVM")
    return total


def ggmp_phase(n=5_000, n_mt=2_000, K=3, weight_iters=20):
    """(d) GGMP: ``n`` stations, D = 1, K components, bimodal densities on a
    200-point grid (``examples/ggmp_multitask.py``'s generator, one task),
    then ``n_mt`` stations x 2 tasks on fvGP components; float32.  For each
    and for ``gp_eval_parallel`` False and True: ``initLikelihoods``,
    ``initGPs``, ``train("local", max_iter=5)`` with density EM
    (``weight_iters`` EM iterations), posterior mean, variance and pdf at
    500 points, every call counted.  Returns the launches of the per-GP
    and of the batched evaluations."""
    import torch
    paths = {}
    for label, stations, tasks in (("single-task", n, 1),
                                   ("multi-task", n_mt, 2)):
        x, y, domain = ggmp_data(stations, tasks)
        xp = np.linspace(0, 10, 500).reshape(-1, 1)
        for parallel in (False, True):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            step, times, total = _stepper()
            g = step("init_s", lambda: ggmp_model(x, y, K, "cuda", parallel,
                                                   tasks > 1))
            step("train_local_5_s", lambda: g.train(
                method="local", max_iter=5, weight_max_iter=weight_iters))
            mean = step("posterior_mean_500_s", lambda: g.posterior_mean(xp))
            var = step("posterior_variance_500_s",
                       lambda: g.posterior_variance(xp))
            pdf = step("posterior_pdf_500_s",
                       lambda: g.posterior_pdf(xp, domain))
            path = "batched" if parallel else "per-GP"
            tag = f"GGMP {label} {stations} stations x {tasks} task(s), " \
                f"K={K}, {path}"
            w = [lk.weight for lk in g.likelihoods]
            log(f"{tag}: weights {np.array2string(np.asarray(w), precision=4)}"
                f", mean {mean.shape}, variance range [{var.min():.3e}, "
                f"{var.max():.3e}], pdf {pdf.shape}, batched calls "
                f"{getattr(g, '_batched_eval_count', 0)}")
            _phase_report(tag, times, total)
            shape = (500,) if tasks == 1 else (500, tasks)
            if not (mean.shape == shape and var.shape == shape
                    and pdf.shape == shape + (len(domain),)
                    and np.all(np.isfinite(mean)) and np.all(var > 0.0)
                    and np.all(pdf >= 0.0) and abs(sum(w) - 1.0) < 1e-9
                    and getattr(g, "_batched_eval_count", 0)
                    >= (3 if parallel else 0)):
                raise AssertionError(f"{tag}: wrong shapes, non-finite "
                                     "results or the batched path unused")
            if total["dense_covariance"] < 1:
                raise AssertionError(f"K3 never launched under {tag}")
            paths[f"{label} {path}"] = total
    return paths


def extensions_phases():
    """Phases (a)-(d), each counted; returns {path: launches}."""
    paths = {"deep-kernel GP": deep_kernel_phase(),
             "GPm": gpm_phase(), "GPLVM": gplvm_phase()}
    for key, total in ggmp_phase().items():
        paths[f"GGMP {key}"] = total
    return paths


# ---------------------------------------------------------------------------
# the mesh (ROADMAP item 1.8, first part): gloo ranks sharing the one card
# ---------------------------------------------------------------------------

# mesh against one rank, both on the card in float32, same probes: two
# reduction orders of the same float32 solves, held at the dryrun's bounds
# (loss 1e-5 rel, gradient 1e-4, variance 1e-5 of their scale;
# __graft_entry__.py:201-204) but for the mean: the dryrun's 1e-6 is a
# float64 bound, and the committed float32 CG exits at a relative residual
# of 1e-4, so two summation orders leave two solutions up to that far apart
# (the first run on the card read 2.7e-5, PERF.md section 6; this bound was
# set after that reading)
MESH_ONE_RANK_BOUNDS = {"loss": 1e-5, "grad": 1e-4, "mean": 1e-4,
                        "var": 1e-5}
# the stored K on 2 gloo ranks against one rank on the card: the same tiles
# (each rank's row blocks), the same probes, K1's rows of a launch with
# nb_out equal to those of the square launch, and the committed posterior
# solve pinned to K1 on one rank too (``gp2Scale_posterior_fused_spmm``
# off: the mesh's route), so only reduction orders can differ: 1e-6 of each
# output's scale; against the CPU in float64, STORED_BOUNDS
MESH_STORED_ONE_RANK = 1e-6
MESH_STORED_MODES = ("sparseCGpre", "sparseMINRESpre", "sparseCGpre_amg",
                     "sparseCGpre_schwarz", "sparseLU")
MESH_WORLD_TIMEOUT = 420.0       # seconds for one spawned world
MESH_COLLECTIVE_TIMEOUT = 300.0  # seconds a rank waits in one collective


def _mesh_rank(rank, world, store, out_dir, task):
    """One spawned rank: a gloo world on a file store (none for the
    one-rank NCCL task, which builds its own), the task, its result
    pickled for the parent."""
    import datetime
    import os
    import pickle
    import traceback

    import torch
    import torch.distributed as dist
    warnings.simplefilter("ignore")
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        if store is not None:
            dist.init_process_group(
                "gloo", store=dist.FileStore(store, world), rank=rank,
                world_size=world,
                timeout=datetime.timedelta(seconds=MESH_COLLECTIVE_TIMEOUT))
        try:
            payload = {"ok": globals()[task](rank, world)}
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
    except BaseException:
        payload = {"error": traceback.format_exc()}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(payload, f)


def _start_world(task, world, gloo=True):
    """Spawn ``world`` ranks running ``task``; ``_join_world`` collects
    them."""
    import multiprocessing
    import os
    import tempfile
    out_dir = tempfile.mkdtemp(prefix="fvgp_mesh_")
    store = os.path.join(out_dir, "store") if gloo else None
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_mesh_rank,
                         args=(r, world, store, out_dir, task))
             for r in range(world)]
    for p in procs:
        p.start()
    return task, procs, out_dir, time.time()


def _join_world(started):
    """The results of a started world in rank order.  A world that
    overruns MESH_WORLD_TIMEOUT from its start is killed and raises."""
    import os
    import pickle
    task, procs, out_dir, t0 = started
    world = len(procs)
    for p in procs:
        p.join(max(0.0, MESH_WORLD_TIMEOUT - (time.time() - t0)))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    if hung:
        raise AssertionError(f"mesh world {task}: {len(hung)} of {world} "
                             f"ranks killed after {MESH_WORLD_TIMEOUT:.0f} s")
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            payload = pickle.load(f)
        if "error" in payload:
            raise AssertionError(f"mesh world {task}, rank {r}:\n"
                                 f"{payload['error']}")
        out.append(payload["ok"])
    return out


def _mesh_journey_inputs():
    """The gp2Scale cross-check's N=10,000 data and arguments."""
    x, y, xp = journey_data(10_000, seed=2)
    base = {"gp2Scale_block_size": 128, "sparse_cg_maxiter": 64,
            "random_logdet_fixed_probes": 16,
            "gp2Scale_structure_cache_dir": False}
    return x, y, xp[:64], np.array([1.0, 2.0, 2.0, 2.0]), base


def _exchange_of(gp):
    entry, = gp.marginal_likelihood._sparse_cache.values()
    return entry["schedule"][2].get("exchange", "one rank")


def _journey_values(x, y, xp, hps, args):
    out = run_journey(x, y, xp, hps, "cuda", args)
    return {"lml": float(out[0]), "grad": np.asarray(out[1]),
            "mean": np.asarray(out[2]), "var": np.asarray(out[3]),
            "exchange": _exchange_of(out[4])}


def _stored_mesh_inputs():
    """The stored-K cross-check's N=10,240 data (80 tiles of 128, so an
    append of 1,024 points is aligned), 32 prediction points and an X for
    ``K @ X``."""
    N, n_new = 10_240, 1_024
    x, y, xp = journey_data(N + n_new, seed=4)
    X = np.random.default_rng(5).standard_normal((N, 4))
    return (x[:N], y[:N], x[N:], y[N:], xp[:32],
            np.array([1.0, 2.0, 2.0, 2.0]), X)


def _stored_mesh_values(mode, storage, device):
    """One stored-K model of the pair task (under the active mesh, if any):
    ``K @ X``, a trial LML with its CG iterations and SLQ samples, the full
    posterior covariance at 32 points; and the model."""
    import torch
    x, y, _, _, xp, hps, X = _stored_mesh_inputs()
    extra = {"gp2Scale_posterior_fused_spmm": False}
    if storage == "bfloat16":
        extra["gp2Scale_storage_dtype"] = "bfloat16"
    gp = stored_model(x, y, hps, device, extra, mode=mode)
    K = gp.K
    out = {"KX": K.matmat(torch.as_tensor(X, dtype=gp.prior.dtype)
                          .to(gp.device)).double().cpu().numpy(),
           "lml": float(gp.log_likelihood(hps * 1.02)),
           "iters": (gp.kv.last_solve_info or {}).get("iterations"),
           "samples": gp.kv.last_logdet_info.get("num_samples"),
           "S": np.asarray(gp.posterior_covariance(xp)["S"])}
    return out, gp


def _timed_append(gp):
    """Seconds of the aligned 1,024-point append of the stored K (a stack
    on one rank, a recompute on the mesh) and the new K's shape."""
    import torch
    _, _, x_new, y_new, _, _, _ = _stored_mesh_inputs()
    torch.cuda.synchronize()
    t0 = time.time()
    gp.update_gp_data(x_new, y_new, append=True,
                      noise_variances_new=np.full(len(x_new), 1e-2))
    K = gp.K
    torch.cuda.synchronize()
    return time.time() - t0, tuple(K.shape)


def stored_mesh_reference():
    """The CPU float64 reference of the pair task's stored-K models, at
    the same probes (the mesh phase computes it while the ranks work)."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        return {mode: _stored_mesh_values(mode, None, "cpu")[0]
                for mode in MESH_STORED_MODES}
    finally:
        torch.set_num_threads(threads)


def _mesh_pair_task(rank, world):
    """Two gloo ranks on the card: the N=10,000 journey in float32 and with
    bfloat16 streaming, the stored K at N=10,240 in five modes (float32)
    and in sparseCGpre with bfloat16 storage, rank 0 also alone; then the
    N=1M journey and the N=1M stored-K journey."""
    import torch

    from fvgp_tpu_torch.ops import hopper_kernels as hk
    from fvgp_tpu_torch.parallel import mesh as pm
    hk.build_kernels()
    mesh = pm.make_mesh(layout="1d")
    x, y, xp, hps, base = _mesh_journey_inputs()
    out = {"device": str(mesh.device), "backend": mesh.backend}
    for name, extra in (("float32", {}),
                        ("bfloat16", {"gp2Scale_solver_dtype": "bfloat16"})):
        if rank == 0:
            out[f"{name} one rank"] = _journey_values(x, y, xp, hps,
                                                      {**base, **extra})
        with pm.use_mesh(mesh):
            out[name] = _journey_values(x, y, xp, hps, {**base, **extra})
    stored = {}
    for mode in MESH_STORED_MODES + ("sparseCGpre bfloat16",):
        m, storage = (mode.split() + ["float32"])[:2]
        if rank == 0:
            vals, gp = _stored_mesh_values(m, storage, "cuda")
            if mode == "sparseCGpre":
                vals["append"] = _timed_append(gp)
            stored[f"{mode} one rank"] = vals
        with pm.use_mesh(mesh):
            vals, gp = _stored_mesh_values(m, storage, "cuda")
            if mode == "sparseCGpre":
                vals["append"] = _timed_append(gp)
                vals["append_on_mesh"] = gp.K.mesh is mesh
        stored[mode] = vals
        del gp
    out["stored"] = stored
    torch.cuda.empty_cache()
    out["n1m"] = _mesh_full_journey(mesh, 1_000_000)
    torch.cuda.empty_cache()
    out["stored_n1m"] = _mesh_stored_journey(mesh, 1_000_000)
    out["ops"] = dict(mesh.ops)
    return out


def _mesh_hier_task(rank, world):
    """Four gloo ranks on the card as a 2 x 2 mesh, the hierarchical halo
    forced: the N=10,000 journey in float32."""
    from fvgp_tpu_torch.ops import hopper_kernels as hk
    from fvgp_tpu_torch.parallel import mesh as pm
    hk.build_kernels()
    mesh = pm.make_mesh_2d(2, 2, timeout=MESH_COLLECTIVE_TIMEOUT)
    x, y, xp, hps, base = _mesh_journey_inputs()
    with pm.use_mesh(mesh):
        out = _journey_values(x, y, xp, hps,
                              {**base, "gp2Scale_halo_exchange": "hier"})
    out["ops"] = dict(mesh.ops)
    return out


def _mesh_nccl_task(rank, world):
    """A one-rank NCCL world (``make_mesh()``'s default on a card, no
    torchrun environment): the collectives on CUDA tensors and the N=10,000
    journey in float32 under it."""
    import torch

    from fvgp_tpu_torch.ops import hopper_kernels as hk
    from fvgp_tpu_torch.parallel import mesh as pm
    hk.build_kernels()
    mesh = pm.make_mesh()
    if mesh.backend != "nccl" or mesh.device.type != "cuda":
        raise AssertionError(f"make_mesh() on a card gave {mesh}")
    t = torch.arange(12.0, device=mesh.device).reshape(4, 3)
    for name, got in (("all_reduce", pm._all_reduce(t, mesh)),
                      ("all_gather", pm._all_gather(t, mesh)),
                      ("all_to_all", pm._all_to_all(t, mesh, mesh.group))):
        if not torch.equal(got, t):
            raise AssertionError(f"NCCL {name} on one rank changed its input")
    x, y, xp, hps, base = _mesh_journey_inputs()
    with pm.use_mesh(mesh):
        out = _journey_values(x, y, xp, hps, base)
    out["ops"] = dict(mesh.ops)
    return out


def _mesh_full_journey(mesh, N):
    """The N=1M journey's configuration (phase 7) across the mesh's ranks:
    construction, the first LML+gradient (the host structure pass
    included), one more timed, posterior_mean on 500 points; K1 launches
    counted (set to 0 just before, read just after), peak memory, the
    exchange and its bytes per matvec."""
    import torch

    from fvgp_tpu_torch.ops import hopper_kernels as hk
    from fvgp_tpu_torch.parallel import mesh as pm
    from fvgp_tpu_torch.parallel.partition import schedule_stats
    x, y, xp = journey_data(N)
    hps = np.array([1.0, 2.0, 2.0, 2.0])
    times = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hk.reset_launch_counts()
    with pm.use_mesh(mesh):
        t0 = time.time()
        gp = journey_model(x, y, hps)
        times["construction_s"] = time.time() - t0
        ml = gp.marginal_likelihood
        t0 = time.time()
        val, grad = ml.log_likelihood_value_and_gradient(hps)
        torch.cuda.synchronize()
        times["first_lml_grad_s"] = time.time() - t0
        t0 = time.time()
        val, grad = ml.log_likelihood_value_and_gradient(hps * (1 + 1e-4))
        torch.cuda.synchronize()
        times["lml_grad_s"] = time.time() - t0
        t0 = time.time()
        pm_ = gp.posterior_mean(xp)["m(x)"]
        torch.cuda.synchronize()
        times["posterior_mean_500_s"] = time.time() - t0
    launches = launch_counts()
    run = next(iter(ml._sparse_cache.values()))["schedule"][2]
    rows_p, cols_p, nb_eff, n_dev = run["schedule"]
    stats = schedule_stats(rows_p, cols_p, nb_eff, n_dev, 128, n_rhs=17,
                           elt_bytes=2)
    if not (np.isfinite(val) and np.all(np.isfinite(grad))
            and pm_.shape == (500,) and np.all(np.isfinite(pm_))):
        raise AssertionError("the N=1M mesh journey gave non-finite or "
                             "misshapen results")
    return {"lml": float(val), "grad": np.asarray(grad), "times": times,
            "launches": launches, "exchange": run["exchange"],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "bytes_per_matvec": {k: stats[k] for k in (
                "allgather_bytes", "halo_bytes", "allreduce_bytes")},
            "tiles_per_rank": stats["tiles_per_device"],
            "committed_iters": gp.kv.last_solve_info["iterations"]}


def _mesh_stored_journey(mesh, N):
    """The stored-K journey's configuration (phase 9: N=1M,
    ``gp2Scale_traced_lml=False``, sparseCGpre, bfloat16 tile storage, CG
    to 1e-4, 64 prediction points) across the mesh's ranks, each holding
    its own row blocks' tiles: assembly, one trial ``log_likelihood(hps)``,
    ``posterior_covariance`` on 64 points — K1 launches counted (set to 0
    just before, read just after), peak memory — then the recompute of a
    1,024-point append."""
    import torch

    from fvgp_tpu_torch.ops import hopper_kernels as hk
    from fvgp_tpu_torch.parallel import mesh as pm
    times = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hk.reset_launch_counts()
    with pm.use_mesh(mesh):
        gp, x, y, xp, hps = stored_journey_model(N)
        t0 = time.time()
        K = gp.K
        torch.cuda.synchronize()
        times["assemble_K_s"] = time.time() - t0
        t0 = time.time()
        trial = gp.log_likelihood(hps)
        torch.cuda.synchronize()
        times["trial_lml_s"] = time.time() - t0
        info = dict(gp.kv.last_solve_info)
        samples = gp.kv.last_logdet_info["num_samples"]
        t0 = time.time()
        S = gp.posterior_covariance(xp)["S"]
        torch.cuda.synchronize()
        times["posterior_covariance_64_s"] = time.time() - t0
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        s = K._store
        facts = {"tiles_rank": int(s.tiles.shape[0]), "live_rank": s.live,
                 "live_all": K.live_tiles_global,
                 "gib_rank": s.tiles.numel() * s.tiles.element_size()
                 / 2**30, "W": s.W,
                 # a k = 1 float32 product gathers every rank's W·B rows
                 "gathered_bytes_per_matvec": mesh.size * s.W * K.block_size
                 * 4}
        on_mesh = K.mesh is mesh
        del K
        rng = np.random.default_rng(6)
        x_new = rng.uniform(0, x.max(), (1024, 3))
        torch.cuda.synchronize()
        t0 = time.time()
        gp.update_gp_data(x_new, np.sin(0.2 * x_new[:, 0]), append=True,
                          noise_variances_new=np.full(1024, 1e-2))
        K2 = gp.K
        torch.cuda.synchronize()
        times["append_1024_s"] = time.time() - t0
    if not (on_mesh and K2.mesh is mesh and K2.shape == (N + 1024,) * 2
            and np.isfinite(trial) and S.shape == (64, 64)
            and np.all(np.isfinite(S))):
        raise AssertionError("the N=1M stored-K mesh journey gave a wrong "
                             "layout or non-finite results")
    return {"lml": float(trial), "cg_iterations": info["iterations"],
            "slq_samples": samples, "S": np.asarray(S), "times": times,
            "launches": launches, "peak_gib": peak, **facts}


def _dryrun_errs(got, one):
    """The dryrun's relative errors (__graft_entry__.py:193-196)."""
    def rel(a, b):
        return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))
    return {"loss": abs(got["lml"] - one["lml"]) / max(abs(one["lml"]), 1.0),
            "grad": rel(got["grad"], one["grad"]),
            "mean": rel(got["mean"], one["mean"]),
            "var": rel(got["var"], one["var"])}


def _held_against_cpu(tag, got, ref, dtype):
    errs = {"lml": abs(got["lml"] - ref[0]) / abs(ref[0]),
            "grad": float(np.linalg.norm(got["grad"] - ref[1])
                          / np.linalg.norm(ref[1])),
            "mean": float(np.abs(got["mean"] - ref[2]).max()),
            "var": float(np.abs(got["var"] - ref[3]).max())}
    bounds = BOUNDS[dtype]
    log(f"mesh {tag} vs CPU float64: " + ", ".join(
        f"{k} {errs[k]:.3e} (bound {bounds[k]:g})" for k in errs))
    bad = [k for k in errs if not errs[k] <= bounds[k]]
    if bad:
        raise AssertionError(f"mesh {tag} out of bounds against the CPU: "
                             f"{bad}")


def mesh_phase(ref):
    """ROADMAP item 1.8's first part on the card: 2 gloo ranks sharing it
    (N=10,000 float32 and bfloat16 streaming against one rank and against
    the CPU's float64 ``ref`` at the same probes; then the N=1M journey),
    then, side by side on the card, 4 gloo ranks as 2 x 2 with the
    hierarchical halo and a one-rank NCCL world.  The stored K (ROADMAP
    item 1.8, second part) rides in the pair world: five modes at N=10,240
    in float32 and sparseCGpre with bfloat16 storage against one rank and
    against the CPU in float64 (computed here while the ranks work), and
    the N=1M stored-K journey across both ranks.  Returns the launches of
    the two N=1M mesh journeys, both ranks summed, by journey."""
    import torch
    torch.cuda.empty_cache()
    t0 = time.time()
    started = _start_world("_mesh_pair_task", 2)
    stored_ref = stored_mesh_reference()
    log(f"mesh: the stored-K CPU float64 reference (N=10,240, "
        f"{len(stored_ref)} modes) took {time.time() - t0:.1f} s beside the "
        f"ranks")
    pair = _join_world(started)
    log(f"mesh: 2 gloo ranks on {pair[0]['device']} ({time.time() - t0:.1f} "
        f"s with both N=1M journeys); collectives of rank 0: "
        f"{json.dumps(pair[0]['ops'])} (gloo takes CUDA tensors for all of "
        f"them: none staged through host memory)")
    for name in ("float32", "bfloat16"):
        got, one = pair[0][name], pair[0][f"{name} one rank"]
        if not (pair[1][name]["lml"] == got["lml"]
                and np.array_equal(pair[1][name]["mean"], got["mean"])):
            raise AssertionError(f"mesh {name}: the ranks disagree")
        _held_against_cpu(f"2 ranks ({got['exchange']}) {name}", got, ref,
                          name)
        errs = _dryrun_errs(got, one)
        log(f"mesh 2 ranks {name} vs one rank on the card: " + ", ".join(
            f"{k} {errs[k]:.3e} (dryrun bound {MESH_ONE_RANK_BOUNDS[k]:g})"
            for k in errs))
        if name == "float32":
            bad = [k for k in errs if not errs[k] <= MESH_ONE_RANK_BOUNDS[k]]
            if bad:
                raise AssertionError(f"mesh float32 vs one rank: {bad}")
    n1m = [r["n1m"] for r in pair]
    log("mesh N=1M gp2Scale journey, 2 gloo ranks time-sliced on one card, "
        "not a scaling figure: " + json.dumps({
            "times_rank0": {k: round(v, 4) for k, v in
                            n1m[0]["times"].items()},
            "times_rank1": {k: round(v, 4) for k, v in
                            n1m[1]["times"].items()},
            "peak_gib": [round(r["peak_gib"], 2) for r in n1m],
            "k1_launches": [r["launches"]["chunked_spmm"] for r in n1m],
            "k5_launches": [[r["launches"][k] for k in K5] for r in n1m],
            "exchange": n1m[0]["exchange"],
            "bytes_per_matvec": n1m[0]["bytes_per_matvec"],
            "tiles_per_rank": n1m[0]["tiles_per_rank"],
            "committed_cg_iterations": n1m[0]["committed_iters"],
            "lml": n1m[0]["lml"]}))
    if n1m[0]["lml"] != n1m[1]["lml"]:
        raise AssertionError("mesh N=1M: the ranks disagree")
    for r in n1m:
        for name in ("chunked_spmm", *K5):
            if r["launches"][name] < 1:
                raise AssertionError(f"{name} never launched on a rank of "
                                     f"the mesh journey")
    _check_stored_mesh([r["stored"] for r in pair], stored_ref)
    _report_stored_n1m([r["stored_n1m"] for r in pair])
    t0 = time.time()
    started = (_start_world("_mesh_hier_task", 4),
               _start_world("_mesh_nccl_task", 1, gloo=False))
    hier, (nccl,) = (_join_world(w) for w in started)
    log(f"mesh: the 2 x 2 gloo world and the one-rank NCCL world, side by "
        f"side, {time.time() - t0:.1f} s")
    if hier[0]["exchange"] != "hier":
        raise AssertionError(f"the 2 x 2 mesh ran {hier[0]['exchange']}")
    _held_against_cpu(f"4 ranks 2 x 2 ({hier[0]['exchange']}) float32",
                      hier[0], ref, "float32")
    _held_against_cpu("one-rank NCCL float32", nccl, ref, "float32")
    return {journey: {name: sum(r[journey]["launches"][name] for r in pair)
                      for name in REPLACES}
            for journey in ("n1m", "stored_n1m")}


def _check_stored_mesh(ranks, ref):
    """The pair task's stored-K models: the same bits on both ranks,
    MESH_STORED_ONE_RANK of each output's scale from rank 0 alone (with
    equal CG iterations and SLQ samples), STORED_BOUNDS from the CPU in
    float64 (bfloat16 storage against the float64 sparseCGpre)."""
    got, other = ranks
    for mode in MESH_STORED_MODES + ("sparseCGpre bfloat16",):
        g, o, one = got[mode], other[mode], got[f"{mode} one rank"]
        if not (g["lml"] == o["lml"] and np.array_equal(g["KX"], o["KX"])
                and np.array_equal(g["S"], o["S"])):
            raise AssertionError(f"mesh stored {mode}: the ranks disagree")
        errs = {"matmat": scale_err(g["KX"], one["KX"]),
                "lml": abs(g["lml"] - one["lml"]) / abs(one["lml"]),
                "S": scale_err(g["S"], one["S"])}
        counts = (g["iters"], g["samples"]) == (one["iters"], one["samples"])
        storage = "bfloat16" if "bfloat16" in mode else "float32"
        r = ref[mode.split()[0]]
        cpu = {"matmat": scale_err(g["KX"], r["KX"]),
               "lml": abs(g["lml"] - r["lml"]) / abs(r["lml"]),
               "S": float(np.abs(g["S"] - r["S"]).max())}
        bounds = STORED_BOUNDS[storage]
        log(f"mesh stored {mode} (N=10,240, 2 ranks): vs one rank "
            + ", ".join(f"{k} {errs[k]:.3e}" for k in errs)
            + f" (bound {MESH_STORED_ONE_RANK:g} of the scale; CG "
            f"{g['iters']} / {one['iters']}, SLQ samples {g['samples']} / "
            f"{one['samples']}); vs CPU float64 "
            + ", ".join(f"{k} {cpu[k]:.3e} (bound {bounds[k]:g})"
                        for k in cpu))
        bad = [k for k in errs if not errs[k] <= MESH_STORED_ONE_RANK]
        bad += [f"cpu {k}" for k in cpu if not cpu[k] <= bounds[k]]
        if bad or not counts:
            raise AssertionError(f"mesh stored {mode}: {bad}, counts equal "
                                 f"{counts}")
    t_mesh, shape = got["sparseCGpre"]["append"]
    t_one, _ = got["sparseCGpre one rank"]["append"]
    log(f"mesh stored: an aligned 1,024-point append at N=10,240 -> {shape}: "
        f"recomputed across 2 ranks in {t_mesh:.3f} s (row-owned: on the "
        f"mesh {got['sparseCGpre']['append_on_mesh']}), stacked on one rank "
        f"in {t_one:.3f} s")
    if not got["sparseCGpre"]["append_on_mesh"]:
        raise AssertionError("the appended K left the mesh")


def _report_stored_n1m(ranks):
    """The N=1M stored-K journey across 2 ranks: per-rank facts, and the
    ranks' agreement."""
    if not (ranks[0]["lml"] == ranks[1]["lml"]
            and np.array_equal(ranks[0]["S"], ranks[1]["S"])):
        raise AssertionError("mesh stored N=1M: the ranks disagree")
    keys = ("tiles_rank", "live_rank", "gib_rank", "peak_gib", "W")
    log("mesh stored-K N=1M journey (bf16 storage, sparseCGpre), 2 gloo "
        "ranks time-sliced on one card, not a scaling figure: " + json.dumps({
            **{f"{k}_per_rank": [r[k] for r in ranks] for k in keys},
            "live_all": ranks[0]["live_all"],
            "times_per_rank": [{k: round(v, 4) for k, v in r["times"].items()}
                               for r in ranks],
            "k1_launches_per_rank": [r["launches"]["chunked_spmm"]
                                     for r in ranks],
            "gathered_bytes_per_k1_matvec":
                ranks[0]["gathered_bytes_per_matvec"],
            "trial_lml": ranks[0]["lml"],
            "cg_iterations": ranks[0]["cg_iterations"],
            "slq_samples": ranks[0]["slq_samples"]}))
    if sum(r["live_rank"] for r in ranks) != ranks[0]["live_all"]:
        raise AssertionError("mesh stored N=1M: the ranks' tiles do not add "
                             "up to the matrix's")
    for r in ranks:
        if r["launches"]["chunked_spmm"] < 1:
            raise AssertionError("K1 never launched on the stored-K mesh "
                                 "journey")


# ---------------------------------------------------------------------------
# the rest of the JAX package's surface: the nine examples, the rest of the
# kernel catalog, asynchronous training under a mesh
# ---------------------------------------------------------------------------

EXAMPLES = ("single_task", "deep_kernel", "multi_task", "non_euclidean",
            "gp2scale_sparse", "gplvm_latent", "manifold_gpm",
            "ggmp_multitask", "multichip_mesh")
# examples/gp2scale_sparse.py sizes itself at 20,000 points on an
# accelerator
GP2SCALE_EXAMPLE_N = 20_000
# an example's numbers at its first hyperparameters, the card's float32 run
# against the CPU's float64 one, at the PERF.md §2 bounds of the path it
# takes: gp2Scale's float32 bounds for the two gp2Scale examples (the mesh
# example's against the CPU too).  The dense-family examples keep their
# default noise, (0.01 mean|y|)^2, and their K+V condition numbers reach
# 1e3-1e6 (single_task 1.9e6, the deep kernel 2.4e6, multi_task 2.1e3),
# where float32 sits up to 1e-2 from float64 (the first chip run of the
# phase read single_task's LML at 3.8e-3): as §2 does for the deep kernel,
# GPm and GPLVM, their float32 errors are printed beside cond(K+V), and
# held at the dense bounds only where cond(K+V) <= EXAMPLE_COND_HELD
# (non_euclidean 15, ggmp_multitask 8); every dense-family example is
# held in float64 on the card at EXAMPLE_F64_BOUND
EXAMPLE_BOUNDS = {"gp2scale_sparse": BOUNDS["float32"],
                  "multichip_mesh": BOUNDS["float32"]}
EXAMPLE_DENSE_BOUNDS = {**DENSE_BOUNDS, "S": 1e-3, "pdf": 1e-3}
EXAMPLE_COND_HELD = 1e3
EXAMPLE_F64 = ("single_task", "deep_kernel", "multi_task", "non_euclidean",
               "gplvm_latent", "manifold_gpm", "ggmp_multitask")
EXAMPLE_F64_BOUND = 1e-8
EXAMPLE_MESH_RANKS = 4
# the catalog functions on the card against the CPU in float64, of each
# output's scale: float64 (the card's exp / sin / sort differ from the
# CPU's in the last bits), float32
CATALOG_BOUNDS = {"float64": 1e-12, "float32": 1e-4}
ASYNC_RANKS = 2
ASYNC_ITERS = {"adam": 60, "mcmc": 60}


def _example(name):
    import importlib
    return importlib.import_module(f"fvgp_tpu_torch.examples.{name}")


def _example_first(name, device, args=None):
    """An example's numbers at its first hyperparameters, at the
    accelerator's size."""
    kw = {"n": GP2SCALE_EXAMPLE_N} if name == "gp2scale_sparse" else {}
    return _example(name).first(device, args=args, **kw)


def _examples_reference_task(rank, world):
    """The nine examples' first numbers on the CPU in float64 — a process
    of its own, beside the card's runs (half the cores)."""
    import torch
    torch.set_num_threads(4)
    return {name: _example_first(name, "cpu") for name in EXAMPLES}


def _example_run(name, card):
    """(returned numbers, seconds, launches, peak GiB) of an example's
    ``main`` on ``card``, the counts set to 0 just before it."""
    import torch
    kw = {"n": GP2SCALE_EXAMPLE_N} if name == "gp2scale_sparse" else {}
    if card == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out, secs, launches = counted(
            lambda: _example(name).main(device=card, **kw))
        return out, secs, launches, \
            torch.cuda.max_memory_allocated() / 2**30
    t0 = time.time()
    return _example(name).main(device=card, **kw), time.time() - t0, \
        launch_counts(), float("nan")


def _examples_mesh_task(rank, world, card="cuda"):
    """``multichip_mesh`` as ``world`` gloo ranks sharing the card."""
    from fvgp_tpu_torch.ops import hopper_kernels as hk
    if card == "cuda":
        hk.build_kernels()
    hk.reset_launch_counts()
    out, secs, launches, peak = _example_run("multichip_mesh", card)
    return {"out": out, "seconds": secs, "launches": launches,
            "peak_gib": peak}


def _examples_mesh_task_cpu(rank, world):
    return _examples_mesh_task(rank, world, card="cpu")


def _bitwise_equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_bitwise_equal(a[k], b[k])
                                            for k in a)
    return np.array_equal(np.asarray(a), np.asarray(b))


def _example_condition(name):
    """cond(K+V) at the first hyperparameters of an example whose model is
    a ``GP`` (a GGMP's worst component), from the CPU float64 model; None
    for the others."""
    import torch
    if name in ("gp2scale_sparse", "multichip_mesh", "gplvm_latent",
                "manifold_gpm"):
        return None
    model = _example(name).model("cpu")
    gps = model.gps if name == "ggmp_multitask" else [model]
    return max(_condition(gp.prior.K + torch.diag(gp.likelihood.V), "cpu")
               for gp in gps)


def _example_errors(got, ref):
    return _ext_errors({k: got[k] for k in ref}, ref)


def examples_phase(card="cuda"):
    """(a) The nine examples (``fvgp_tpu_torch/examples``) on the card at
    the JAX examples' accelerator sizes, each ``main()`` counted: seconds,
    peak device memory and K1-K4 launches; ``multichip_mesh`` as 4 gloo
    ranks sharing the card.  Each example's numbers at its first
    hyperparameters are held against the same example in float64 on the
    CPU (a process of its own, started first) at EXAMPLE_BOUNDS (the
    dense-family examples' float32 errors are printed beside cond(K+V)),
    and the dense-family examples' in float64 on the card at
    EXAMPLE_F64_BOUND.  Every check is made before a failure is raised.
    Returns each example's launches."""
    t0 = time.time()
    ref_started = _start_world("_examples_reference_task", 1, gloo=False)
    runs, paths = {}, {}
    for name in EXAMPLES[:-1]:
        out, secs, launches, peak = _example_run(name, card)
        runs[name] = (out, secs, peak, launches)
    mesh_task = "_examples_mesh_task" if card == "cuda" \
        else "_examples_mesh_task_cpu"
    ranks = _join_world(_start_world(mesh_task, EXAMPLE_MESH_RANKS))
    if not all(_bitwise_equal(r["out"], ranks[0]["out"]) for r in ranks):
        raise AssertionError("multichip_mesh: the ranks disagree")
    runs["multichip_mesh"] = (
        ranks[0]["out"], max(r["seconds"] for r in ranks),
        max(r["peak_gib"] for r in ranks),
        {k: sum(r["launches"][k] for r in ranks) for k in REPLACES})
    t_ref = time.time()
    ref = _join_world(ref_started)[0]
    log(f"examples: the CPU float64 references were ready "
        f"{time.time() - t_ref:.1f} s after the card's runs "
        f"({time.time() - t0:.1f} s in all)")
    kern = dict(zip(REPLACES, ("K1", "K2", "K3", "K4", "K5", "K5 VJP")))
    failed = []

    def hold(tag, errs, bounds):
        try:
            held(tag, errs, bounds)
        except AssertionError as exc:
            failed.append(str(exc))

    for name in EXAMPLES:
        out, secs, peak, launches = runs[name]
        paths[name] = launches
        extra = f" on {EXAMPLE_MESH_RANKS} gloo ranks" \
            if name == "multichip_mesh" else ""
        log(f"example {name}{extra}: {secs:.2f} s, peak {peak:.2f} GiB, "
            "launches " + ", ".join(f"{kern[k]} {launches[k]}"
                                    for k in REPLACES)
            + f"; LML {float(out['first']['lml']):.6g} -> "
            f"{float(out['lml']):.6g}")
        cond = _example_condition(name)
        bounds = EXAMPLE_DENSE_BOUNDS if cond and cond <= EXAMPLE_COND_HELD \
            else EXAMPLE_BOUNDS.get(name, {})
        hold(f"example {name}, first hyperparameters, {card} float32 vs "
             f"CPU float64" + (f", cond(K+V) {cond:.3e}" if cond else ""),
             _example_errors(out["first"], ref[name]), bounds)
        if not float(out["lml"]) >= float(out["first"]["lml"]) \
                - 1e-6 * abs(float(out["first"]["lml"])):
            failed.append(f"example {name}: training lowered the LML")
    for name in EXAMPLE_F64:
        got = _example_first(name, card, args={"dtype": "float64"})
        hold(f"example {name}, first hyperparameters, {card} float64 vs "
             "CPU float64", _example_errors(got, ref[name]),
             {k: EXAMPLE_F64_BOUND for k in ("lml", "mean", "var", "S",
                                              "pdf")})
    if failed:
        raise AssertionError("examples phase: " + "; ".join(failed))
    if card == "cuda" and not any(paths[n]["dense_covariance"]
                                  for n in EXAMPLES):
        raise AssertionError("no example launched K3")
    return paths


def _catalog_cases():
    rng = np.random.default_rng(0)
    x1, x2 = rng.uniform(0, 3, (700, 2)), rng.uniform(0, 3, (500, 2))
    x0, w = rng.uniform(0, 3, (40, 2)), rng.uniform(0.5, 1.5, 40)
    a, b = rng.uniform(0.1, 1.0, (600, 64)), rng.uniform(0.1, 1.0, (300, 64))
    h4 = [1.0, 1.5, 1.0, 0.7]
    return {"linear_kernel": (x1, x2[:1], 1.0, 2.0, 0.5),
            "dot_product_kernel": (x1.T, x2.T, 0.3, np.diag([1.0, 2.0])),
            "polynomial_kernel": (x1.T, x2.T, 3.0),
            "non_stat_kernel": (x1, x2, x0, w, 1.2),
            "non_stat_kernel_gradient": (x1, x2, x0, w, 1.2),
            "wasserstein_1d": (a[0], a[1]),
            "wasserstein_1d_outer_vec": (a, b),
            "bump": (np.linspace(0.0, 2.0, 4001), 1.3, 0.7, 2.0),
            "sle_kernel": (x1, x2, h4, {"x_data": x0})}


def catalog_phase(card="cuda"):
    """(b) The kernel catalog's new functions on the card (float64 and
    float32 tensors) against their CPU float64 values, at CATALOG_BOUNDS
    of each output's scale; the ``_sparse`` Wendland kernel on card
    tensors, ``covariance_csr`` of a port kernel evaluated on the card,
    and the op-level ``assemble_tiles`` / ``tile_maxabs``."""
    import torch

    from fvgp_tpu_torch import kernels as K
    from fvgp_tpu_torch.ops import sparse_lml as sl
    from fvgp_tpu_torch.parallel import sharded_cov as sc

    def on(args, device, dtype):
        return tuple(a if isinstance(a, (float, dict)) else
                     torch.as_tensor(np.asarray(a), dtype=dtype).to(device)
                     for a in args)

    for name, args in _catalog_cases().items():
        ref = getattr(K, name)(*on(args, "cpu", torch.float64)).numpy()
        errs = {}
        for dname, dtype in (("float64", torch.float64),
                             ("float32", torch.float32)):
            got = getattr(K, name)(*on(args, card, dtype))
            errs[dname] = scale_err(got.double().cpu().numpy(), ref)
        held(f"catalog {name} {tuple(np.shape(ref))}, {card} vs CPU "
             "float64", errs, CATALOG_BOUNDS)
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 30, (2000, 2))
    hps = np.array([1.2, 1.0, 1.5])
    ref = K.wendland_anisotropic_gp2Scale_cpu_sparse(x, x[:700], hps)
    got = K.wendland_anisotropic_gp2Scale_cpu_sparse(
        *on((x, x[:700], hps), card, torch.float32))
    held(f"catalog wendland_anisotropic_gp2Scale_cpu_sparse (2000, 700), "
         f"{card} float32 tensors in", {
             "float32": scale_err(got.toarray(), ref.toarray()),
             "nnz_diff": float(abs(got.nnz - ref.nnz))},
         {"float32": CATALOG_BOUNDS["float32"]})
    ref = sc.covariance_csr(K.wendland_anisotropic, x, x, hps,
                            batch_size=500, compute_device="cpu")
    t0 = time.time()
    got = sc.covariance_csr(K.wendland_anisotropic, x, x, hps,
                            batch_size=500, compute_device=card)
    held(f"covariance_csr N=2000, blocks of 500 evaluated on {card} "
         f"(float32) in {time.time() - t0:.3f} s",
         {"float32": scale_err(got.toarray(), ref.toarray())},
         {"float32": CATALOG_BOUNDS["float32"]})
    B = 64
    xb_h, mask_h, *_ = sl.make_padded_inputs(x, np.zeros(len(x)),
                                             np.full(len(x), 1e-2), B,
                                             dtype=torch.float64,
                                             device="cpu")
    nb = xb_h.shape[0]
    rows = np.concatenate([np.repeat(np.arange(nb), nb), [nb]])
    cols = np.concatenate([np.tile(np.arange(nb), nb), [0]])
    ref_t = sl.assemble_tiles(K.wendland_anisotropic, xb_h, mask_h, rows,
                              cols, hps).numpy()
    ref_m = sl.tile_maxabs(K.wendland_anisotropic, xb_h, mask_h, rows, cols,
                           hps).numpy()
    errs = {}
    for dname, dtype in (("float64", torch.float64),
                         ("float32", torch.float32)):
        xb, mask = xb_h.to(card, dtype), mask_h.to(card, dtype)
        errs[dname] = scale_err(sl.assemble_tiles(
            K.wendland_anisotropic, xb, mask, rows, cols,
            hps).double().cpu().numpy(), ref_t)
        live = sl.tile_maxabs(K.wendland_anisotropic, xb, mask, rows, cols,
                              hps).cpu().numpy() > 0
        errs[f"live_tiles_diff_{dname}"] = float(np.sum(live != (ref_m > 0)))
    held(f"assemble_tiles / tile_maxabs, {len(rows)} tiles of {B}, {card} "
         "vs CPU float64", errs, CATALOG_BOUNDS)


def _async_data(n=2000):
    rng = np.random.default_rng(21)
    x = rng.uniform(0, 20, (n, 2))
    y = np.sin(x[:, 0]) + 0.1 * np.cos(3 * x[:, 1]) \
        + 0.05 * rng.standard_normal(n)
    return x, y


def _async_mesh_task(rank, world, card="cuda"):
    """Asynchronous ``"adam"`` and ``"mcmc"`` on a dense N=2,000 GP (float32),
    the ranks seeded apart, each polling three times at its own pace and
    drawing from numpy meanwhile; then an MCMC stopped by rank 0 first."""
    from fvgp_tpu_torch import GP
    from fvgp_tpu_torch.ops import hopper_kernels as hk
    from fvgp_tpu_torch.parallel import mesh as pm
    if card == "cuda":
        hk.build_kernels()
    bounds = np.array([[0.1, 5.0], [0.2, 10.0], [0.2, 10.0]])
    x, y = _async_data()
    out = {}
    with pm.use_mesh(pm.make_mesh(layout="1d")):
        gp = GP(x, y, init_hyperparameters=np.array([1.0, 1.5, 1.5]),
                noise_variances=np.full(len(x), 1e-2), compute_device=card)
        for method, iters in ASYNC_ITERS.items():
            np.random.seed(100 + rank)
            t0 = time.time()
            opt = gp.train(hyperparameter_bounds=bounds, method=method,
                           max_iter=iters, asynchronous=True)
            polls, steps = [], []
            for k in range(3):
                time.sleep(0.05 * (k + 1) * (1 + 3 * rank))
                np.random.uniform(size=1 + 7 * rank)
                polls.append(gp.update_hyperparameters(opt).copy())
                steps.append(opt.agreed_step)
            opt.actor.join(300)
            polls.append(gp.update_hyperparameters(opt).copy())
            out[method] = {"polls": polls, "steps": steps,
                           "published": opt.actor.published_steps(),
                           "seconds": time.time() - t0}
        np.random.seed(7 + rank)
        opt = gp.train(hyperparameter_bounds=bounds, method="mcmc",
                       max_iter=100_000, asynchronous=True)
        time.sleep(1.0 + 1.0 * rank)
        gp.stop_training(opt)
        opt.actor.join(300)
        out["stop"] = {"published": opt.actor.published_steps(),
                       "poll": gp.update_hyperparameters(opt).copy()}
    return out


def _async_mesh_task_cpu(rank, world):
    return _async_mesh_task(rank, world, card="cpu")


def async_phase(card="cuda"):
    """(c) ``train_async`` on 2 gloo ranks sharing the card: every poll,
    taken at different times on the two ranks, gives both the same bits;
    a stop asked for at different times ends both at the same step."""
    t0 = time.time()
    task = "_async_mesh_task" if card == "cuda" else "_async_mesh_task_cpu"
    a, b = _join_world(_start_world(task, ASYNC_RANKS))
    for method in ASYNC_ITERS:
        ra, rb = a[method], b[method]
        if not (ra["steps"] == rb["steps"]
                and all(np.array_equal(p, q)
                        for p, q in zip(ra["polls"], rb["polls"]))):
            raise AssertionError(f"train_async {method}: the ranks' polls "
                                 "differ")
        log(f"train_async {method} on {ASYNC_RANKS} gloo ranks ({card}, "
            f"float32, dense N=2,000): polls at steps {ra['steps']} of "
            f"{ra['published']}, bitwise equal on both ranks; "
            f"{ra['seconds']:.2f} s / {rb['seconds']:.2f} s")
    if not (a["stop"]["published"] == b["stop"]["published"]
            and np.array_equal(a["stop"]["poll"], b["stop"]["poll"])):
        raise AssertionError("train_async: the ranks stopped apart")
    log(f"train_async mcmc stopped by rank 0 at 1 s, by rank 1 at 2 s: both "
        f"at step {a['stop']['published']}; {time.time() - t0:.1f} s")


# the tier phase: a member against the facade's own value of the
# same quantity in the same precision — the dense cell's float32 bounds
# (PERF.md §2) for KVinvY (of its scale) and log|K+V| (relative), the
# stored K's bfloat16-storage bounds for its trial LML (relative) and
# K + V (of the scale of its product); the kernels on card tensors against
# the facade's K at the float32 / bfloat16-storage bounds of K @ X
TIER_BOUNDS = {"dense": {"KVinvY": DENSE_BOUNDS["mean"],
                         "logdet": DENSE_BOUNDS["lml"],
                         "addKV": KERNEL_RTOL, "custom_lml":
                         DENSE_BOUNDS["lml"],
                         "default_matern_ard": STORED_BOUNDS["float32"][
                             "matmat"]},
               "stored": {"lml": STORED_BOUNDS["bfloat16"]["lml"],
                          "addKV": STORED_BOUNDS["bfloat16"]["matmat"],
                          "wendland_anisotropic":
                              STORED_BOUNDS["bfloat16"]["matmat"]}}


def _tier_lml(kv, m, KVinvY, logdet):
    """The LML of a (KVinvY, log|K+V|) pair, as the facade forms it."""
    import math
    import torch
    ym = kv._y_minus(torch.as_tensor(m, dtype=KVinvY.dtype)
                     .to(KVinvY.device))
    return -0.5 * (float(torch.sum(ym * KVinvY)) / ym.shape[1] + logdet
                   + len(ym) * math.log(2.0 * math.pi))


def tier_phase(card="cuda", n_dense=10_000, n_stored=10_240):
    """14. The tier objects' members with host (numpy) inputs, on the dense
    cell's model and on the stored K, held against the facade's own values
    (``TIER_BOUNDS``); one counted path.  ``tier_phase("cpu", 1000, 1280)``
    rehearses it off the card."""
    import torch

    from fvgp_tpu_torch import GP, config
    from fvgp_tpu_torch.kernels import default_matern_ard, wendland_anisotropic
    from fvgp_tpu_torch.models.gp_kv import resolve_linalg_mode
    from fvgp_tpu_torch.ops import hopper_kernels as hk
    on_card = card != "cpu"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    host = config.to_numpy
    times = {}
    sync()
    hk.reset_launch_counts()
    t_phase = time.time()
    # the dense cell: N = 10^4, Chol, float32 on the card
    x, y, _ = dense_cell_data(n_dense)
    hps = np.array([1.0, 1.5, 1.5, 1.5])
    t0 = time.time()
    gp = dense_model(x, y, hps, card)
    kv, ml, post = gp.kv, gp.marginal_likelihood, gp.posterior
    K_h, V_h, m_h = host(kv.K), host(kv.V), host(kv.m)
    ref_y, ref_ld = kv.KVinvY, kv.logdet_KV
    sync()
    times["dense model and host copies"] = time.time() - t0
    errs = {}
    for tier in (kv, ml):
        t0 = time.time()
        KVinvY, logdet = tier.compute_new_KVlogdet_KVinvY(K_h, V_h, m_h)
        sync()
        name = type(tier).__name__
        times[f"dense {name}.compute_new_KVlogdet_KVinvY"] = \
            time.time() - t0
        errs[f"{name} KVinvY"] = scale_err(host(KVinvY), host(ref_y))
        errs[f"{name} logdet"] = abs(logdet - ref_ld) / abs(ref_ld)
    if not (post.KVinvY is kv.KVinvY and post.K is gp.prior.K
            and post.m is gp.prior.m and post.KVinvY.shape == (n_dense, 1)):
        raise AssertionError("posterior.KVinvY / K / m are not the model's")
    # a K+V made by addKV from host K and V lands on the default backend
    # (the card) and goes into the float32 model's solve
    t0 = time.time()
    KV_h = kv.addKV(K_h, V_h)
    sync()
    times["dense addKV(host K, host V)"] = time.time() - t0
    t0 = time.time()
    y_h = kv.compute_new_KVinvY(KV_h, m_h)
    sync()
    times["dense compute_new_KVinvY(that K+V)"] = time.time() - t0
    t0 = time.time()
    errs["addKV host"] = scale_err(host(KV_h), host(kv.KV))
    errs["addKV card K"] = scale_err(host(kv.addKV(kv.K, V_h)), host(kv.KV))
    errs["compute_new_KVinvY(addKV host) KVinvY"] = scale_err(host(y_h),
                                                              host(ref_y))
    times["dense addKV checks (host copies, addKV(card K, host V))"] = \
        time.time() - t0
    if on_card and KV_h.device.type != "cuda":
        raise AssertionError(f"addKV(host K, host V) on {KV_h.device}")
    del KV_h, y_h

    def factor(KV):
        return torch.linalg.cholesky(KV)

    def solve(L, b):
        return torch.cholesky_solve(b, L)

    def logdet_of(L):
        return 2.0 * float(torch.sum(torch.log(torch.diagonal(L))))

    triple = [factor, solve, logdet_of]
    t0 = time.time()
    custom = GP(x, y, init_hyperparameters=hps,
                noise_variances=np.full(len(x), 1e-2), compute_device=card,
                linalg_mode=triple)
    if resolve_linalg_mode(custom.kv.linalg_mode, custom.args) \
            != (triple, custom.args) or custom.kv.mode is not triple:
        raise AssertionError("a custom mode did not pass resolve_linalg_mode")
    lml_c = custom.log_likelihood()
    _, ld_c = custom.kv.compute_new_KVlogdet_KVinvY(K_h, V_h, m_h)
    sync()
    times["dense custom-triple GP, LML, compute_new_KVlogdet_KVinvY"] = \
        time.time() - t0
    lml_d = gp.log_likelihood()
    errs["custom_lml"] = max(abs(lml_c - lml_d),
                             abs(_tier_lml(kv, m_h, ref_y, ld_c) - lml_d)) \
        / abs(lml_d)
    t0 = time.time()
    x_t = torch.as_tensor(np.asarray(gp.x_data), dtype=gp.prior.dtype) \
        .to(gp.device)
    K_cat = default_matern_ard(x_t, x_t, gp.hyperparameters)
    sync()
    times["dense default_matern_ard(card x, card x, numpy hps)"] = \
        time.time() - t0
    errs["default_matern_ard"] = scale_err(host(K_cat), K_h)
    del K_cat
    # the catalog on numpy alone: K on the default backend (the card) in
    # float64, taken by the float32 model's compute_new_KVlogdet_KVinvY
    t0 = time.time()
    x_h = np.asarray(gp.x_data)
    K_np = default_matern_ard(x_h, x_h, np.asarray(gp.hyperparameters))
    y_np, ld_np = kv.compute_new_KVlogdet_KVinvY(K_np, V_h, m_h)
    sync()
    times["dense default_matern_ard(numpy) into "
          "compute_new_KVlogdet_KVinvY"] = time.time() - t0
    if on_card and K_np.device.type != "cuda":
        raise AssertionError(f"default_matern_ard(numpy) on {K_np.device}")
    errs["default_matern_ard numpy"] = scale_err(host(K_np), K_h)
    errs["catalog K KVinvY"] = scale_err(host(y_np), host(ref_y))
    errs["catalog K logdet"] = abs(ld_np - ref_ld) / abs(ref_ld)
    del custom, K_np, y_np, K_h
    held(f"tier phase, dense N={n_dense} Chol {gp.prior.dtype} on {card}, "
         "against the facade's own values", {
             "KVinvY": max(v for k, v in errs.items() if "KVinvY" in k),
             "logdet": max(v for k, v in errs.items() if "logdet" in k),
             "addKV": max(errs["addKV host"], errs["addKV card K"]),
             "custom_lml": errs["custom_lml"],
             "default_matern_ard": max(errs["default_matern_ard"],
                                       errs["default_matern_ard numpy"])},
         TIER_BOUNDS["dense"])
    del gp, kv, ml, post, ref_y
    if on_card:
        torch.cuda.empty_cache()

    # the stored K: N = 10,240, sparseCGpre, bfloat16 tile storage
    x, y, _ = journey_data(n_stored, seed=4)
    hps = np.array([1.0, 2.0, 2.0, 2.0])
    t0 = time.time()
    gp = stored_model(x, y, hps, card, {"gp2Scale_storage_dtype": "bfloat16"})
    kv, ml, post = gp.kv, gp.marginal_likelihood, gp.posterior
    K = kv.K
    V_h, m_h = host(kv.V), host(kv.m)
    sync()
    times["stored model and K"] = time.time() - t0
    errs = {}
    lml_ref = gp.log_likelihood(hps)            # the facade's trial LML
    for tier in (kv, ml):
        t0 = time.time()
        KVinvY, logdet = tier.compute_new_KVlogdet_KVinvY(K, V_h, m_h)
        sync()
        name = type(tier).__name__
        times[f"stored {name}.compute_new_KVlogdet_KVinvY"] = \
            time.time() - t0
        errs[f"{name} lml"] = abs(_tier_lml(kv, m_h, KVinvY, logdet)
                                  - lml_ref) / abs(lml_ref)
    t0 = time.time()
    committed = post.KVinvY
    sync()
    times["stored posterior.KVinvY (committed solve)"] = time.time() - t0
    if not (committed is kv.KVinvY and post.K is gp.prior.K
            and post.m is gp.prior.m and committed.shape == (n_stored, 1)
            and bool(torch.all(torch.isfinite(committed)))):
        raise AssertionError("stored posterior.KVinvY / K / m are not the "
                             "model's")
    X = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (n_stored, 4)), dtype=gp.prior.dtype).to(gp.device)
    t0 = time.time()
    ref_kx = host(kv.KV.matmat(X))
    errs["addKV"] = scale_err(host(kv.addKV(K, V_h).matmat(X)), ref_kx)
    times["stored addKV (host V) and two products"] = time.time() - t0
    # the model's own order of the points (gp2Scale sorts them in space)
    x_t = torch.as_tensor(np.asarray(gp.x_data), dtype=gp.prior.dtype) \
        .to(gp.device)
    t0 = time.time()
    K_cat = wendland_anisotropic(x_t, x_t, gp.hyperparameters)
    sync()
    times["stored wendland_anisotropic(card x, card x, numpy hps)"] = \
        time.time() - t0
    errs["wendland_anisotropic"] = scale_err(host(K_cat), host(K.to_dense()))
    del K_cat
    held(f"tier phase, stored K N={n_stored} sparseCGpre {K.tiles.dtype} "
         f"storage on {card}, against the facade's own values", {
             "lml": max(v for k, v in errs.items() if "lml" in k),
             "addKV": errs["addKV"],
             "wendland_anisotropic": errs["wendland_anisotropic"]},
         TIER_BOUNDS["stored"])
    sync()
    launches = launch_counts()
    log(f"tier phase: {time.time() - t_phase:.2f} s; seconds by step: "
        + json.dumps({k: round(v, 4) for k, v in times.items()}))
    log(f"tier phase launches: {json.dumps(launches)}")
    if on_card and not (launches["chunked_spmm"] >= 1
                        and launches["dense_covariance"] >= 1):
        raise AssertionError(f"the tier phase missed K1 or K3: {launches}")
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
    cpu_ref = cross_check()
    log(f"gp2Scale cross-check phase: {time.time() - t0:.1f} s")
    t0 = time.time()
    dense_cross_check()
    log(f"dense cross-check phase: {time.time() - t0:.1f} s")
    t0 = time.time()
    posterior_api_cross_check()
    log(f"posterior API cross-check phase: {time.time() - t0:.1f} s")
    t0 = time.time()
    training_cross_check()
    log(f"training cross-check phase: {time.time() - t0:.1f} s")
    t0 = time.time()
    merged_launches, diagonal_launches = item16_cross_check()
    log(f"host-callable / structured-noise / non-Euclidean / fvGP "
        f"cross-check phase: {time.time() - t0:.1f} s")
    t0 = time.time()
    dense_launches, dense_api_launches, dense_train_launches = \
        dense_journey(10_000)
    log(f"dense journey, posterior API and training phase: "
        f"{time.time() - t0:.1f} s")
    t0 = time.time()
    multitask_launches = multitask_phase()
    formula_launches = formula_phase()
    log(f"multi-task and formula-gradient phases: {time.time() - t0:.1f} s")
    t0 = time.time()
    slice_cross_check()
    log(f"slice cross-check phase: {time.time() - t0:.1f} s")
    t0 = time.time()
    sparse_launches, traced_lml, slice_launches = full_journey(1_000_000)
    log(f"gp2Scale journey, slice, posterior API and training phase: "
        f"{time.time() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.time()
    committed_launches = committed_posterior_phase(1_000_000)
    log(f"committed posterior float32 N=1M phase: {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.time()
    stored_cross_check()
    log(f"stored-K cross-check phase: {time.time() - t0:.1f} s")
    t0 = time.time()
    stored_launches, stored_records = stored_journey(1_000_000, traced_lml)
    log(f"stored-K journey phase: {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.time()
    structured_launches, merged_record = structured_noise_phase(1_000_000)
    log(f"structured-noise N=1M phase: {time.time() - t0:.1f} s")
    t0 = time.time()
    non_euclidean_launches = non_euclidean_phase()
    log(f"non-Euclidean gp2Scale phase: {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.time()
    extensions_cross_check()
    log(f"extensions cross-check phase: {time.time() - t0:.1f} s")
    t0 = time.time()
    extension_launches = extensions_phases()
    log(f"extensions phases (deep kernel, GPm, GPLVM, GGMP): "
        f"{time.time() - t0:.1f} s")
    t0 = time.time()
    mesh_launches = mesh_phase(cpu_ref)
    log(f"mesh phase: {time.time() - t0:.1f} s")
    t0 = time.time()
    example_launches = examples_phase()
    log(f"examples phase (nine examples, the CPU float64 references "
        f"beside them): {time.time() - t0:.1f} s")
    t0 = time.time()
    catalog_phase()
    log(f"kernel catalog phase: {time.time() - t0:.1f} s")
    t0 = time.time()
    async_phase()
    log(f"asynchronous training on the mesh phase: {time.time() - t0:.1f} s")
    t0 = time.time()
    tier_launches = tier_phase()
    log(f"tier phase: {time.time() - t0:.1f} s")
    # each kernel's launches on the four paths, each read just after its
    # run: K4's ops entry, the dense journey, the gp2Scale journey, the
    # stored-K journey
    paths = [spmv_launches, dense_launches, dense_api_launches,
             dense_train_launches, sparse_launches, slice_launches["slq"],
             slice_launches["two_level"], slice_launches["posterior_api"],
             slice_launches["training"], committed_launches,
             stored_launches, merged_launches,
             diagonal_launches, multitask_launches, formula_launches,
             structured_launches, non_euclidean_launches,
             *extension_launches.values(), *mesh_launches.values(),
             *example_launches.values(), tier_launches]
    launches = {name: sum(p[name] for p in paths) for name in REPLACES}
    for kern, name in (("K1", "chunked_spmm"), ("K2", "row_chunk_sums"),
                       ("K5", "tile_covariance"),
                       ("K5 VJP", "tile_covariance_vjp")):
        log(f"{kern} launches by path: " + json.dumps(
            {"gp2Scale journey": sparse_launches[name],
             "SLQ solver (3 LML+grad)": slice_launches["slq"][name],
             "two-level variance": slice_launches["two_level"][name],
             "gp2Scale posterior API": slice_launches["posterior_api"][name],
             "gp2Scale training": slice_launches["training"][name],
             "committed posterior float32 (n = 500)":
                 committed_launches[name],
             "stored-K journey": stored_launches[name],
             "merged K+V LML (N=10,240)": merged_launches[name],
             "diagonal noise callable posterior": diagonal_launches[name],
             "structured noise N=1M": structured_launches[name],
             "non-Euclidean gp2Scale": non_euclidean_launches[name],
             "mesh N=1M (2 ranks)": mesh_launches["n1m"][name],
             "mesh stored-K N=1M (2 ranks)":
                 mesh_launches["stored_n1m"][name],
             "tier phase": tier_launches[name]}))
    log("K3 launches by path: " + json.dumps(
        {"dense journey": dense_launches["dense_covariance"],
         "dense posterior API": dense_api_launches["dense_covariance"],
         "dense training": dense_train_launches["dense_covariance"],
         "fvGP multi-task": multitask_launches["dense_covariance"],
         "formula gradient": formula_launches["dense_covariance"],
         **{path: total["dense_covariance"]
            for path, total in extension_launches.items()},
         **{f"example {name}": total["dense_covariance"]
            for name, total in example_launches.items()},
         "tier phase": tier_launches["dense_covariance"]}))
    log("K1 on the merged float32 K+V (bfloat16 K + scipy noise, N = 1M), "
        "k = 1: " + json.dumps(merged_record))
    log("K1 at the SLQ batch width (k = 16, N = 1M structure): "
        + json.dumps(records.pop("k1_slq_batch")))
    log("K2 row_chunk_sums by dtype and width (N = 50k structure, B = "
        "128, C = 8): " + json.dumps(records.pop("k2")))
    log("K5 tile_covariance / tile_covariance_vjp (N = 1M structure; "
        "replace no Pallas kernel): " + json.dumps(records.pop("k5")))
    log("K1 with nb_out != nb (rank 0 of 2, N = 1M structure): "
        + json.dumps(records.pop("k1_rank")))
    log("K1 with nb_out != nb on the stored N = 1M K (rank 0 of 2, bf16 "
        "storage, X as two bf16 halves), k = 1 and 4: "
        + json.dumps(records.pop("k1_stored_rank")))
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
