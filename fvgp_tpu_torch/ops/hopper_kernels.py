"""Hand-written Hopper kernels, with their plain PyTorch versions and launch
counters.

Four kernels, all in ``csrc/hopper_kernels.cu`` (CUDA C++ for ``sm_90a``,
built with ``nvcc`` at first use into ``fvgp_tpu_torch/_build/`` and loaded
with ``ctypes`` through a plain C interface):

* ``chunked_spmm`` (K1) replaces the Pallas ``chunked_spmm`` of
  ``fvgp_tpu/ops/pallas_kernels.py`` — the SpMM of every mBCG iteration.
  ``Y[rows[t]] += tiles[t] @ X[cols[t]]`` over a ROW-SORTED tile list: one
  thread block owns a 64-row slice of one output row block and all k
  columns, walks that row's tiles through CSR row offsets, and writes its
  output once — no atomics, deterministic.  A grid of at most two waves
  starts the longest rows first.  Bound by the tile stream
  (T·B² elements) at k = 17: the tile slices stream through a cp.async
  ring into tensor-core MMAs (bfloat16 ``mma.sync``; float32 as a 3×TF32
  split, which keeps float32 accuracy).  The TPU version's VMEM gate does
  not exist here, every T and every N is served.
* ``row_chunk_sums`` (K2) replaces the Pallas ``row_chunk_sums`` — the
  wide-RHS SpMM of the committed posterior CG.  Per C-tile chunk of a
  row-aligned schedule it returns one (B, c) float32 partial sum, reading the
  X blocks through ``cols`` itself (no pre-gathered X).  Bfloat16 runs on
  ``wgmma`` fed by TMA copies (the gather folded into the copy) through an
  mbarrier ring, bound by the bytes of the tiles; float32 takes K1's 3×TF32
  body with chunks as segments.
* ``dense_covariance`` (K3) replaces the Pallas ``dense_covariance`` —
  ``K = σ²·poly(‖(x1−x2)/ℓ‖)`` (Matérn-3/2 or Wendland) from exact
  per-dimension differences, float32 or float64.  A write-only stream,
  bound by the output write in float32 and by the arithmetic in float64:
  one launch whitens the inputs while loading them (the IEEE ``x / ℓ`` of
  the plain version), a block owns a 128 × 128 (float64: 64 × 64) tile,
  a thread keeps its 4 (2) columns' coordinates in registers and writes
  one 16-byte store per row; an ``n2`` whose rows are not 16-byte aligned
  takes the scalar-store instance of the same kernel.  ``x2`` that IS
  ``x1`` (one storage, decided on the host) computes, where the arithmetic
  and not the stores sets the time (float64, or D > 4), the tiles on and
  above the diagonal only and writes each twice, the second time
  transposed: bit for bit the full result, exactly symmetric.  The dense
  GP's default kernel (``kernels.default_matern_ard``) calls it for every
  covariance built while autograd does not record.
* ``block_spmv`` (K4) replaces the Pallas ``block_spmv`` — ``y = A·X`` over
  a row-sorted tile list with the JAX wrapper's contract (zero rows without
  tiles, ragged ``n``, 1-D ``X``, sentinel padding); K1's body over CSR row
  offsets, float32 accumulation, output in X's dtype.  Its launch path
  copies nothing it does not have to: the caller's index tensors go to the
  kernel as they are (the row offsets are kept on the rows tensor, so a
  structure pays the sortedness check's host sync once), and the ragged
  ends of X and of the output are handled in the kernel.

The SpMM wrappers pad X's columns to a multiple of 8 (a copy where they are
not), so that every row of X is 16-byte aligned for the asynchronous copies.

Dispatch is decided before launch: a CPU tensor takes the plain version; a
CUDA tensor of a dtype the kernel takes launches it and never falls back,
the dtype picking the body; float64 follows the JAX package's rule
(``sparse_lml.py:356-360``): K1 and K4 take the plain formulation, K2
refuses it (its callers keep the plain scan); K3 runs float64 in the kernel.
Each wrapper counts its launches in a plain integer attribute
(``chunked_spmm.launches`` and so on).
"""

import ctypes
import os
import shutil
import subprocess
import time
import uuid
from pathlib import Path

import numpy as np
import torch

from ..kernels import _safe_sqrt, _wendland_poly, matern_kernel_diff1
from ..utils import trace

__all__ = ["chunked_spmm", "chunked_spmm_reference", "chunked_spmm_vjp",
           "row_chunk_sums", "row_chunk_sums_reference",
           "row_aligned_schedule", "dense_covariance",
           "dense_covariance_reference", "block_spmv",
           "block_spmv_reference", "build_kernels", "reset_launch_counts"]

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "hopper_kernels.cu"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_SO = _BUILD_DIR / "libfvgp_hopper.so"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-ldl"]
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def build_kernels(verbose=False):
    """Compile ``csrc/hopper_kernels.cu`` with nvcc (when the library is
    missing or older than the source) and load it.  Returns
    ``(seconds, compiler log)``; the log holds ``-Xptxas -v``'s register and
    shared-memory report when ``verbose``."""
    global _lib
    t0 = time.time()
    log = ""
    if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not Path(nvcc).exists():
            raise RuntimeError("nvcc not found: the Hopper kernels are built "
                               "with the CUDA toolkit on the machine with "
                               "the card")
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # a file of this process's own, renamed into place in one step: the
        # ranks of a mesh build together and none may load a partial library
        tmp = _BUILD_DIR / f".{_SO.name}.{os.getpid()}.{uuid.uuid4().hex}"
        cmd = [nvcc, *_NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(_SRC)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{proc.stderr}")
            os.replace(tmp, _SO)
        finally:
            tmp.unlink(missing_ok=True)
        log = proc.stderr
    lib = ctypes.CDLL(str(_SO))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fvgp_chunked_spmm.argtypes = [vp, vp, vp, vp, vp, vp, i32, i32, i32,
                                      i32, i32, i32, vp]
    lib.fvgp_chunked_spmm.restype = i32
    lib.fvgp_row_chunk_sums.argtypes = [vp, vp, vp, vp, i64, i32, i32, i32,
                                        i32, i32, i32, vp]
    lib.fvgp_row_chunk_sums.restype = i32
    lib.fvgp_block_spmv.argtypes = [vp, vp, vp, vp, vp, vp, i32, i32, i32,
                                    i32, i64, i64, i32, vp]
    lib.fvgp_block_spmv.restype = i32
    lib.fvgp_dense_covariance.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32,
                                          i32, i32, vp]
    lib.fvgp_dense_covariance.restype = i32
    _lib = lib
    return time.time() - t0, log


def _kernels():
    if _lib is None:
        build_kernels()
    return _lib


def reset_launch_counts():
    chunked_spmm.launches = 0
    row_chunk_sums.launches = 0
    dense_covariance.launches = 0
    block_spmv.launches = 0


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _check_kernel_inputs(name, tiles, X, B):
    if tiles.dtype not in _KERNEL_DTYPES or X.dtype != tiles.dtype:
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16 tiles "
                        f"and X of one dtype, got {tiles.dtype} / {X.dtype}")
    if B < 32 or B % 32:
        raise ValueError(f"{name}: the kernel needs a block size that is a "
                         f"multiple of 32, got B={B}")
    if tiles.dim() != 3 or tiles.shape[1:] != (B, B):
        raise ValueError(f"{name}: tiles must be (T, {B}, {B}), got "
                         f"{tuple(tiles.shape)}")


def _aligned(name, t):
    """``t`` contiguous, refused unless it starts on the 16-byte boundary
    that the kernels' asynchronous copies need."""
    t = t.contiguous()
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: operands must start on a 16-byte "
                         "boundary")
    return t


def _pad_cols(name, X):
    """X (..., k) with its columns zero-padded to a multiple of 8 (a copy
    where k is not one), so that every row is 16-byte aligned."""
    pad = -X.shape[-1] % 8
    return _aligned(name, torch.nn.functional.pad(X, (0, pad)) if pad else X)


def _row_segments(name, rows, nb):
    """CSR row offsets (nb + 1,) int32 of a row-sorted tile list (rows >= nb
    fall past the last offset) and the row blocks by descending tile count:
    the kernel's launch order when its grid is at most two waves, so long
    rows start first instead of trailing it.  An unsorted list is refused:
    the row-owning kernels (K1, K4) would skip its out-of-order tiles.
    Kept on the rows tensor, for its current version, so the check's host
    sync is paid once per structure rather than once per launch."""
    kept = getattr(rows, "_fvgp_row_segments", None)
    if kept is not None and kept[:2] == (rows._version, nb):
        return kept[2], kept[3]
    r = rows.to(torch.int32).contiguous()
    if r.numel() > 1:
        trace.count("host_syncs")
        if bool((r[1:] < r[:-1]).any()):
            raise ValueError(f"{name}: the tile list must be row-sorted "
                             "(sort the schedule once on the host)")
    row_ptr = torch.searchsorted(
        r, torch.arange(nb + 1, dtype=torch.int32, device=r.device)
    ).to(torch.int32)
    order = torch.argsort(row_ptr[1:] - row_ptr[:-1], descending=True,
                          stable=True).to(torch.int32)
    rows._fvgp_row_segments = (rows._version, nb, row_ptr, order)
    return row_ptr, order


# ---------------------------------------------------------------------------
# K1: chunked_spmm — the training-path SpMM
# ---------------------------------------------------------------------------

def chunked_spmm_reference(rows, cols, tiles, X, nb, B, mv_dtype=None,
                           nb_out=None):
    """Plain PyTorch ``Y = A @ X`` for the tile list (the JAX ``_spmv``):
    per-tile products in the accumulation dtype, summed into row blocks.
    X has ``nb`` blocks and Y ``nb_out`` (default ``nb``; a mesh rank's own
    row blocks against a gathered X).  Rows >= nb_out are dropped; columns
    must be < nb (clamped sentinel columns carry zero tiles)."""
    nb_out = nb if nb_out is None else nb_out
    acc = X.dtype if X.dtype == torch.float64 else torch.float32
    if mv_dtype is not None:
        tiles = tiles.to(mv_dtype)
        X_c = X.to(mv_dtype)
    else:
        X_c = X
    k = X.shape[1]
    Xb = X_c.reshape(nb, B, k)
    prod = torch.bmm(tiles.to(acc), Xb[cols.long()].to(acc))
    out = torch.zeros((nb_out + 1, B, k), dtype=acc, device=X.device)
    out = out.index_add(0, rows.long().clamp(max=nb_out), prod)
    return out[:nb_out].reshape(nb_out * B, k).to(X.dtype)


def chunked_spmm_vjp(rows, cols, tiles, X, Ybar, nb, B, mv_dtype=None,
                     need_x=True, chunk=32768, nb_out=None):
    """Cotangents of ``Y = chunked_spmm(rows, cols, tiles, X, nb, B,
    nb_out=nb_out)`` (plain torch, as in the JAX custom VJP):

        tiles_bar[t] = Ybar[rows[t]] @ X[cols[t]]ᵀ      (in tiles.dtype)
        X_bar        = Aᵀ Ybar                          (index_add over cols)

    Evaluated in tile slices of ``chunk`` so the gathered (chunk, B, k)
    operands stay small; ``tiles_bar`` is the one (T, B, B) result."""
    nb_out = nb if nb_out is None else nb_out
    k = X.shape[1]
    acc = X.dtype if X.dtype == torch.float64 else torch.float32
    work = mv_dtype if mv_dtype is not None else X.dtype
    Yb = Ybar.reshape(nb_out, B, k).to(work)
    Xb = X.reshape(nb, B, k).to(work)
    r = rows.long().clamp(max=nb_out - 1)
    c = cols.long().clamp(max=nb - 1)
    live = (rows.long() < nb_out).to(work)[:, None, None]
    tiles_bar = torch.empty_like(tiles)
    X_bar = torch.zeros((nb, B, k), dtype=acc, device=X.device) \
        if need_x else None
    for s in range(0, tiles.shape[0], chunk):
        sl = slice(s, s + chunk)
        Yg = Yb[r[sl]] * live[sl]
        tiles_bar[sl] = torch.bmm(Yg, Xb[c[sl]].transpose(1, 2)) \
            .to(tiles.dtype)
        if need_x:
            contrib = torch.bmm(tiles[sl].to(work).to(acc).transpose(1, 2),
                                Yg.to(acc))
            X_bar.index_add_(0, c[sl], contrib)
    if need_x:
        X_bar = X_bar.reshape(nb * B, k).to(X.dtype)
    return tiles_bar, X_bar


def _launch_chunked_spmm(rows, cols, tiles, X_c, nb, B, nb_out=None):
    """One K1 launch on the tensors' device; returns (nb_out*B, k) float32
    (``nb_out`` defaults to X's block count ``nb``)."""
    nb_out = nb if nb_out is None else nb_out
    k = X_c.shape[1]
    _check_kernel_inputs("chunked_spmm", tiles, X_c, B)
    if X_c.shape[0] != nb * B:
        raise ValueError(f"chunked_spmm: X must have nb*B={nb * B} rows")
    row_ptr, order = _row_segments("chunked_spmm", rows, nb_out)
    cols = cols.to(torch.int32).contiguous()
    tiles = _aligned("chunked_spmm", tiles)
    Xp = _pad_cols("chunked_spmm", X_c)
    out = torch.empty((nb_out * B, k), dtype=torch.float32,
                      device=X_c.device)
    lib = _kernels()
    with torch.cuda.device(X_c.device):
        err = lib.fvgp_chunked_spmm(
            _ptr(tiles), _ptr(Xp), _ptr(row_ptr), _ptr(order), _ptr(cols),
            _ptr(out), nb, nb_out, B, k, Xp.shape[1],
            _KERNEL_DTYPES[tiles.dtype], _stream(X_c))
    if err != 0:
        raise RuntimeError(f"chunked_spmm: kernel launch failed with CUDA "
                           f"error {err}")
    chunked_spmm.launches += 1
    return out


class _ChunkedSpmmKernel(torch.autograd.Function):
    """K1 forward; the backward is the plain-torch VJP (the tile cotangent IS
    a (T, B, B) batched outer product written to memory, so a kernel would
    not reduce its traffic)."""

    @staticmethod
    def forward(ctx, rows, cols, tiles, X, nb, B, mv_dtype, nb_out):
        work = mv_dtype if mv_dtype is not None else X.dtype
        out = _launch_chunked_spmm(rows, cols, tiles.to(work), X.to(work),
                                   nb, B, nb_out)
        ctx.save_for_backward(rows, cols, tiles, X)
        ctx.nb, ctx.B, ctx.mv_dtype, ctx.nb_out = nb, B, mv_dtype, nb_out
        return out.to(X.dtype)

    @staticmethod
    def backward(ctx, ybar):
        rows, cols, tiles, X = ctx.saved_tensors
        tiles_bar, X_bar = chunked_spmm_vjp(
            rows, cols, tiles, X, ybar, ctx.nb, ctx.B, ctx.mv_dtype,
            need_x=ctx.needs_input_grad[3], nb_out=ctx.nb_out)
        return None, None, tiles_bar, X_bar, None, None, None, None


def chunked_spmm(rows, cols, tiles, X, nb, B, mv_dtype=None, nb_out=None):
    """``Y = A @ X`` over a row-sorted tile list (same contract as the plain
    version): X has ``nb`` blocks, Y ``nb_out`` (default ``nb``).  Sentinel
    rows (== nb_out) are skipped — they fall past the last CSR offset — so
    bucket padding costs nothing when passed unclamped; clamped sentinels
    must carry zero tiles and all land on the last row block's thread
    block.  CPU tensors and float64 work take the plain version;
    float32/bfloat16 CUDA tensors launch the K1 kernel."""
    work = mv_dtype if mv_dtype is not None else X.dtype
    if X.device.type == "cpu" or work == torch.float64:
        return chunked_spmm_reference(rows, cols, tiles, X, nb, B, mv_dtype,
                                      nb_out)
    return _ChunkedSpmmKernel.apply(rows, cols, tiles, X, nb, B, mv_dtype,
                                    nb_out)


chunked_spmm.launches = 0


# ---------------------------------------------------------------------------
# K2: row_chunk_sums — the committed-path wide SpMM
# ---------------------------------------------------------------------------

def row_aligned_schedule(rows, cols, nb, C=8, chunk_bucket=256):
    """Host helper: regroup a row-sorted tile schedule so every C tiles
    share one output row block.

    Returns ``(rows_p, cols_p, rowsc, n_chunks)``: per-tile indices padded
    per row to a multiple of ``C`` (sentinel ``col == nb`` marks padding —
    the assembler zeroes those tiles), and the per-chunk output row index
    ``rowsc`` (sentinel ``nb`` on trailing bucket-padding chunks, which the
    caller routes to a dummy output block).  ``n_chunks`` is bucketed to
    multiples of ``chunk_bucket``."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    counts = np.bincount(rows, minlength=nb)
    padded = -(-counts // C) * C
    total = int(padded.sum())
    n_chunks = -(-max(total // C, 1) // chunk_bucket) * chunk_bucket
    T_pad = n_chunks * C
    rows_p = np.full(T_pad, nb, np.int32)
    cols_p = np.full(T_pad, nb, np.int32)
    starts = np.zeros(nb + 1, np.int64)
    np.cumsum(padded, out=starts[1:])
    # rows are sorted: each row's tiles are one contiguous slice
    src_starts = np.zeros(nb + 1, np.int64)
    np.cumsum(counts, out=src_starts[1:])
    idx = np.arange(len(rows))
    dst = starts[rows] + (idx - src_starts[rows])
    rows_p[dst] = rows
    cols_p[dst] = cols
    # padded in-row slots keep the row (alignment) with a sentinel col
    pad_rows = np.repeat(np.arange(nb, dtype=np.int32),
                         (padded - counts).astype(np.int64))
    pad_dst = []
    off = starts[:-1] + counts
    for r, extra in zip(*np.unique(pad_rows, return_counts=True)):
        pad_dst.append(np.arange(off[r], off[r] + extra))
    if pad_dst:
        pad_dst = np.concatenate(pad_dst)
        rows_p[pad_dst] = pad_rows
        cols_p[pad_dst] = nb
    rowsc = np.full(n_chunks, nb, np.int32)
    rowsc[: total // C] = np.repeat(np.arange(nb, dtype=np.int32),
                                    (padded // C).astype(np.int64))
    return rows_p, cols_p, rowsc, n_chunks


def row_chunk_sums_reference(tiles, cols, Xb, B, C=8):
    """Plain PyTorch per-chunk sums ``out[s] = Σ_{j<C} tiles[sC+j] @
    Xb[min(cols[sC+j], nb-1)]`` in float32 — ``Xb`` is (nb, B, c)."""
    nb, _, c = Xb.shape
    xg = Xb[cols.long().clamp(max=nb - 1)].to(torch.float32)
    prod = torch.bmm(tiles.to(torch.float32), xg)
    return prod.reshape(-1, C, B, c).sum(dim=1)


def row_chunk_sums(tiles, cols, Xb, B, C=8):
    """Per-chunk partial products of a row-aligned schedule slice (see
    :func:`row_chunk_sums_reference`).  CPU tensors take the plain version;
    float32/bfloat16 CUDA tensors launch the K2 kernel."""
    if Xb.device.type == "cpu":
        return row_chunk_sums_reference(tiles, cols, Xb, B, C)
    _check_kernel_inputs("row_chunk_sums", tiles, Xb, B)
    nb, _, c = Xb.shape
    if tiles.shape[0] % C or cols.shape[0] != tiles.shape[0]:
        raise ValueError("row_chunk_sums: the slice must hold whole "
                         f"C={C}-tile chunks with one column index per tile")
    n_chunks = tiles.shape[0] // C
    tiles = _aligned("row_chunk_sums", tiles)
    Xp = _pad_cols("row_chunk_sums", Xb)
    cols = cols.to(torch.int32).contiguous()
    out = torch.empty((n_chunks, B, c), dtype=torch.float32, device=Xb.device)
    lib = _kernels()
    with torch.cuda.device(Xb.device):
        err = lib.fvgp_row_chunk_sums(
            _ptr(tiles), _ptr(Xp), _ptr(cols), _ptr(out), n_chunks, C, nb, B,
            c, Xp.shape[2], _KERNEL_DTYPES[tiles.dtype], _stream(Xb))
    if err != 0:
        raise RuntimeError(f"row_chunk_sums: kernel launch failed with CUDA "
                           f"error {err}")
    row_chunk_sums.launches += 1
    return out


row_chunk_sums.launches = 0


# ---------------------------------------------------------------------------
# K3: dense_covariance — the dense path's covariance assembly
# ---------------------------------------------------------------------------

_COV_KINDS = {"matern32": 0, "wendland": 1}
_COV_DTYPES = {torch.float32: 0, torch.float64: 2}
_COV_MAX_DIM = 32
_COV_VECTOR = {torch.float32: 4, torch.float64: 2}    # values in 16 bytes
# the launch flags of fvgp_dense_covariance: x2 is x1; 16-byte stores; the
# streaming (evict-first) store hint, which the wrapper always gives (the
# output passes through L2 once; measured 4% faster at 10^4 x 10^4 float32,
# chip_profile.py k3)
_COV_SYMMETRIC, _COV_VECTOR_STORES, _COV_STREAMING = 1, 2, 4


def _cov_operands(x1, x2, hyperparameters):
    if x1.dim() != 2 or x2.dim() != 2 or x1.shape[1] != x2.shape[1]:
        raise ValueError("dense_covariance: x1 and x2 must be (n, D) with one "
                         f"D, got {tuple(x1.shape)} and {tuple(x2.shape)}")
    hps = torch.as_tensor(hyperparameters, dtype=x1.dtype, device=x1.device)
    return hps, hps[1:1 + x1.shape[1]]


def dense_covariance_reference(x1, x2, hyperparameters, kind="matern32"):
    """Plain PyTorch ``K = hps[0]·poly(‖(x1−x2)/ℓ‖)`` with ℓ =
    hps[1:1+D]: the whitened distance from exact per-dimension differences
    (an (n1, n2, D) intermediate), ``kind`` "matern32" or "wendland"."""
    if kind not in _COV_KINDS:
        raise ValueError(f"dense_covariance: unknown kind {kind!r}")
    hps, ls = _cov_operands(x1, x2, hyperparameters)
    diff = (x1 / ls)[:, None, :] - (x2 / ls)[None, :, :]
    d = _safe_sqrt(torch.sum(diff * diff, -1))
    if kind == "matern32":
        return hps[0] * matern_kernel_diff1(d, 1.0)
    return hps[0] * _wendland_poly(d)


def _cov_vector_stores(n2, dtype):
    """True when K3 may write 16-byte vectors: a row of the output starts
    ``n2 * itemsize`` bytes after the last, so every row is 16-byte aligned
    only for ``n2 % 4 == 0`` (float32) or ``n2 % 2 == 0`` (float64).  Other
    ``n2`` take the scalar-store instance of the same kernel."""
    return n2 % _COV_VECTOR[dtype] == 0


def _same_storage(a, b):
    """True when ``b`` is ``a``'s very data: one device, dtype, address,
    shape and strides.  Decided from the tensors' descriptions on the host,
    never by comparing values: equal values in another tensor do not
    count."""
    return a is b or (a.device == b.device and a.dtype == b.dtype
                      and a.data_ptr() == b.data_ptr()
                      and a.shape == b.shape and a.stride() == b.stride())


def _cov_symmetric_route(x1, x2):
    """True when K3 computes only the tiles on and above the diagonal and
    mirrors them: ``x2`` is ``x1`` (:func:`_same_storage`) and the arithmetic,
    not the output write, sets the time — float64, or float32 at D > 4 (the
    run-time-D instance).  Float32 at D <= 4 is bound by its stores, and
    there the mirrored second write costs more than the halved arithmetic
    saves (measured: ``chip_profile.py k3``).  Either route gives the same
    result bit for bit."""
    return _same_storage(x1, x2) and (x1.dtype == torch.float64
                                      or x1.shape[1] > 4)


def _launch_dense_covariance(x1, x2, hps, kind, symmetric):
    """One K3 launch on contiguous CUDA operands of one dtype; ``symmetric``
    needs ``x2`` to be ``x1``."""
    n1, D = x1.shape
    n2 = x2.shape[0]
    out = torch.empty((n1, n2), dtype=x1.dtype, device=x1.device)
    flags = _COV_STREAMING | (_COV_SYMMETRIC if symmetric else 0) \
        | (_COV_VECTOR_STORES if _cov_vector_stores(n2, x1.dtype) else 0)
    lib = _kernels()
    with torch.cuda.device(x1.device):
        err = lib.fvgp_dense_covariance(
            _ptr(x1), _ptr(x2), _ptr(hps), _ptr(out), n1, n2, D,
            _COV_KINDS[kind], _COV_DTYPES[x1.dtype], flags, _stream(x1))
    if err != 0:
        raise RuntimeError(f"dense_covariance: kernel launch failed with CUDA "
                           f"error {err}")
    dense_covariance.launches += 1
    return out


def dense_covariance(x1, x2, hyperparameters, kind="matern32"):
    """``K = k(x1, x2)`` (see :func:`dense_covariance_reference`).  CPU
    tensors take the plain version; float32/float64 CUDA tensors launch the
    K3 kernel, once: it whitens the inputs itself.  ``x2`` that is ``x1``
    gives an exactly symmetric result with the signal variance exactly on
    the diagonal, by whichever route :func:`_cov_symmetric_route` picks.
    The kernel has no backward: it refuses inputs for which autograd
    records."""
    if x1.device.type == "cpu":
        return dense_covariance_reference(x1, x2, hyperparameters, kind)
    if kind not in _COV_KINDS:
        raise ValueError(f"dense_covariance: unknown kind {kind!r}")
    if x1.dtype not in _COV_DTYPES or x2.dtype != x1.dtype \
            or x2.device != x1.device:
        raise TypeError("dense_covariance: the kernel takes float32 or "
                        "float64 x1 and x2 of one dtype on one device, got "
                        f"{x1.dtype} / {x2.dtype}")
    hps, _ = _cov_operands(x1, x2, hyperparameters)
    if torch.is_grad_enabled() and (x1.requires_grad or x2.requires_grad
                                    or hps.requires_grad):
        raise RuntimeError("dense_covariance: the kernel has no backward; "
                           "evaluate the plain formula under autograd")
    D = x1.shape[1]
    if D > _COV_MAX_DIM:
        raise ValueError(f"dense_covariance: the kernel takes D <= "
                         f"{_COV_MAX_DIM}, got {D}")
    if hps.dim() != 1 or hps.shape[0] < 1 + D:
        raise ValueError("dense_covariance: hyperparameters must hold the "
                         f"signal variance and {D} lengthscales")
    same = _same_storage(x1, x2)
    symmetric = _cov_symmetric_route(x1, x2)
    x1 = x1.contiguous()
    x2 = x1 if same else x2.contiguous()
    return _launch_dense_covariance(x1, x2, hps.contiguous(), kind, symmetric)


dense_covariance.launches = 0


# ---------------------------------------------------------------------------
# K4: block_spmv — y = A·X over a row-sorted tile list
# ---------------------------------------------------------------------------

def _spmv_operands(rows, cols, X, nb, B):
    """(padded X (nb*B, k), clamped rows, clamped cols, squeeze) — the JAX
    wrapper's contract (``pallas_kernels.py:115-124``)."""
    squeeze = X.dim() == 1
    if squeeze:
        X = X[:, None]
    Xp = torch.zeros((nb * B, X.shape[1]), dtype=X.dtype, device=X.device)
    Xp[:X.shape[0]] = X
    r = torch.as_tensor(rows, device=X.device).to(torch.int32).clamp(
        max=nb - 1)
    c = torch.as_tensor(cols, device=X.device).to(torch.int32).clamp(
        max=nb - 1)
    return Xp, r, c, squeeze


def _spmv_result(out, X, n, squeeze):
    out = out[:X.shape[0] if n is None else n]
    return out[:, 0] if squeeze else out


def block_spmv_reference(rows, cols, tiles, X, nb, block_size, n=None):
    """Plain PyTorch ``y = A @ X``: X (n, k) or (n,) padded to nb·B rows,
    rows and cols clamped to nb − 1 (sentinels carry zero tiles), per-tile
    products accumulated in float32 (float64 for float64 X) into row blocks —
    rows with no tile stay zero — and returned in X's dtype, truncated to
    ``n`` (default: X's length)."""
    B = block_size
    Xp, r, c, squeeze = _spmv_operands(rows, cols, X, nb, B)
    k = Xp.shape[1]
    acc = torch.float64 if X.dtype == torch.float64 else torch.float32
    prod = torch.bmm(tiles.to(acc), Xp.reshape(nb, B, k)[c.long()].to(acc))
    out = torch.zeros((nb, B, k), dtype=acc, device=X.device)
    out.index_add_(0, r.long(), prod)
    return _spmv_result(out.reshape(nb * B, k).to(X.dtype), X, n, squeeze)


def block_spmv(rows, cols, tiles, X, nb, block_size, n=None):
    """``y = A @ X`` over a row-sorted tile list (the contract of
    :func:`block_spmv_reference`).  CPU tensors and float64 take the plain
    version; float32/bfloat16 CUDA tensors (tiles of X's dtype) launch the
    K4 kernel, which writes the rows without tiles as zero itself.

    The launch path copies only what it must.  ``rows`` and ``cols`` go to
    the kernel as the caller's tensors (int32 and contiguous as they come
    from the structure pass; anything else is cast): the kernel clamps the
    columns where it reads X, and rows ``>= nb`` lie past the last row
    offset.  The row offsets and the launch order are kept on the rows
    tensor (:func:`_row_segments`), so the sortedness check's host sync is
    paid on the first call with a structure and not again until the tensor
    is written in place; rows given as a list or a numpy array make a new
    tensor on every call and pay it every time.  X is copied only where
    its rows are not 16-byte aligned (``k % 8 != 0``; a 1-D X is one padded
    copy): the rows past its length are read as zero by the kernel, and the
    output is allocated at its final length.

    One difference from the JAX wrapper, which clamps a sentinel (row or
    column ``== nb``) into the last block and multiplies its zero tile: here
    a sentinel ROW's tile is skipped, not multiplied, so a non-finite value
    in X's last block no longer reaches the last row block through
    ``0 · inf``.  Finite inputs give the same result."""
    if X.device.type == "cpu" or X.dtype == torch.float64:
        return block_spmv_reference(rows, cols, tiles, X, nb, block_size, n)
    B = block_size
    _check_kernel_inputs("block_spmv", tiles, X, B)
    squeeze = X.dim() == 1
    X2 = X[:, None] if squeeze else X
    if X2.dim() != 2 or X2.shape[0] > nb * B:
        raise ValueError(f"block_spmv: X must be (n,) or (n, k) with n <= "
                         f"nb*B={nb * B}, got {tuple(X.shape)}")
    r = torch.as_tensor(rows, device=X.device)
    c = torch.as_tensor(cols, device=X.device).to(torch.int32).contiguous()
    if tiles.shape[0] != r.shape[0] or c.shape[0] != r.shape[0]:
        raise ValueError("block_spmv: rows, cols and tiles must list the same "
                         "number of tiles")
    row_ptr, order = _row_segments("block_spmv", r, nb)
    n_x, k = X2.shape
    n_out = max(0, min(n_x if n is None else n, nb * B))
    out = torch.empty((n_out, k), dtype=X.dtype, device=X.device)
    if n_out > 0:
        Xp = _pad_cols("block_spmv", X2)
        tiles = _aligned("block_spmv", tiles)
        lib = _kernels()
        with torch.cuda.device(X.device):
            err = lib.fvgp_block_spmv(
                _ptr(tiles), _ptr(Xp), _ptr(row_ptr), _ptr(order), _ptr(c),
                _ptr(out), nb, B, k, Xp.shape[1], n_x, n_out,
                _KERNEL_DTYPES[X.dtype], _stream(X))
        if err != 0:
            raise RuntimeError(f"block_spmv: kernel launch failed with CUDA "
                               f"error {err}")
        block_spmv.launches += 1
    return out[:, 0] if squeeze else out


block_spmv.launches = 0
