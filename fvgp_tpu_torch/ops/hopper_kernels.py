"""Hand-written Hopper kernels of the gp2Scale path, with their plain
PyTorch versions and launch counters.

Two kernels, both in ``csrc/hopper_kernels.cu`` (CUDA C++ for ``sm_90a``,
built with ``nvcc`` at first use into ``fvgp_tpu_torch/_build/`` and loaded
with ``ctypes`` through a plain C interface):

* ``chunked_spmm`` (K1) replaces the Pallas ``chunked_spmm`` of
  ``fvgp_tpu/ops/pallas_kernels.py`` — the SpMM of every mBCG iteration.
  ``Y[rows[t]] += tiles[t] @ X[cols[t]]`` over a ROW-SORTED tile list: one
  thread block owns one output row block (a 64- or 32-row slice of it, times
  32 columns), walks that row's tiles through CSR row offsets, and writes its
  output once — no atomics, deterministic.  Bound by the tile stream
  (T·B² elements) at k = 17; the TPU version's VMEM gate does not exist here,
  every T and every N is served.
* ``row_chunk_sums`` (K2) replaces the Pallas ``row_chunk_sums`` — the
  wide-RHS SpMM of the committed posterior CG.  Per C-tile chunk of a
  row-aligned schedule it returns one (B, c) float32 partial sum, reading the
  X blocks through ``cols`` itself (no pre-gathered X).  At c >= 64 it is
  bound by float32 arithmetic on the CUDA cores (tensor cores come later);
  the tile is read from device memory once per 32 columns and L2 serves the
  repeats.

Dispatch is decided before launch: a CPU tensor takes the plain version; a
float32 or bfloat16 CUDA tensor launches the kernel and never falls back;
float64 follows the JAX package's rule (``sparse_lml.py:356-360``): K1 takes
the plain formulation, K2 refuses it (its callers keep the plain scan).
Each wrapper counts its launches in a plain integer attribute
(``chunked_spmm.launches``, ``row_chunk_sums.launches``).
"""

import ctypes
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

__all__ = ["chunked_spmm", "chunked_spmm_reference", "chunked_spmm_vjp",
           "row_chunk_sums", "row_chunk_sums_reference",
           "row_aligned_schedule", "build_kernels", "reset_launch_counts"]

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "hopper_kernels.cu"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_SO = _BUILD_DIR / "libfvgp_hopper.so"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC"]
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
        tmp = _SO.with_suffix(".so.tmp")
        cmd = [nvcc, *_NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(_SRC)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stderr}")
        tmp.replace(_SO)
        log = proc.stderr
    lib = ctypes.CDLL(str(_SO))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fvgp_chunked_spmm.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32, i32,
                                      vp]
    lib.fvgp_chunked_spmm.restype = i32
    lib.fvgp_row_chunk_sums.argtypes = [vp, vp, vp, vp, i64, i32, i32, i32,
                                        i32, i32, vp]
    lib.fvgp_row_chunk_sums.restype = i32
    _lib = lib
    return time.time() - t0, log


def _kernels():
    if _lib is None:
        build_kernels()
    return _lib


def reset_launch_counts():
    chunked_spmm.launches = 0
    row_chunk_sums.launches = 0


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


# ---------------------------------------------------------------------------
# K1: chunked_spmm — the training-path SpMM
# ---------------------------------------------------------------------------

def chunked_spmm_reference(rows, cols, tiles, X, nb, B, mv_dtype=None):
    """Plain PyTorch ``Y = A @ X`` for the tile list (the JAX ``_spmv``):
    per-tile products in the accumulation dtype, summed into row blocks.
    Rows >= nb are dropped; columns must be < nb (clamped sentinel columns
    carry zero tiles)."""
    acc = X.dtype if X.dtype == torch.float64 else torch.float32
    if mv_dtype is not None:
        tiles = tiles.to(mv_dtype)
        X_c = X.to(mv_dtype)
    else:
        X_c = X
    k = X.shape[1]
    Xb = X_c.reshape(nb, B, k)
    prod = torch.bmm(tiles.to(acc), Xb[cols.long()].to(acc))
    out = torch.zeros((nb + 1, B, k), dtype=acc, device=X.device)
    out = out.index_add(0, rows.long().clamp(max=nb), prod)
    return out[:nb].reshape(nb * B, k).to(X.dtype)


def chunked_spmm_vjp(rows, cols, tiles, X, Ybar, nb, B, mv_dtype=None,
                     need_x=True, chunk=32768):
    """Cotangents of ``Y = chunked_spmm(rows, cols, tiles, X)`` (plain torch,
    as in the JAX custom VJP):

        tiles_bar[t] = Ybar[rows[t]] @ X[cols[t]]ᵀ      (in tiles.dtype)
        X_bar        = Aᵀ Ybar                          (index_add over cols)

    Evaluated in tile slices of ``chunk`` so the gathered (chunk, B, k)
    operands stay small; ``tiles_bar`` is the one (T, B, B) result."""
    k = X.shape[1]
    acc = X.dtype if X.dtype == torch.float64 else torch.float32
    work = mv_dtype if mv_dtype is not None else X.dtype
    Yb = Ybar.reshape(nb, B, k).to(work)
    Xb = X.reshape(nb, B, k).to(work)
    r = rows.long().clamp(max=nb - 1)
    c = cols.long().clamp(max=nb - 1)
    live = (rows.long() < nb).to(work)[:, None, None]
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


def _launch_chunked_spmm(rows, cols, tiles, X_c, nb, B):
    """One K1 launch on the tensors' device; returns (nb*B, k) float32."""
    k = X_c.shape[1]
    _check_kernel_inputs("chunked_spmm", tiles, X_c, B)
    if X_c.shape[0] != nb * B:
        raise ValueError(f"chunked_spmm: X must have nb*B={nb * B} rows")
    rows = rows.to(torch.int32).contiguous()
    if rows.numel() > 1 and bool((rows[1:] < rows[:-1]).any()):
        raise ValueError("chunked_spmm: the tile list must be row-sorted "
                         "(sort the schedule once on the host)")
    row_ptr = torch.searchsorted(
        rows, torch.arange(nb + 1, dtype=torch.int32, device=rows.device)
    ).to(torch.int32)
    cols = cols.to(torch.int32).contiguous()
    tiles = tiles.contiguous()
    X_c = X_c.contiguous()
    out = torch.empty((nb * B, k), dtype=torch.float32, device=X_c.device)
    lib = _kernels()
    with torch.cuda.device(X_c.device):
        err = lib.fvgp_chunked_spmm(
            _ptr(tiles), _ptr(X_c), _ptr(row_ptr), _ptr(cols), _ptr(out),
            nb, B, k, _KERNEL_DTYPES[tiles.dtype], _stream(X_c))
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
    def forward(ctx, rows, cols, tiles, X, nb, B, mv_dtype):
        work = mv_dtype if mv_dtype is not None else X.dtype
        out = _launch_chunked_spmm(rows, cols, tiles.to(work), X.to(work),
                                   nb, B)
        ctx.save_for_backward(rows, cols, tiles, X)
        ctx.nb, ctx.B, ctx.mv_dtype = nb, B, mv_dtype
        return out.to(X.dtype)

    @staticmethod
    def backward(ctx, ybar):
        rows, cols, tiles, X = ctx.saved_tensors
        tiles_bar, X_bar = chunked_spmm_vjp(
            rows, cols, tiles, X, ybar, ctx.nb, ctx.B, ctx.mv_dtype,
            need_x=ctx.needs_input_grad[3])
        return None, None, tiles_bar, X_bar, None, None, None


def chunked_spmm(rows, cols, tiles, X, nb, B, mv_dtype=None):
    """``Y = A @ X`` over a row-sorted tile list (same contract as the plain
    version).  Sentinel rows (== nb) are skipped — they fall past the last
    CSR offset — so bucket padding costs nothing when passed unclamped;
    clamped sentinels must carry zero tiles and all land on the last row
    block's thread block.  CPU tensors and float64 work take the plain
    version; float32/bfloat16 CUDA tensors launch the K1 kernel."""
    work = mv_dtype if mv_dtype is not None else X.dtype
    if X.device.type == "cpu" or work == torch.float64:
        return chunked_spmm_reference(rows, cols, tiles, X, nb, B, mv_dtype)
    return _ChunkedSpmmKernel.apply(rows, cols, tiles, X, nb, B, mv_dtype)


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
    tiles = tiles.contiguous()
    Xb = Xb.contiguous()
    cols = cols.to(torch.int32).contiguous()
    out = torch.empty((n_chunks, B, c), dtype=torch.float32, device=Xb.device)
    lib = _kernels()
    with torch.cuda.device(Xb.device):
        err = lib.fvgp_row_chunk_sums(
            _ptr(tiles), _ptr(Xb), _ptr(cols), _ptr(out), n_chunks, C, nb, B,
            c, _KERNEL_DTYPES[tiles.dtype], _stream(Xb))
    if err != 0:
        raise RuntimeError(f"row_chunk_sums: kernel launch failed with CUDA "
                           f"error {err}")
    row_chunk_sums.launches += 1
    return out


row_chunk_sums.launches = 0
