"""Block-sparse covariance assembly — the gp2Scale engine (counterpart of
``fvgp_tpu/parallel/sharded_cov.py``).

1. *Structure* (host, numpy): points are tiled into blocks of ``block_size``
   consecutive indices; candidate tile pairs are pruned by bounding-box
   distance in whitened coordinates, then the exact zero-tile filter drops
   the pairs with no point pair inside the support.
2. *Tiles* (device, batched): one batched kernel evaluation computes a chunk
   of tiles at a time.  For the symmetric prior covariance only the upper
   triangle is scheduled; the mirror is a device transpose.
3. *Layout*: every tile's final position is computed on the host first —
   the list sorted by (row block, column block), sentinels at the tail —
   and chunks and mirrors are written straight to their destinations, so
   the stored matrix is row-sorted as the K1 kernel needs it and no second
   copy of the tile buffer is ever made.

A kernel that does not run on tensors takes the same path with the tile
loop on the host.  Non-Euclidean inputs (lists of arbitrary objects) have a
host kernel by construction and no geometry: every tile pair is scheduled
(the upper triangle when symmetric), the host tile loop hands the kernel
slices of the lists, and the exact zero-tile filter drops the dead tiles.

On a mesh of more than one rank the stored (symmetric) K is row-owned, as
the JAX package lays it out: every rank runs the same deterministic host
structure pass on the replicated points, so all derive one schedule, and
rank r then computes only the tiles of its row blocks ``[r0, r0 + W)``
(``mesh.owned_rows``) — a scheduled upper tile ``(i, j)`` whose row it
owns, and the mirror ``(j, i)`` of one whose column it owns, computed as
``(i, j)`` and transposed on the device.  Only pairs that straddle a
range boundary are computed twice (once on each side); no tile crosses
ranks, and a rank's peak is its tile set plus one chunk.  Each rank's list
is row-sorted and bucket-padded to ``_bucket`` of the largest rank's count,
so the global padded count is the JAX package's ``tiles.shape[0]``.
"""

import warnings

import numpy as np
import torch

from .. import config
from ..kernels import wendland_anisotropic
from .block_sparse import BlockSparseMatrix
from .mesh import owned_rows, rank_values

warnings.filterwarnings("once", category=UserWarning,
                        module=r"fvgp_tpu_torch(\..*)?")


def _candidate_pairs(x1, x2, lengthscales, radius, block_size, symmetric):
    """Tile pairs whose whitened bounding boxes are within the support
    radius (upper triangle when ``symmetric``).  Bounds and the symmetric
    prune come from the native runtime (numpy fallback inside it)."""
    from ..native import block_bounds, candidate_pairs
    if lengthscales is not None:
        x1 = x1 / lengthscales
        x2 = x2 if x2 is None else x2 / lengthscales
    if symmetric and np.isfinite(radius):
        lo1, hi1 = block_bounds(x1, block_size)
        return candidate_pairs(lo1, hi1, radius)
    lo1, hi1 = block_bounds(x1, block_size)
    if symmetric:
        lo2, hi2 = lo1, hi1
    else:
        lo2, hi2 = block_bounds(x2, block_size)
    # box-to-box gap per dimension: max(lo2-hi1, lo1-hi2, 0)
    gap = np.maximum(lo2[None, :, :] - hi1[:, None, :],
                     lo1[:, None, :] - hi2[None, :, :])
    gap = np.maximum(gap, 0.0)
    dist2 = np.sum(gap ** 2, axis=-1)
    keep = dist2 <= radius ** 2
    if symmetric:
        keep = np.triu(keep)            # upper triangle only
    rows, cols = np.nonzero(keep)
    return rows.astype(np.int32), cols.astype(np.int32)


def _bucket(n, multiple=64):
    """Round a tile count up so repeated shapes recur across occupancy
    changes: next multiple of max(64, n/8)."""
    if n <= multiple:
        return multiple
    step = max(multiple, 1 << (int(n - 1).bit_length() - 3))
    return -(-n // step) * step


def support_geometry(prior, hyperparameters, args):
    """(lengthscales, radius) for the bounding-box prune, or (None, inf).

    The Wendland kernel implies radius 1 in coordinates whitened by
    hps[1:].  User kernels declare their support via
    ``args['gp2Scale_lengthscales']`` (callable hps -> per-dim scales) and
    ``args['gp2Scale_support_radius']`` (whitened radius, default 1.0).
    Without a declaration every tile is computed, with a one-time warning.
    """
    hps = np.asarray(hyperparameters, dtype=np.float64)
    ls_fn = args.get("gp2Scale_lengthscales", None)
    if callable(ls_fn):
        return (np.asarray(ls_fn(hps)),
                float(args.get("gp2Scale_support_radius", 1.0)))
    if getattr(prior, "kernel", None) is wendland_anisotropic:
        return hps[1:], 1.0
    warnings.warn(
        "gp2Scale: the kernel's support is unknown, so no tile pruning is "
        "possible and every covariance tile will be computed. Declare the "
        "support via args['gp2Scale_lengthscales'] (callable hps -> scales) "
        "and args['gp2Scale_support_radius'] to enable sparsity.")
    return None, np.inf


def _stable_kernel_closure(prior):
    """The prior's kernel as a 3-argument callable ``k(x1, x2, hps)``;
    4-argument kernels close over the prior's CURRENT args dict, rebuilt
    when ``set_args`` rebinds it."""
    if prior.k_n_params != 4:
        return prior.kernel
    cached = getattr(prior, "_gp2_kernel_closure", None)
    a_dict = prior.args
    if cached is not None and cached[0] is a_dict:
        return cached[1]
    kernel = prior.kernel

    def kern_fn(a, b, h):
        return kernel(a, b, h, a_dict)

    prior._gp2_kernel_closure = (a_dict, kern_fn)
    return kern_fn


# ---------------------------------------------------------------------------
# tile evaluation (device)
# ---------------------------------------------------------------------------

def _compute_tiles(kernel_fn, x1b, x2b, mask1, mask2, rows, cols, hps):
    """Batched tile evaluation: tiles[t] = k(x1 block rows[t], x2 block
    cols[t]) with padded points masked to zero."""
    K = kernel_fn(x1b[rows], x2b[cols], hps)
    return K * (mask1[rows][:, :, None] * mask2[cols][:, None, :])


def _tile_live(kernel_fn, x1b, x2b, mask1, mask2, rows, cols, hps):
    """Per-tile liveness (max|k| > 0) without retaining the tiles — the
    zero-tile filter's first pass for rectangular blocks."""
    K = _compute_tiles(kernel_fn, x1b, x2b, mask1, mask2, rows, cols, hps)
    return torch.amax(K.abs(), dim=(1, 2)) > 0


def _blocks_device(x, block_size, dtype, device):
    """(points (nb, B, d), validity mask (nb, B)) padded to full blocks."""
    n, d = np.asarray(x).shape
    nb = -(-n // block_size)
    n_pad = nb * block_size
    xp = np.zeros((n_pad, d))
    xp[:n] = x
    mask = np.zeros((n_pad,))
    mask[:n] = 1.0
    xb = torch.as_tensor(xp.reshape(nb, block_size, d), dtype=dtype)
    mb = torch.as_tensor(mask.reshape(nb, block_size), dtype=dtype)
    return xb.to(device), mb.to(device)


def _row_sorted_layout(rows, cols, symmetric, nb1, nb2, mesh=None,
                       counts=None):
    """This rank's final tile list of a scheduled (upper-triangle)
    structure: ``(rows_final, cols_final, dest, off_idx, total)``.  The
    scheduled tiles and, for a symmetric matrix, the mirrors of its
    off-diagonal ones are sorted by (row block, column block) and
    bucket-padded with sentinels; ``dest[i]`` is the final position of
    scheduled tile ``i`` (``i < len(rows)``) or of the mirror of
    ``off_idx[i - len(rows)]``, -1 where another rank owns that row block;
    ``total`` is this rank's live count.  Without a mesh the rank owns every
    row.  Under one each rank's list is padded to ``_bucket`` of the
    largest count: ``counts`` (one per rank) where the ranks know only
    their own tiles, else counted from this schedule, which every rank
    holds whole."""
    off_idx = np.nonzero(rows < cols)[0] if symmetric \
        else np.empty(0, dtype=np.int64)
    rows_all = np.concatenate([rows, cols[off_idx]]).astype(np.int32)
    cols_all = np.concatenate([cols, rows[off_idx]]).astype(np.int32)
    r0, W = owned_rows(nb1, mesh)
    mine = np.nonzero((rows_all >= r0) & (rows_all < r0 + W))[0]
    if counts is None:
        counts = np.bincount(rows_all // W, minlength=1)
    total = len(mine)
    order = mine[np.lexsort((cols_all[mine], rows_all[mine]))]
    dest = np.full(len(rows_all), -1, np.int64)
    dest[order] = np.arange(total)
    padded = _bucket(max(int(np.max(counts)), 1))
    rows_final = np.full(padded, nb1, np.int32)
    cols_final = np.full(padded, nb2, np.int32)
    rows_final[:total] = rows_all[order]
    cols_final[:total] = cols_all[order]
    return rows_final, cols_final, dest, off_idx, total


def _needed_tiles(dest, off_idx, n_sched):
    """(scheduled tiles this rank computes, their destinations, their
    mirrors' destinations): a tile is computed where the rank owns its row
    or, for an off-diagonal one, its mirror's row (-1 marks a write the
    rank does not make)."""
    d_main = dest[:n_sched]
    d_mirror = np.full(n_sched, -1, np.int64)
    d_mirror[off_idx] = dest[n_sched:]
    need = np.nonzero((d_main >= 0) | (d_mirror >= 0))[0]
    return need, d_main[need], d_mirror[need]


def distributed_covariance(prior, x1, x2, hyperparameters, *,
                           batch_size=10000, symmetric=False, args=None,
                           mesh=None):
    """Assemble k(x1, x2) as a BlockSparseMatrix on the prior's device.

    One device engine serves every ``gp2Scale_distribution`` that the
    facade accepts, so the schedule's name does not reach this function.
    ``mesh`` (a ``parallel.mesh.Mesh`` of more than one rank, for the
    symmetric K only): the row-owned layout of the module docstring, every
    rank calling together; one rank is the meshless matrix."""
    if mesh is not None and mesh.size == 1:
        mesh = None
    if mesh is not None and not symmetric:
        raise ValueError("distributed_covariance: only the symmetric K is "
                         "row-owned on a mesh; a cross covariance is whole "
                         "on every rank (mesh=None)")
    args = args or {}
    non_euclidean = isinstance(x1, list) or isinstance(x2, list)
    if non_euclidean:
        # arbitrary-object points: the lists reach the host kernel as they
        # are (slices of them), never through numpy
        x2 = x1 if symmetric else x2
    else:
        x1 = np.asarray(x1, dtype=np.float64)
        x2 = x1 if symmetric else np.asarray(x2, dtype=np.float64)
    block_size = int(args.get("gp2Scale_block_size",
                              min(int(batch_size), 256)))
    device = prior.device
    dtype = config.linalg_dtype(args, device)
    # storage dtype (e.g. "bfloat16"): halves the tile memory at assembly
    # time.  Opt-in; meant for the stochastic MCMC training regime
    storage_dtype = config.as_torch_dtype(
        args.get("gp2Scale_storage_dtype", None)) or dtype

    nb1 = -(-len(x1) // block_size)
    nb2 = -(-len(x2) // block_size)
    if non_euclidean:
        # no geometric prune for opaque objects: every tile pair
        ii, jj = np.meshgrid(np.arange(nb1), np.arange(nb2), indexing="ij")
        keep = ii <= jj if symmetric else np.ones_like(ii, dtype=bool)
        rows, cols = ii[keep].astype(np.int32), jj[keep].astype(np.int32)
        radius = np.inf
    else:
        lengthscales, radius = support_geometry(prior, hyperparameters,
                                                args)
        rows, cols = _candidate_pairs(x1, None if symmetric else x2,
                                      lengthscales, radius, block_size,
                                      symmetric)
    # the box prune is loose (boxes overlap even when no point pair is
    # inside the support): the exact-zero tiles are dropped BEFORE they are
    # retained, so they never occupy device memory
    do_filter = (bool(args.get("gp2Scale_tile_filter", True))
                 and np.isfinite(radius))
    chunk = max(1, int(args.get("gp2Scale_tile_chunk", 512)))

    if non_euclidean or not prior.kernel_traceable:
        return _host_kernel_covariance(prior, x1, x2, hyperparameters, rows,
                                       cols, symmetric, block_size,
                                       storage_dtype, device, args, mesh)

    x1b, m1 = _blocks_device(x1, block_size, dtype, device)
    x2b, m2 = (x1b, m1) if symmetric \
        else _blocks_device(x2, block_size, dtype, device)
    hps = torch.as_tensor(np.asarray(hyperparameters, np.float64),
                          dtype=dtype).to(device)
    kern_fn = _stable_kernel_closure(prior)
    with torch.no_grad():
        if do_filter and len(rows):
            # pass 1: per-tile liveness only.  Symmetric priors use the
            # exact geometric test of the native host runtime (a tile is
            # live iff some point pair sits inside the support radius);
            # rectangular blocks take a device pass
            if symmetric and lengthscales is not None:
                from ..native import tile_live
                keep = tile_live(x1 / lengthscales, rows, cols, block_size,
                                 radius)
            else:
                r_d = torch.as_tensor(rows).to(device).long()
                c_d = torch.as_tensor(cols).to(device).long()
                keep = torch.cat([
                    _tile_live(kern_fn, x1b, x2b, m1, m2, r_d[s:s + chunk],
                               c_d[s:s + chunk], hps)
                    for s in range(0, len(rows), chunk)]).cpu().numpy()
            rows, cols = rows[keep], cols[keep]

        # pass 2 (or the only pass): the rank's tiles in chunks, each tile
        # and its mirror written STRAIGHT to their final positions in the
        # bucket-padded buffer, whose padding stays exactly zero (the
        # fingerprint reads it)
        rows_final, cols_final, dest, off_idx, total = _row_sorted_layout(
            rows, cols, symmetric, nb1, nb2, mesh)
        need, d_main, d_mirror = _needed_tiles(dest, off_idx, len(rows))
        buf = torch.zeros((len(rows_final), block_size, block_size),
                          dtype=storage_dtype, device=device)
        r_d = torch.as_tensor(rows[need]).to(device).long()
        c_d = torch.as_tensor(cols[need]).to(device).long()
        for s in range(0, len(need), chunk):
            e = min(s + chunk, len(need))
            part = _compute_tiles(kern_fn, x1b, x2b, m1, m2, r_d[s:e],
                                  c_d[s:e], hps).to(storage_dtype)
            for d, tiles in ((d_main[s:e], part),
                             (d_mirror[s:e], part.transpose(1, 2))):
                w = np.nonzero(d >= 0)[0]
                if len(w) == e - s:
                    buf[torch.as_tensor(d).to(device)] = tiles
                elif len(w):
                    buf[torch.as_tensor(d[w]).to(device)] = \
                        tiles[torch.as_tensor(w).to(device)]
    result = BlockSparseMatrix(len(x1), len(x2), block_size, rows_final,
                               cols_final, buf, live_tiles=total, mesh=mesh)
    _log_assembly(result, total, nb1, nb2)
    return result


def _host_kernel_covariance(prior, x1, x2, hyperparameters, rows, cols,
                            symmetric, block_size, storage_dtype, device,
                            args, mesh=None):
    """The tile loop on the host, for a kernel that does not run on tensors
    (any numpy callable, and every kernel of a non-Euclidean input space,
    which takes slices of the point lists): tiles one by one, the exact
    zero-tile filter as one host reduction, mirror and padding in numpy, one
    transfer.  Under a mesh a rank evaluates only the tiles it stores (its
    rows, and the mirrors of its columns); liveness is then known for those
    alone, so the ranks' live counts, which set the common padding, take
    one all-gather."""
    from scipy.sparse import issparse
    nb1 = -(-len(x1) // block_size)
    nb2 = -(-len(x2) // block_size)
    if mesh is not None:
        # the tiles this rank needs, on the unfiltered schedule
        _, _, dest, off_idx, _ = _row_sorted_layout(rows, cols, symmetric,
                                                    nb1, nb2, mesh)
        need = _needed_tiles(dest, off_idx, len(rows))[0]
        rows, cols = rows[need], cols[need]
    tiles = np.zeros((len(rows), block_size, block_size))
    hps = np.asarray(hyperparameters)
    for t in range(len(rows)):
        i, j = int(rows[t]), int(cols[t])
        blk = prior._apply_kernel(x1[i * block_size:(i + 1) * block_size],
                                  x2[j * block_size:(j + 1) * block_size],
                                  hps)
        blk = blk.toarray() if issparse(blk) else np.asarray(blk)
        tiles[t, :blk.shape[0], :blk.shape[1]] = blk
    if bool(args.get("gp2Scale_tile_filter", True)) and len(rows):
        keep = np.abs(tiles).max(axis=(1, 2)) > 0
        rows, cols, tiles = rows[keep], cols[keep], tiles[keep]
    counts = None
    if mesh is not None:
        r0, W = owned_rows(nb1, mesh)
        off = rows < cols
        mine = np.sum((rows >= r0) & (rows < r0 + W)) \
            + np.sum(off & (cols >= r0) & (cols < r0 + W))
        counts = rank_values(mine, mesh)[:, 0]
    rows_final, cols_final, dest, off_idx, total = _row_sorted_layout(
        rows, cols, symmetric, nb1, nb2, mesh, counts)
    need, d_main, d_mirror = _needed_tiles(dest, off_idx, len(rows))
    buf = np.zeros((len(rows_final), block_size, block_size))
    w = d_main >= 0
    buf[d_main[w]] = tiles[need[w]]
    w = d_mirror >= 0
    buf[d_mirror[w]] = np.swapaxes(tiles[need[w]], 1, 2)
    result = BlockSparseMatrix(
        len(x1), len(x2), block_size, rows_final, cols_final,
        torch.as_tensor(buf).to(device=device, dtype=storage_dtype),
        live_tiles=total, mesh=mesh)
    _log_assembly(result, total, nb1, nb2)
    return result


def _log_assembly(result, total, nb1, nb2):
    from ..utils.logging import logger
    mesh = result.mesh
    logger.debug("covariance assembled: %d/%d tiles scheduled, block %d, "
                 "fill %.4f, %s", total, nb1 * nb2, result.block_size,
                 result.sparsity(), "single-device" if mesh is None else
                 f"rank {mesh.rank} of {mesh.size}, row-owned")
