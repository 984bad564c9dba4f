"""Block-sparse (tile) covariance matrices for the stored gp2Scale path
(counterpart of ``fvgp_tpu/parallel/block_sparse.py``).

The covariance is a set of dense B×B tiles on a fixed block grid: tile ``t``
is the block (``rows[t]``, ``cols[t]``); entries with ``rows[t] == nb`` are
bucket-padding sentinels and carry zero tiles.  Both triangles of a
symmetric matrix are stored.  Duplicate (row, col) entries — ``merge``
produces them — represent their sum: every consumer adds them up.

The square product ``A @ X`` is the second caller of the K1 kernel
(``ops.hopper_kernels.chunked_spmm``): on the card, float32 and bfloat16
tiles launch it; the gather → batched matmul → ``index_add_`` formulation
below is its plain version, which the CPU and float64 take.  K1 owns whole
row blocks, so it needs a ROW-SORTED tile list.  The assembler
(``parallel/sharded_cov.distributed_covariance``) writes its tiles in row
order; ``merge`` and ``stack_augmented_covariance`` concatenate, and such a
matrix is sorted once, at its first product on the card (a gather of the
tile array: one transient copy of it).  Rectangular products and ``rmatmat``
stay plain PyTorch, as they are plain XLA in the JAX package.

Under bfloat16 tile storage the kernel multiplies bfloat16 tiles by a
float32 ``X`` split into two bfloat16 halves (``X = hi + lo``, one launch on
``[hi | lo]``, the two results added in float32): the product then carries
the tiles' rounding only, as the JAX package's float32-product einsum does.
"""

import numpy as np
import torch

from ..config import as_torch_dtype, resolve_device

__all__ = ["BlockSparseMatrix", "is_block_sparse",
           "stack_augmented_covariance", "from_scipy", "merge"]

# per-pass bytes allowed for the (T, B, c) rectangular-product temporary
_MATMAT_BUDGET = 2 << 30
# tiles per pass of the plain products and of the Frobenius sum
_TILE_SLICE = 16384
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def is_block_sparse(obj):
    return isinstance(obj, BlockSparseMatrix)


def _dense_dtype(dtype):
    """The dtype of dense materializations: sub-float32 storage is a tile
    FORMAT, what feeds torch.linalg is upcast to float32."""
    return torch.float32 if torch.finfo(dtype).bits < 32 else dtype


def _index_tensor(a, device):
    if torch.is_tensor(a):
        return a.to(device=device, dtype=torch.int32)
    return torch.as_tensor(np.asarray(a).astype(np.int32)).to(device)


def _segment_sum_sorted(values, seg, num_segments):
    """``out[s] = Σ_{seg[i]=s} values[i]`` with one fixed order of addition:
    the i-th occurrence of every segment is added in the i-th pass, each pass
    an ``index_add_`` over distinct segments.  ``seg`` is a host array; the
    passes are as many as the largest multiplicity (1 without duplicates), so
    the result does not vary from run to run as one atomic ``index_add_``
    over repeated indices would."""
    out = torch.zeros((num_segments,) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    seg = np.asarray(seg, np.int64)
    if len(seg) == 0:
        return out
    order = np.argsort(seg, kind="stable")
    s_sorted = seg[order]
    first = np.searchsorted(s_sorted, s_sorted, side="left")
    rank = np.arange(len(seg)) - first
    for level in range(int(rank.max()) + 1):
        pick = order[rank == level]
        out.index_add_(0, torch.as_tensor(seg[pick]).to(values.device),
                       values[torch.as_tensor(pick).to(values.device)])
    return out


class _TileStore:
    """The (rows, cols, tiles) triple of a matrix and its host index copies,
    shared by every view of the matrix (``add_diagonal``), so that the
    one-time row sort serves all of them."""

    def __init__(self, rows, cols, tiles, nb, live_tiles=None):
        self.rows = rows
        self.cols = cols
        self.tiles = tiles
        self.nb = nb
        self._rows_h = None
        self._cols_h = None
        self._cols_clamped = None
        self._row_sorted = None
        self._live = None if live_tiles is None else int(live_tiles)

    @property
    def rows_h(self):
        if self._rows_h is None:
            self._rows_h = self.rows.cpu().numpy()
        return self._rows_h

    @property
    def cols_h(self):
        if self._cols_h is None:
            self._cols_h = self.cols.cpu().numpy()
        return self._cols_h

    @property
    def live(self):
        if self._live is None:
            self._live = int(np.sum(self.rows_h < self.nb))
        return self._live

    def kernel_operands(self):
        """(rows, clamped cols, tiles) row-sorted for K1: sorted here, once,
        where the list is not (the tile gather is one transient copy of the
        tile array).  The rows tensor then stays the same object, so the
        kernel wrapper's row offsets are computed once per matrix."""
        if self._row_sorted is None:
            r = self.rows_h
            self._row_sorted = bool(np.all(r[1:] >= r[:-1]))
        if not self._row_sorted:
            order = np.argsort(self.rows_h, kind="stable")
            perm = torch.as_tensor(order).to(self.tiles.device)
            self._rows_h, self._cols_h = self.rows_h[order], self.cols_h[order]
            self.tiles = self.tiles[perm]
            self.rows = self.rows[perm]
            self.cols = self.cols[perm]
            self._cols_clamped = None
            self._row_sorted = True
        if not self.tiles.is_contiguous():          # a transposed view
            self.tiles = self.tiles.contiguous()
        if self._cols_clamped is None:
            self._cols_clamped = self.cols.clamp(max=self.nb - 1)
        return self.rows, self._cols_clamped, self.tiles


def _pad_rows(X, rows):
    if X.shape[0] == rows:
        return X
    Xp = torch.zeros((rows, X.shape[1]), dtype=X.dtype, device=X.device)
    Xp[:X.shape[0]] = X
    return Xp


def _plain_product(tiles, gather, scatter, X, n_gather_blocks,
                   n_scatter_blocks, B, transpose=False):
    """``out[scatter[t]] += tiles[t](ᵀ) @ X[gather[t]]`` in X's dtype, tile
    slices streamed through the (n_scatter_blocks, B, k) accumulator; gather
    indices are clamped (sentinels carry zero tiles), scatter indices past
    the grid are dropped."""
    k = X.shape[1]
    Xb = _pad_rows(X, n_gather_blocks * B).reshape(n_gather_blocks, B, k)
    g = gather.long().clamp(max=n_gather_blocks - 1)
    s = scatter.long().clamp(max=n_scatter_blocks)
    acc = torch.zeros((n_scatter_blocks + 1, B, k), dtype=X.dtype,
                      device=X.device)
    for t0 in range(0, tiles.shape[0], _TILE_SLICE):
        sl = slice(t0, t0 + _TILE_SLICE)
        t = tiles[sl].to(X.dtype)
        if transpose:
            t = t.transpose(1, 2)
        acc.index_add_(0, s[sl], torch.bmm(t, Xb[g[sl]]))
    return acc[:n_scatter_blocks].reshape(n_scatter_blocks * B, k)


def _bsm_matmat_plain(rows, cols, tiles, X, nb, block_size):
    """The plain version of the square product (the JAX ``_bsm_matmat``
    without its Pallas branch): gather, batched matmul, segment sum."""
    out = _plain_product(tiles, cols, rows, X, nb, nb, block_size)
    return out[:X.shape[0]]


def _takes_kernel(store, dtype):
    """Whether the square product of ``store`` with an X of ``dtype`` (on
    the tiles' device) launches the K1 kernel."""
    return (store.tiles.device.type != "cpu" and dtype != torch.float64
            and store.tiles.dtype in _KERNEL_DTYPES)


def _bsm_matmat(store, X, nb, block_size):
    """(n, k) = Σ over tiles of tile @ X[col block], added into its row
    block.  Float32 and bfloat16 tiles on the card launch the K1 kernel
    over the row-sorted list; the CPU and float64 take the plain version."""
    if X.device.type == "cpu" or not _takes_kernel(store, X.dtype):
        return _bsm_matmat_plain(store.rows, store.cols, store.tiles, X, nb,
                                 block_size)
    from ..ops.hopper_kernels import chunked_spmm
    rows, cols_c, tiles = store.kernel_operands()
    k = X.shape[1]
    Xp = _pad_rows(X.float(), nb * block_size)
    if tiles.dtype == torch.float32:
        out = chunked_spmm(rows, cols_c, tiles, Xp, nb, block_size)
    else:
        hi = Xp.to(torch.bfloat16).float()
        out = chunked_spmm(rows, cols_c, tiles, torch.cat([hi, Xp - hi], 1),
                           nb, block_size, mv_dtype=torch.bfloat16)
        out = out[:, :k] + out[:, k:]
    return out[:X.shape[0]].to(X.dtype)


def bsm_matvec_factory(nb, block_size, n, with_diag):
    """The matvec of an (nb, block_size) operator over n rows for the
    solvers' operator convention: ``mv(A, X)`` with the matrix as the
    operator data (its extra diagonal applied when ``with_diag``)."""
    def mv(A, X):
        out = _bsm_matmat(A._store, X, nb, block_size)[:n]
        if with_diag:
            out = out + A.diag.to(X.dtype)[:, None] * X
        return out

    return mv


def _bsm_diagonal(store, nb, block_size, n):
    """diag(A) for tile storage.  The diagonal-block tiles are selected by
    host index before anything touches the tile array."""
    r = store.rows_h
    sel = np.nonzero((r == store.cols_h) & (r < nb))[0]
    picked = store.tiles[torch.as_tensor(sel).to(store.tiles.device)]
    tile_diags = torch.diagonal(picked, dim1=1, dim2=2)
    tile_diags = tile_diags.to(_dense_dtype(tile_diags.dtype))
    out = _segment_sum_sorted(tile_diags, r[sel], nb)
    return out.reshape(nb * block_size)[:n]


class BlockSparseMatrix:
    """Symmetric or rectangular block-sparse matrix stored as dense tiles on
    a block grid.

    ``rows``/``cols`` are arrays or tensors of block indices, ``tiles`` a
    (T, B, B) array or tensor.  ``device``: the tiles' device when they are
    a tensor, else the card (``"cuda"``), or ``"cpu"`` where asked for.
    ``diag`` is an optional extra diagonal stored beside the tiles, in its
    own precision."""

    def __init__(self, n, n_cols, block_size, rows, cols, tiles, diag=None,
                 live_tiles=None, device=None):
        self.n = int(n)
        self.n_cols = int(n_cols)
        self.block_size = int(block_size)
        self.nb = -(-self.n // self.block_size)
        self.nb_cols = -(-self.n_cols // self.block_size)
        if torch.is_tensor(tiles) and device is None:
            dev = tiles.device
        else:
            dev = resolve_device("cuda" if device is None else device)
        if not torch.is_tensor(tiles):
            tiles = torch.as_tensor(np.asarray(tiles))
        store = _TileStore(_index_tensor(rows, dev), _index_tensor(cols, dev),
                           tiles.to(dev), self.nb, live_tiles)
        if not torch.is_tensor(rows):
            store._rows_h = np.asarray(rows).astype(np.int32)
        if not torch.is_tensor(cols):
            store._cols_h = np.asarray(cols).astype(np.int32)
        self._store = store
        # the extra diagonal is stored SEPARATELY from the tiles: K+V shares
        # K's tile buffer instead of copying it, and the noise keeps full
        # precision under reduced-precision tile storage
        if diag is not None and not torch.is_tensor(diag):
            diag = torch.tensor(np.asarray(diag))
        self.diag = None if diag is None else diag.to(dev)

    @classmethod
    def _view(cls, base, diag):
        """``base``'s tiles with another extra diagonal (shared storage)."""
        out = cls.__new__(cls)
        out.n, out.n_cols, out.block_size = base.n, base.n_cols, \
            base.block_size
        out.nb, out.nb_cols = base.nb, base.nb_cols
        out._store = base._store
        out.diag = diag
        return out

    # -- basic facts -----------------------------------------------------
    @property
    def rows(self):
        return self._store.rows

    @property
    def cols(self):
        return self._store.cols

    @property
    def tiles(self):
        return self._store.tiles

    @property
    def device(self):
        return self._store.tiles.device

    @property
    def shape(self):
        return (self.n, self.n_cols)

    @property
    def nnz(self):
        """Stored values over LIVE tiles (bucket-padding sentinels do not
        count): the sparsity that the auto mode thresholds on."""
        return self._store.live * self.block_size * self.block_size

    @property
    def dtype(self):
        return self.tiles.dtype

    def sparsity(self):
        return self.nnz / float(max(self.n * self.n_cols, 1))

    # -- linear operator ---------------------------------------------------
    def _operand(self, X):
        """(X as a 2-d tensor on the matrix's device, squeeze)."""
        X = torch.as_tensor(X).to(self.device)
        if not X.is_floating_point():
            X = X.to(_dense_dtype(self.dtype))
        return (X[:, None], True) if X.dim() == 1 else (X, False)

    def matmat(self, X):
        X, squeeze = self._operand(X)
        if self.n != self.n_cols:
            out = self._rect_matmat(X)
        else:
            kc = self.square_col_chunk(X.shape[1], X.dtype)
            parts = [_bsm_matmat(self._store, X[:, s:s + kc], self.nb,
                                 self.block_size)
                     for s in range(0, X.shape[1], kc)]
            out = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
            if self.diag is not None:
                out = out + self.diag.to(X.dtype)[:, None] * X
        return out[:, 0] if squeeze else out

    __matmul__ = matmat

    def _col_chunk(self, k, itemsize=4):
        """Columns per pass so the two live (T, B, c) per-tile buffers of
        the plain product (the gathered X and the product) together stay
        under ``_MATMAT_BUDGET``.  ``itemsize`` is the RHS element size."""
        per_col = (2 * int(self.tiles.shape[0]) * int(self.block_size)
                   * int(itemsize))
        return max(1, min(int(k), _MATMAT_BUDGET // max(per_col, 1)))

    def square_col_chunk(self, k, dtype):
        """Columns per pass of the square product with an X of ``dtype``.
        The K1 kernel has no per-tile temporaries and every launch streams
        the whole tile set, so its passes are as wide as the (n, c) arrays
        around it allow: eight of them (X, its two bfloat16 halves, the
        product, a Krylov solver's work arrays) stay under
        ``_MATMAT_BUDGET``.  The plain product keeps the bound of
        ``_col_chunk`` (host-driven callers may pass hundreds of columns)."""
        itemsize = torch.finfo(dtype).bits // 8
        if _takes_kernel(self._store, dtype):
            per_col = 8 * max(self.n, 1) * itemsize
            return max(1, min(int(k), _MATMAT_BUDGET // per_col))
        return self._col_chunk(k, itemsize)

    def _rect_matmat(self, X):
        k = X.shape[1]
        kc = self._col_chunk(k, X.element_size())
        if kc < k:
            return torch.cat([self._rect_matmat(X[:, s:s + kc])
                              for s in range(0, k, kc)], dim=1)
        s = self._store
        return _plain_product(s.tiles, s.cols, s.rows, X, self.nb_cols,
                              self.nb, self.block_size)[:self.n]

    def rmatmat(self, X):
        """Xᵀ-side product: (n_cols, k) = Aᵀ @ X for rectangular A."""
        X, squeeze = self._operand(X)
        k = X.shape[1]
        kc = self._col_chunk(k, X.element_size())
        if kc < k:
            out = torch.cat([self.rmatmat(X[:, s:s + kc])
                             for s in range(0, k, kc)], dim=1)
            return out[:, 0] if squeeze else out
        s = self._store
        out = _plain_product(s.tiles, s.rows, s.cols, X, self.nb,
                             self.nb_cols, self.block_size,
                             transpose=True)[:self.n_cols]
        if self.diag is not None:
            out = out + self.diag.to(X.dtype)[:, None] * X
        return out[:, 0] if squeeze else out

    @property
    def T(self):
        """Transposed view (swaps the block grid; the tiles are a transposed
        view of this matrix's)."""
        s = self._store
        t = BlockSparseMatrix(self.n_cols, self.n, self.block_size, s.cols,
                              s.rows, s.tiles.transpose(1, 2), diag=self.diag,
                              live_tiles=s._live)
        t._store._rows_h, t._store._cols_h = s.cols_h, s.rows_h
        return t

    # -- diagonal ops --------------------------------------------------
    def diagonal(self):
        d = _bsm_diagonal(self._store, self.nb, self.block_size, self.n)
        if self.diag is not None:
            d = d + self.diag
        return d

    def add_diagonal(self, v):
        """K + diag(v) as a VIEW sharing this matrix's tile buffer — no tile
        copy, and the diagonal keeps its own (full) precision under
        reduced-precision tile storage."""
        if self.n != self.n_cols:
            raise AssertionError("add_diagonal requires a square matrix")
        v = torch.as_tensor(v).to(self.device)
        if not v.is_floating_point():
            v = v.to(_dense_dtype(self.dtype))
        v = torch.broadcast_to(v, (self.n,))
        return BlockSparseMatrix._view(
            self, v if self.diag is None else self.diag + v)

    def trace_and_fro(self):
        """One pass over the stored tiles: (trace, Frobenius norm) as
        floats, for the drift fingerprint.  The extra diagonal is folded in
        exactly: ||K+D||_F² = ||K||_F² + 2<diag K, d> + ||d||².

        The sum of squares runs over tile slices, each converted, squared
        and reduced on its own, so a reduced-precision tile set is never
        materialized at full precision.  ``merge`` produces duplicate
        (row, col) tiles whose sum is the represented matrix:
        ||Σ_g t_g||² = Σ||t||² + 2 Σ_{i<j in g} <t_i, t_j>; the cross terms
        come from the (few) duplicate groups only.  Duplicates are looked
        for among the LIVE tiles: the sentinels all share one key and would
        form one giant fake group (they are zero and add nothing)."""
        s = self._store
        acc = _dense_dtype(s.tiles.dtype)
        base = _bsm_diagonal(s, self.nb, self.block_size, self.n)
        tr = float(torch.sum(base)) + (0.0 if self.diag is None
                                       else float(torch.sum(self.diag)))
        fro2 = 0.0
        for t0 in range(0, s.tiles.shape[0], _TILE_SLICE):
            fro2 += float(torch.sum(torch.square(
                s.tiles[t0:t0 + _TILE_SLICE].to(acc))))
        rows_h = s.rows_h
        live_m = rows_h < self.nb
        live_idx = np.nonzero(live_m)[0]
        key = rows_h[live_m].astype(np.int64) * self.nb_cols \
            + s.cols_h[live_m]
        uniq, inv, counts = np.unique(key, return_inverse=True,
                                      return_counts=True)
        if len(uniq) != len(key):
            for g in np.nonzero(counts > 1)[0]:
                idx = live_idx[np.nonzero(inv == g)[0]]
                tg = s.tiles[torch.as_tensor(idx).to(self.device)].to(acc)
                sg = torch.sum(tg, dim=0)
                fro2 += float(torch.sum(sg * sg) - torch.sum(tg * tg))
        if self.diag is not None:
            fro2 += 2.0 * float(torch.sum(base * self.diag)) \
                + float(torch.sum(self.diag * self.diag))
        return tr, float(np.sqrt(max(fro2, 0.0)))

    # -- conversions ---------------------------------------------------
    def _scatter_dense(self, sel, col0, n_col_blocks):
        """Dense (nb·B, n_col_blocks·B) sum of the tiles ``sel`` (None: all)
        placed at (row block, col block - col0); sentinels are dropped."""
        s = self._store
        B = self.block_size
        rows, cols, tiles = s.rows, s.cols, s.tiles
        if sel is not None:
            pick = torch.as_tensor(sel).to(self.device)
            rows, cols, tiles = rows[pick], cols[pick], tiles[pick]
        cb = cols.long() - col0
        flat = rows.long() * n_col_blocks + cb
        dead = (rows >= self.nb) | (cb < 0) | (cb >= n_col_blocks)
        flat = torch.where(dead, torch.full_like(flat,
                                                 self.nb * n_col_blocks),
                           flat)
        dense = torch.zeros((self.nb * n_col_blocks + 1, B, B),
                            dtype=_dense_dtype(tiles.dtype),
                            device=self.device)
        dense.index_add_(0, flat, tiles.to(dense.dtype))
        dense = dense[:-1].reshape(self.nb, n_col_blocks, B, B)
        return dense.permute(0, 2, 1, 3).reshape(self.nb * B,
                                                 n_col_blocks * B)

    def to_dense(self):
        dense = self._scatter_dense(None, 0, self.nb_cols)
        dense = dense[:self.n, :self.n_cols]
        if self.diag is not None:
            dense = dense.clone()
            torch.diagonal(dense).add_(self.diag.to(dense.dtype))
        return dense

    def toarray(self):
        return self.to_dense().cpu().numpy()

    def dense_columns(self, start, end):
        """Dense (n, end-start) slice of columns [start, end) without the
        full matrix: only the tiles whose column block overlaps the range
        are scattered."""
        B = self.block_size
        start, end = int(start), int(end)
        cb0 = start // B
        cb1 = (end - 1) // B + 1
        c = self._store.cols_h
        sel = np.nonzero((c >= cb0) & (c < cb1))[0]
        dense = self._scatter_dense(sel, cb0, cb1 - cb0)
        lo = start - cb0 * B
        dense = dense[:self.n, lo:lo + (end - start)]
        if self.diag is not None:
            dense = dense.clone()
            i = torch.arange(start, end, device=self.device)
            dense[i, i - start] += self.diag[start:end].to(dense.dtype)
        return dense

    def _selected_tiles(self, offset):
        """(nb, B, B) sums of the tiles on the ``offset``-th block diagonal
        (zero blocks where none is stored), selected by host index — never
        by a mask over the whole tile array."""
        s = self._store
        r, c = s.rows_h, s.cols_h
        sel = np.nonzero((r + offset == c) & (r < self.nb)
                         & (c < self.nb_cols))[0]
        picked = s.tiles[torch.as_tensor(sel).to(self.device)]
        return _segment_sum_sorted(picked.to(_dense_dtype(picked.dtype)),
                                   r[sel], self.nb)

    def diagonal_tiles(self):
        """(nb, B, B) stack of the diagonal tiles (the block-Jacobi input),
        with the extra diagonal added in."""
        out = self._selected_tiles(0)
        if self.diag is not None:
            out = out.to(torch.promote_types(out.dtype, self.diag.dtype))
            dp = torch.zeros(self.nb * self.block_size, dtype=out.dtype,
                             device=self.device)
            dp[:self.n] = self.diag
            torch.diagonal(out, dim1=1, dim2=2).add_(
                dp.reshape(self.nb, self.block_size))
        return out

    def off_diagonal_tiles(self, offset=1):
        """(nb, B, B) stack of the k-th block superdiagonal tiles
        (rows + offset == cols): the coupled windows of the
        overlapping-Schwarz preconditioner."""
        return self._selected_tiles(offset)

    def coarse_matrix(self):
        """(nb, nb) Galerkin coarse operator PᵀAP for the block-constant
        prolongation P: entry (i, j) is the sum of tile (i, j)'s entries —
        the two-level preconditioner's coarse solve."""
        s = self._store
        acc = _dense_dtype(s.tiles.dtype)
        sums = torch.cat([torch.sum(s.tiles[t0:t0 + _TILE_SLICE].to(acc),
                                    dim=(1, 2))
                          for t0 in range(0, s.tiles.shape[0], _TILE_SLICE)])
        live = (s.rows_h < self.nb) & (s.cols_h < self.nb_cols)
        idx = np.nonzero(live)[0]
        flat = s.rows_h[idx].astype(np.int64) * self.nb_cols + s.cols_h[idx]
        Ac = _segment_sum_sorted(sums[torch.as_tensor(idx).to(self.device)],
                                 flat, self.nb * self.nb_cols)
        Ac = Ac.reshape(self.nb, self.nb_cols)
        if self.diag is not None:
            Ac = Ac.to(torch.promote_types(Ac.dtype, self.diag.dtype))
            dp = torch.zeros(self.nb * self.block_size, dtype=Ac.dtype,
                             device=self.device)
            dp[:self.n] = self.diag
            torch.diagonal(Ac).add_(
                torch.sum(dp.reshape(self.nb, self.block_size), dim=1))
        return Ac

    # -- pickling (numpy; the JAX package's keys) ------------------------
    def __getstate__(self):
        s = self._store
        tiles = s.tiles
        state = dict(n=self.n, n_cols=self.n_cols,
                     block_size=self.block_size,
                     rows=np.array(s.rows_h), cols=np.array(s.cols_h),
                     tiles=tiles.to(_dense_dtype(tiles.dtype)).cpu().numpy(),
                     tiles_dtype=str(tiles.dtype).replace("torch.", ""),
                     diag=None if self.diag is None
                     else self.diag.cpu().numpy(),
                     device=str(self.device))
        return state

    def __setstate__(self, state):
        other = from_numpy_state(state, device=state.get("device"))
        self.__dict__.update(other.__dict__)


def from_numpy_state(state, device=None):
    """A matrix from the numpy dict that ``BlockSparseMatrix.__getstate__``
    gives — this package's or the JAX package's (keys ``n``, ``n_cols``,
    ``block_size``, ``rows``, ``cols``, ``tiles``, ``diag``), so both
    packages can be handed one stored operator.  ``device``: the card by
    default, ``"cpu"`` where asked for."""
    tiles = np.asarray(state["tiles"])
    tdt = state.get("tiles_dtype") or tiles.dtype.name
    if tiles.dtype.name == "bfloat16":       # a numpy extension dtype
        tiles = tiles.astype(np.float32)
    dev = resolve_device("cuda" if device is None else device)
    return BlockSparseMatrix(
        state["n"], state["n_cols"], state["block_size"],
        np.asarray(state["rows"]), np.asarray(state["cols"]),
        torch.tensor(tiles).to(as_torch_dtype(tdt)), diag=state.get("diag"),
        device=dev)


def from_scipy(sp_mat, block_size, device=None):
    """Tile-ify a scipy.sparse matrix onto the fixed block grid (float64
    tiles): grouped by (row block, col block) and scattered into dense B×B
    tiles on the host."""
    coo = sp_mat.tocoo()
    n, n_cols = coo.shape
    B = int(block_size)
    nb_cols = -(-n_cols // B)
    key = (coo.row // B).astype(np.int64) * nb_cols + coo.col // B
    uniq, tile_of = np.unique(key, return_inverse=True)
    tiles = np.zeros((len(uniq), B, B), dtype=np.float64)
    np.add.at(tiles, (tile_of, coo.row % B, coo.col % B), coo.data)
    rows = (uniq // nb_cols).astype(np.int32)
    cols = (uniq % nb_cols).astype(np.int32)
    return BlockSparseMatrix(n, n_cols, B, rows, cols, tiles, device=device)


def merge(A, B_mat):
    """A + B for two matrices on the SAME block grid: the tile lists
    concatenate (every consumer sums duplicate (row, col) entries).  Extra
    diagonals add.

    Tiles promote to the wider of the two dtypes, capped at float32 when
    either side is a sub-float32 STORAGE format: casting the second operand
    down to bfloat16 would quantize structured noise to 8 mantissa bits."""
    if (A.shape != B_mat.shape) or (A.block_size != B_mat.block_size):
        raise ValueError("merge requires matching shapes and block grids")
    d = A.diag
    if B_mat.diag is not None:
        d = B_mat.diag if d is None else d + B_mat.diag
    out_dt = torch.promote_types(A.tiles.dtype, B_mat.tiles.dtype)
    if min(torch.finfo(A.tiles.dtype).bits,
           torch.finfo(B_mat.tiles.dtype).bits) < 32 \
            and torch.finfo(out_dt).bits > 32:
        out_dt = torch.float32
    sa, sb = A._store, B_mat._store
    out = BlockSparseMatrix(
        A.n, A.n_cols, A.block_size, torch.cat([sa.rows, sb.rows]),
        torch.cat([sa.cols, sb.cols]),
        torch.cat([sa.tiles.to(out_dt), sb.tiles.to(out_dt)]), diag=d,
        live_tiles=sa.live + sb.live)
    out._store._rows_h = np.concatenate([sa.rows_h, sb.rows_h])
    out._store._cols_h = np.concatenate([sa.cols_h, sb.cols_h])
    return out


def stack_augmented_covariance(K, B, D):
    """[[K, B], [Bᵀ, D]] for block-sparse parts on compatible grids.

    K's point count must be a multiple of the block size, so that the
    appended blocks land on the same grid; callers recompute the full
    covariance otherwise.  Sentinel tiles of the parts become sentinels of
    the result (row index past its grid)."""
    if K.n % K.block_size != 0:
        raise ValueError("append grid misaligned; recompute the full "
                         "covariance")
    off = K.nb
    n = K.n + D.n
    nb = -(-n // K.block_size)
    kr, kc = K._store.rows_h, K._store.cols_h
    br, bc = B._store.rows_h, B._store.cols_h
    dr, dc = D._store.rows_h, D._store.cols_h
    b_live = (br < B.nb) & (bc < B.nb_cols)
    rows = np.concatenate([np.where(kr < K.nb, kr, nb),
                           np.where(b_live, br, nb),
                           np.where(b_live, bc + off, nb),
                           np.where(dr < D.nb, dr + off, nb)])
    cols = np.concatenate([np.where(kr < K.nb, kc, nb),
                           np.where(b_live, bc + off, nb),
                           np.where(b_live, br, nb),
                           np.where(dr < D.nb, dc + off, nb)])
    dt = K.tiles.dtype
    tiles = torch.cat([K.tiles, B.tiles.to(dt),
                       B.tiles.transpose(1, 2).to(dt), D.tiles.to(dt)])
    return BlockSparseMatrix(n, n, K.block_size, rows.astype(np.int32),
                             cols.astype(np.int32), tiles)
