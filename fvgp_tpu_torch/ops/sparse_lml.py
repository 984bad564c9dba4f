"""Differentiable block-sparse marginal likelihood and the committed-state
wide solver — the gp2Scale engine, on one device or on a mesh of ranks
(counterpart of ``fvgp_tpu/ops/sparse_lml.py``).

* Covariance tiles of the library's anisotropic Wendland kernel are
  assembled by the hand-written K5 kernel in one launch on the card
  (``ops/hopper_kernels.tile_covariance``; its plain version on the CPU),
  and the gradient reaches the hyperparameters through its closed-form VJP,
  one more launch.  Any other kernel is assembled chunk by chunk from the
  block structure, its gradient through a per-chunk recompute in the
  backward, so no full (T, B, B) autograd graph is ever held.
* The LML has two solvers.  ``solver="mbcg"`` (the default) is the fused
  mBCG estimator (Gardner et al. 2018): one preconditioned CG over
  ``[y-m | L_M·probes]`` gives the solve and a Lanczos quadrature of the
  log-determinant; its backward is one matvec-VJP and no extra solve.
  ``solver="slq"`` runs them apart: a CG solve with an implicit-function
  backward (one more CG and one matvec-VJP) and a stochastic Lanczos
  quadrature of fixed degree, differentiated through its recursion.
* The SpMM of every CG iteration and Lanczos step is the hand-written K1
  kernel on the card (``ops/hopper_kernels.chunked_spmm``); the committed
  posterior solver's wide SpMM is K2 (``row_chunk_sums``), preconditioned by
  block-Jacobi or by the two-level operator (block-Jacobi plus a Galerkin
  coarse-grid correction).

On a mesh (``parallel/mesh.py``, ``mesh=`` with more than one rank) each
rank owns a contiguous range of W row blocks and the tiles of those rows
(``parallel/partition.py``): it assembles its own tiles, factors its own
preconditioner blocks and holds its own W·B rows of every CG vector, so
the SpMM needs no cross-rank reduction.  X reaches the tiles by an
all-gather, a flat halo exchange of only the referenced foreign blocks, or
a three-stage hierarchical halo on a 2-D mesh; the rank's product is K1
with ``nb_out = W`` on the card.  Every inner product, norm and exit test
of the Krylov loops reduces over the ranks, so every rank takes the same
iteration count and branch, and the hyperparameter gradient is reduced once
(``mesh.replicate``'s backward).
"""

import math
import warnings

import torch

from .. import config
from ..kernels import wendland_anisotropic
from ..utils import trace
from ..parallel.mesh import (SLICE_AXIS, _all_reduce, exchange_blocks,
                             flat_tile_index, gather_rows, global_sum,
                             replicate, tile_device_count)
from .hopper_kernels import (chunked_spmm, chunked_spmm_vjp, row_chunk_sums,
                             tile_covariance, tile_covariance_takes,
                             tile_covariance_vjp)

__all__ = ["make_sparse_lml", "make_committed_solver", "make_padded_inputs",
           "assemble_tiles", "tile_maxabs"]

# flat-SpMM budget for the committed solver's per-tile product (bytes)
_SPMV_FLAT_BUDGET = 2 << 30


def _assembly_chunk(T_pad, target=2048):
    """Largest divisor of T_pad that is <= target (assembly chunk size)."""
    best = 1
    d = 1
    while d * d <= T_pad:
        if T_pad % d == 0:
            if d <= target:
                best = max(best, d)
            q = T_pad // d
            if q <= target:
                best = max(best, q)
        d += 1
    return best


class _LocalSpmv:
    """The single-device SpMM: K1 on a float32/bfloat16 CUDA operand, the
    plain formulation (the JAX ``_spmv``, here
    ``hopper_kernels.chunked_spmm_reference``) on the CPU and for float64 —
    decided inside ``chunked_spmm``.  ``tiles_vjp`` is the tiles' cotangent
    of the product, ``reduce`` the sum of a partial over the ranks (none
    here)."""

    def __init__(self, nb, B, mv_dtype):
        self.nb, self.B, self.mv_dtype = nb, B, mv_dtype

    def __call__(self, rows, cols, tiles, X):
        return chunked_spmm(rows, cols, tiles, X, self.nb, self.B,
                            mv_dtype=self.mv_dtype)

    def tiles_vjp(self, rows, cols, tiles, X, Ybar):
        return chunked_spmm_vjp(rows, cols, tiles, X, Ybar, self.nb, self.B,
                                self.mv_dtype, need_x=False)[0]

    @staticmethod
    def reduce(t):
        return t


def _local_rows(rows, row0, W):
    """A rank's output rows of its partitioned segment: ``rows - row0``,
    with sentinels (and foreign rows, which a correct partition never
    holds) at W, past the last row block, so the SpMM skips them.  The
    segment is row-sorted with its sentinels at the tail, so the local rows
    are too.  Kept on the rows tensor, for its current version, so a
    structure maps them once."""
    kept = getattr(rows, "_fvgp_local_rows", None)
    if kept is not None and kept[:3] == (rows._version, row0, W):
        return kept[3]
    r = rows.long()
    loc = torch.where((r >= row0) & (r < row0 + W), r - row0,
                      torch.full_like(r, W)).to(torch.int32)
    rows._fvgp_local_rows = (rows._version, row0, W, loc)
    return loc


def _local_spmm_tail(mesh, W, B, tiles, Xcat, nb_x, cols, rows, mv_dtype,
                     out_dtype):
    """Shared per-rank tail of the three mesh SpMMs (all-gather / flat halo
    / hierarchical halo): this rank's W row blocks against the gathered
    operand of ``nb_x`` blocks — K1 with ``nb_out = W`` on the card, its
    plain twin on the CPU and in float64.  (The JAX tail is an einsum and a
    segment sum; no Pallas kernel runs on its mesh path.)  ``Xcat`` arrives
    in ``out_dtype``; under bf16 streaming its values are already bf16, so
    the kernel's cast of it is exact."""
    r_loc = _local_rows(rows, flat_tile_index(mesh) * W, W)
    return chunked_spmm(r_loc, cols, tiles, Xcat, nb_x, B, mv_dtype=mv_dtype,
                        nb_out=W).to(out_dtype)


class _MeshSpmv:
    """A mesh SpMM ``spmv(rows, cols, tiles, X, *halo)``: ``X`` and the
    result are this rank's W·B rows, ``rows``/``cols`` its segment of the
    partitioned schedule (global row blocks; columns global, or remapped
    into the gathered layout under a halo), ``halo`` its rows of the
    exchange plan.  ``gather(Xb, *halo)`` builds the operand blocks from the
    rank's own (W, B, k) blocks; X is cast to the streaming dtype before it
    is exchanged, so a bf16 run moves half the bytes and multiplies the same
    values."""

    def __init__(self, nb, B, mesh, mv_dtype, gather):
        n_dev = tile_device_count(mesh)
        if nb % n_dev:
            raise ValueError(f"mesh SpMM needs nb ({nb}) divisible by the "
                             f"mesh size ({n_dev}); pad the point blocking")
        self.nb, self.B, self.mesh, self.mv_dtype = nb, B, mesh, mv_dtype
        self.W = nb // n_dev
        self._gather = gather

    def operand(self, X, halo):
        """(gathered X (nb_x·B, k) in X's dtype, nb_x)."""
        Xc = X.to(self.mv_dtype) if self.mv_dtype is not None else X
        Xcat = self._gather(Xc.reshape(self.W, self.B, -1), *halo)
        return Xcat.reshape(-1, Xcat.shape[-1]).to(X.dtype), Xcat.shape[0]

    def __call__(self, rows, cols, tiles, X, *halo):
        Xcat, nb_x = self.operand(X, halo)
        return _local_spmm_tail(self.mesh, self.W, self.B, tiles, Xcat, nb_x,
                                cols, rows, self.mv_dtype, X.dtype)

    def tiles_vjp(self, rows, cols, tiles, X, Ybar, *halo):
        Xcat, nb_x = self.operand(X, halo)
        r_loc = _local_rows(rows, flat_tile_index(self.mesh) * self.W,
                            self.W)
        return chunked_spmm_vjp(r_loc, cols, tiles, Xcat, Ybar, nb_x, self.B,
                                self.mv_dtype, need_x=False,
                                nb_out=self.W)[0]

    def reduce(self, t):
        return _all_reduce(t, self.mesh)


def _masked_blocks(Xb, sel, mask):
    """``Xb[sel] * mask`` flattened to (n_slots, B, k): the blocks a plan
    sends, zero in its padding slots."""
    out = Xb[sel.long()] * mask.to(Xb.dtype)[..., None, None]
    return out.reshape(-1, Xb.shape[1], Xb.shape[2])


def _rowpart_spmv_factory(nb, B, mesh, mv_dtype=None):
    """Row-ownership SpMM with an all-gather of X: ``(n-1)/n · nb·B·k``
    words per matvec, half the all-reduce a position-sharded tile list
    needs, and the output lands on its rows' owner."""
    return _MeshSpmv(nb, B, mesh, mv_dtype,
                     lambda Xb: gather_rows(Xb, mesh))


def _halo_spmv_factory(nb, B, mesh, halo_S, mv_dtype=None):
    """Row-ownership SpMM with a flat HALO EXCHANGE: one all-to-all of
    ``halo_S`` padded slots per (src, dst) pair ships only the distinct
    foreign column blocks each rank's tiles reference
    (``partition.halo_plan``); cols arrive remapped to positions in
    ``[own W blocks | received blocks]``.  ``halo = (send_sel, send_mask)``,
    this rank's (n_dev, S) rows of the plan."""
    def gather(Xb, send_sel, send_mask):
        recv = exchange_blocks(_masked_blocks(Xb, send_sel, send_mask),
                               mesh.group, mesh)
        return torch.cat([Xb, recv], dim=0)

    return _MeshSpmv(nb, B, mesh, mv_dtype, gather)


def _halo_hier_spmv_factory(nb, B, mesh, halo_spec, mv_dtype=None):
    """Row-ownership SpMM with the HIERARCHICAL halo of a 2-D ``(slice,
    tiles)`` mesh (``partition.halo_plan_hier``): same-slice blocks over an
    all-to-all of the rank's slice (pad ``S_ici``); cross-slice blocks are
    first forwarded within the slice to the rank whose tiles coordinate
    matches their destination's (pad ``S_fwd``), then exchanged between
    slices (pad ``S_dcn``), so the link between nodes carries only the
    slice-boundary band.  ``halo`` is this rank's rows of the six plan
    arrays."""
    if SLICE_AXIS not in mesh.shape:
        raise ValueError("hierarchical halo SpMM needs a 2-D (slice, "
                         "tiles) mesh")

    def gather(Xb, sel_ici, m_ici, sel_fwd, m_fwd, fwd_sel, m_dcn):
        recv1 = exchange_blocks(_masked_blocks(Xb, sel_ici, m_ici),
                                mesh.tiles_group, mesh)
        recv2 = exchange_blocks(_masked_blocks(Xb, sel_fwd, m_fwd),
                                mesh.tiles_group, mesh)
        recv3 = exchange_blocks(_masked_blocks(recv2, fwd_sel, m_dcn),
                                mesh.slice_group, mesh)
        return torch.cat([Xb, recv1, recv3], dim=0)

    return _MeshSpmv(nb, B, mesh, mv_dtype, gather)


def _spmv_for(nb, B, mesh=None, mv_dtype=None, halo_S=None):
    """The SpMM for this mesh: the row-ownership mesh SpMM when a mesh of
    more than one rank is given (with the flat or hierarchical halo when a
    ``halo_S`` plan key is given), else the single-device one."""
    if mesh is not None and tile_device_count(mesh) > 1:
        if halo_S is not None:
            if isinstance(halo_S, tuple):   # ("hier", S_ici, S_fwd, S_dcn)
                return _halo_hier_spmv_factory(nb, B, mesh, halo_S,
                                               mv_dtype=mv_dtype)
            return _halo_spmv_factory(nb, B, mesh, halo_S, mv_dtype=mv_dtype)
        return _rowpart_spmv_factory(nb, B, mesh, mv_dtype=mv_dtype)
    return _LocalSpmv(nb, B, mv_dtype)


def _spmv_scan(rows, cols, tiles, X, nb, B, mv_dtype=None):
    """Tile-chunked SpMM for wide right-hand sides: the flat product would
    be a (T, B, c) array, so tile slices stream through a (nb, B, c)
    accumulator instead.  Rows == nb (sentinels) are dropped; columns are
    clamped (their tiles are zero)."""
    acc_dt = X.dtype if X.dtype == torch.float64 else torch.float32
    Xc = X.to(mv_dtype) if mv_dtype is not None else X
    c = X.shape[1]
    Xb = Xc.reshape(nb, B, c)
    T = tiles.shape[0]
    # chunk sized so the per-slice product stays ~256 MB
    item = torch.finfo(acc_dt).bits // 8
    target = max(64, (256 << 20) // max(B * c * item, 1))
    chunk = _assembly_chunk(T, target=min(target, 8192))
    r = rows.long().clamp(max=nb)
    cc = cols.long().clamp(max=nb - 1)
    acc = torch.zeros((nb + 1, B, c), dtype=acc_dt, device=X.device)
    for s in range(0, T, chunk):
        t = tiles[s:s + chunk]
        if mv_dtype is not None:
            t = t.to(mv_dtype)
        acc.index_add_(0, r[s:s + chunk],
                       torch.bmm(t.to(acc_dt), Xb[cc[s:s + chunk]].to(acc_dt)))
    return acc[:nb].reshape(nb * B, c).to(X.dtype)


def _spmv_scan_fused(rowsc, cols_p, tiles, X, nb, B, C=8, mv_dtype=None):
    """Row-aligned fused SpMM for wide right-hand sides: per schedule slice,
    ``row_chunk_sums`` (K2 on the card) reduces each C-tile chunk to ONE
    (B, c) float32 partial, reading the X blocks through ``cols_p`` — the
    (T, B, c) product never exists — and the C×-fewer partials are added
    into their rows.

    ``rowsc`` (n_chunks,) per-chunk output rows (sentinel == nb, dropped
    through a dummy row block); ``cols_p`` (n_chunks*C,) per-tile column
    blocks (sentinel == nb — their tiles must be zero: the float32 kernel
    skips them, the bfloat16 one and the plain version multiply them by
    the clamped last block).  float32/bfloat16 only (the kernel
    accumulates float32)."""
    Xc = X.to(mv_dtype) if mv_dtype is not None else X
    c = X.shape[1]
    Xb = Xc.reshape(nb, B, c)
    n_chunks = rowsc.shape[0]
    # slice so each slice's partial sums stay ~256 MB
    per_chunk = B * c * 4
    target = max(32, (256 << 20) // max(per_chunk, 1))
    M = _assembly_chunk(n_chunks, target=min(target, 4096))
    rc = rowsc.long().clamp(max=nb)
    acc = torch.zeros((nb + 1, B, c), dtype=torch.float32, device=X.device)
    for s in range(0, n_chunks, M):
        sums = row_chunk_sums(tiles[s * C:(s + M) * C],
                              cols_p[s * C:(s + M) * C], Xb, B, C=C)
        acc.index_add_(0, rc[s:s + M], sums)
    return acc[:nb].reshape(nb * B, c).to(X.dtype)


def _assemble_chunk(kernel_fn, hps, r, c, live, xb, mask, out_dtype):
    """Tiles k(xb[r[t]], xb[c[t]]) with padding masked and dead (sentinel)
    tiles zeroed, cast per chunk to ``out_dtype``."""
    Kt = kernel_fn(xb[r], xb[c], hps)
    Kt = Kt * (mask[r][:, :, None] * mask[c][:, None, :])
    Kt = torch.where(live[:, None, None], Kt, torch.zeros((), dtype=Kt.dtype,
                                                          device=Kt.device))
    return Kt.to(out_dtype)


class _AssembleTiles(torch.autograd.Function):
    """Chunked tile assembly with a recompute-per-chunk backward (the
    counterpart of ``jax.checkpoint`` over ``_assembly_chunk`` slices):
    neither pass holds more than one chunk of kernel intermediates, and a
    ``solver_dtype=bfloat16`` tile set never exists in float32."""

    @staticmethod
    def forward(ctx, hps, kernel_fn, B, out_dtype, rows_c, cols_c, live, xb,
                mask):
        T = rows_c.shape[0]
        chunk = _assembly_chunk(T)
        tiles = torch.empty((T, B, B), dtype=out_dtype, device=xb.device)
        for s in range(0, T, chunk):
            sl = slice(s, s + chunk)
            tiles[sl] = _assemble_chunk(kernel_fn, hps, rows_c[sl],
                                        cols_c[sl], live[sl], xb, mask,
                                        out_dtype)
        ctx.save_for_backward(hps, rows_c, cols_c, live, xb, mask)
        ctx.kernel_fn, ctx.out_dtype, ctx.chunk = kernel_fn, out_dtype, chunk
        return tiles

    @staticmethod
    def backward(ctx, tiles_bar):
        hps, rows_c, cols_c, live, xb, mask = ctx.saved_tensors
        grad = torch.zeros_like(hps)
        with trace.span("fvgp.sparse_lml.assemble_bwd"):
            for s in range(0, rows_c.shape[0], ctx.chunk):
                sl = slice(s, s + ctx.chunk)
                with torch.enable_grad():
                    h = hps.detach().requires_grad_(True)
                    Kt = _assemble_chunk(ctx.kernel_fn, h, rows_c[sl],
                                         cols_c[sl], live[sl], xb, mask,
                                         ctx.out_dtype)
                    g, = torch.autograd.grad(Kt, h,
                                             grad_outputs=tiles_bar[sl])
                grad += g
        return grad, None, None, None, None, None, None, None, None


class _WendlandTiles(torch.autograd.Function):
    """The library Wendland kernel's tile assembly on K5 (its plain version
    for CPU tensors): one launch writes every tile, and the backward is the
    closed-form hyperparameter VJP, one launch that reads the tiles'
    cotangent once."""

    @staticmethod
    def forward(ctx, hps, out_dtype, rows_c, cols_c, live, xb, mask):
        ctx.save_for_backward(hps, rows_c, cols_c, live, xb, mask)
        return tile_covariance(xb, mask, rows_c, cols_c, live, hps, out_dtype)

    @staticmethod
    def backward(ctx, tiles_bar):
        hps, rows_c, cols_c, live, xb, mask = ctx.saved_tensors
        with trace.span("fvgp.sparse_lml.assemble_bwd"):
            grad = tile_covariance_vjp(xb, mask, rows_c, cols_c, live, hps,
                                       tiles_bar)
        return grad, None, None, None, None, None, None


def _assemble_chunked_tiles(kernel_fn, B, solver_dtype, hps, rows_c, cols_c,
                            live, xb, mask):
    """Tile assembly (shared by the LML and the committed solver);
    differentiable in ``hps``.  Tiles come out in ``solver_dtype`` (or the
    points' dtype).  The library's Wendland object (by identity: a user's
    function of that name is another kernel) takes K5 where its operands
    are ones K5 takes (``tile_covariance_takes``); every other kernel the
    chunked autograd path, which differentiates any callable."""
    out_dtype = solver_dtype if solver_dtype is not None else xb.dtype
    if kernel_fn is wendland_anisotropic \
            and tile_covariance_takes(xb, hps, out_dtype):
        return _WendlandTiles.apply(hps, out_dtype, rows_c, cols_c, live, xb,
                                    mask)
    return _AssembleTiles.apply(hps, kernel_fn, B, out_dtype, rows_c, cols_c,
                                live, xb, mask)


def _index(ix, device):
    return torch.as_tensor(ix).to(device=device, dtype=torch.long)


def assemble_tiles(kernel_fn, xb, mask, rows, cols, hps, out_dtype=None):
    """tiles[t] = k(x block rows[t], x block cols[t]) with padding masked:
    the gp2Scale LML's op-level assembler (chunked, differentiable in
    ``hps``), tiles in ``out_dtype`` (default: the points' dtype).

    xb: (nb, B, D) padded point blocks; mask: (nb, B) validity; rows/cols:
    (T,) indices.  The JAX package's sentinel contract: pass UNCLAMPED
    indices (sentinel == nb).  The gather clamps them to the last block,
    which gives a tile of that block; the consumer drops it because the
    unclamped row lies outside ``[0, nb)`` (K1 skips such rows)."""
    last = xb.shape[0] - 1
    rows_c = torch.clamp(_index(rows, xb.device), max=last)
    cols_c = torch.clamp(_index(cols, xb.device), max=last)
    live = torch.ones(rows_c.shape, dtype=torch.bool, device=xb.device)
    hps = torch.as_tensor(hps, dtype=xb.dtype, device=xb.device)
    return _assemble_chunked_tiles(kernel_fn, xb.shape[1],
                                   config.as_torch_dtype(out_dtype), hps,
                                   rows_c, cols_c, live, xb, mask)


def tile_maxabs(kernel_fn, xb, mask, rows, cols, hps):
    """Per-tile max|k| for the exact zero-tile filter, one assembly chunk
    (``_assembly_chunk``) at a time, so the (T, B, B) tile set is never
    held whole."""
    rows, cols = _index(rows, xb.device), _index(cols, xb.device)
    T = int(rows.shape[0])
    chunk = _assembly_chunk(T)
    out = torch.zeros(T, dtype=xb.dtype, device=xb.device)
    with torch.no_grad():
        for s in range(0, T, chunk):
            out[s:s + chunk] = torch.amax(torch.abs(assemble_tiles(
                kernel_fn, xb, mask, rows[s:s + chunk], cols[s:s + chunk],
                hps)), dim=(1, 2))
    return out


def _diag_precond_blocks(kernel_fn, B, precond_width, hps, xb, mask,
                         noise_local, i0=0):
    """Block-diagonal preconditioner from exact kernel blocks of
    ``precond_width`` adjacent point blocks each: one batched Cholesky and
    an explicit block inverse, so each CG iteration applies it with one
    batched matmul.  No gradient: it steers the iteration, not the
    solution."""
    nb_loc = noise_local.shape[0] // B
    if nb_loc % precond_width == 0:
        w = precond_width
    else:
        warnings.warn(
            f"gp2Scale_precond_width={precond_width} does not divide the "
            f"local block count {nb_loc}; falling back to width-1 "
            "block-Jacobi (choose a width dividing n_blocks)", stacklevel=2)
        w = 1
    P = w * B
    ng = nb_loc // w
    with torch.no_grad():
        hps = hps.detach()
        xg = xb[i0:i0 + nb_loc].reshape(ng, P, xb.shape[-1])
        mg = mask[i0:i0 + nb_loc].reshape(ng, P)
        blocks = kernel_fn(xg, xg, hps) * (mg[:, :, None] * mg[:, None, :])
        blocks = blocks + torch.diag_embed(noise_local.reshape(ng, P))
        Lb = torch.linalg.cholesky(blocks)
        eye = torch.eye(P, dtype=Lb.dtype, device=Lb.device)
        Linv = torch.linalg.solve_triangular(Lb, eye.expand(ng, P, P),
                                             upper=False)
        Minv = torch.bmm(Linv.transpose(1, 2), Linv)
    return Minv, Lb


def _freeze_tol_sq(tol, mv_dtype, res_dtype):
    """Squared relative exit tolerance on rz = Rᵀ M⁻¹ R: the user's
    ``sparse_cg_tol`` squared, else the per-dtype floor of the JAX package
    (bf16 streaming 2.5e-3, float32 1e-8, float64 1e-14 — the bf16 value
    was tuned on a TPU and is kept until it is re-measured on the card)."""
    if tol is not None:
        return float(tol) ** 2
    if mv_dtype is not None and torch.finfo(mv_dtype).bits < 32:
        return 2.5e-3
    if res_dtype == torch.float64:
        return 1e-14
    return 1e-8


def _tight_floor_sq(res_dtype):
    """Per-column freeze floor (numerical safety only: keeps 1/rz finite
    once a column has collapsed)."""
    return 1e-14 if res_dtype == torch.float64 else 1e-10


def _above(rz, floor):
    """The CG exit test, read on the host: whether any column's residual
    is still above its floor (one host sync)."""
    trace.count("host_syncs")
    return bool((rz > floor).any())


def _live_columns(rz, floor):
    """The CG exit test with the columns it leaves: (how many columns are
    still above their floor, read on the host in one host sync, and which
    they are)."""
    live = rz > floor
    trace.count("host_syncs")
    return int(live.sum()), live


def _cg_fixed(matvec, Bmat, iters, M=None, tol=None, mv_dtype=None,
              with_iters=False, reduce=None, compact=False):
    """(Preconditioned) multi-RHS CG, at most ``iters`` trips, exiting as
    soon as every column's preconditioned residual is below the exit
    floor.  ``with_iters=True`` also returns the executed trip count.  On a
    mesh ``Bmat`` is the rank's rows and ``reduce`` sums each column's
    inner product over the ranks, so every rank sees the same coefficients
    and exit test.

    ``compact=True`` drops the columns that are below the exit floor from
    the iteration once the rest fit three quarters of the width, keeping a
    multiple of 8 columns: a trip then costs the columns still converging,
    not the width, and every column stops where it meets the floor (the
    trip count is the slowest column's either way).  On a mesh every rank
    drops the same columns, since the reduced inner products, and so the
    exit test, are the same on every rank."""
    if M is None:
        M = lambda X: X                       # noqa: E731
    if reduce is None:
        reduce = lambda t: t                  # noqa: E731
    X = torch.zeros_like(Bmat)
    R = Bmat.clone()
    Zp = M(R)
    # R is updated in place below: without a preconditioner Zp IS R
    P = Zp.clone()
    rz = reduce(torch.sum(R * Zp, dim=0))
    # once the residual has collapsed, further updates must be EXACT no-ops
    rz0 = torch.clamp(rz, min=torch.finfo(Bmat.dtype).tiny)
    floor = rz0 * _tight_floor_sq(Bmat.dtype)
    exit_floor = rz0 * _freeze_tol_sq(tol, mv_dtype, Bmat.dtype)
    one = torch.ones((), dtype=Bmat.dtype, device=Bmat.device)
    zero = torch.zeros((), dtype=Bmat.dtype, device=Bmat.device)
    # the full-width solution and the columns X holds of it (all, until a
    # compaction)
    out, cols = X, None
    it = 0
    while it < iters:
        if not compact:
            if not _above(rz, exit_floor):
                break
        else:
            n_live, live = _live_columns(rz, exit_floor)
            if n_live == 0:
                break
            width = -(-n_live // 8) * 8
            if width <= 3 * X.shape[1] // 4:
                # the live columns first, each group in column order
                keep = torch.argsort((~live).to(torch.uint8),
                                     stable=True)[:width]
                if cols is None:
                    cols = keep
                else:
                    out[:, cols] = X
                    cols = cols[keep]
                X, R, P = X[:, keep], R[:, keep], P[:, keep]
                rz, floor, exit_floor = rz[keep], floor[keep], \
                    exit_floor[keep]
        active = rz > floor
        Ap = matvec(P)
        trace.count("cg_columns", P.shape[1])
        pAp = reduce(torch.sum(P * Ap, dim=0))
        alpha = torch.where(active, rz / torch.where(active, pAp, one), zero)
        X.add_(alpha * P)
        R.sub_(alpha * Ap)
        Zn = M(R)
        rz_new = reduce(torch.sum(R * Zn, dim=0))
        beta = torch.where(active, rz_new / torch.where(active, rz, one),
                           zero)
        P = torch.where(active[None, :], Zn + beta * P, P)
        rz = rz_new
        it += 1
    if cols is not None:
        out[:, cols] = X
    trace.count("cg_iterations", it)
    return (out, it) if with_iters else out


def _block_apply(mats, X):
    """Batched block-diagonal apply: (nb', w, w) blocks on a flat
    (nb'*w, k) X — one batched matmul."""
    Xb = X.reshape(mats.shape[0], mats.shape[1], -1)
    return torch.bmm(mats, Xb).reshape(mats.shape[0] * mats.shape[1], -1)


def _pcg_coeffs(mv, Minv, RHS, iters, tol, mv_dtype, reduce):
    """PCG over all RHS columns, recording the CG coefficients (the mBCG
    forward).  Two thresholds: the global EXIT floor (loose, matched to the
    matvec dtype) and the per-column FREEZE floor (numerical safety) —
    columns keep iterating until the global exit, so every probe's
    quadrature degree equals the exit iteration.  Coefficient buffers are
    pre-filled with the frozen-identity values (alpha=1, beta=0), so an
    early exit gives the quadrature inputs of a static run of that length."""
    X = torch.zeros_like(RHS)
    R = RHS
    Zp = _block_apply(Minv, R)
    D = Zp
    rz = reduce(torch.sum(R * Zp, dim=0))
    floor = rz * _tight_floor_sq(RHS.dtype)
    exit_floor = rz * _freeze_tol_sq(tol, mv_dtype, RHS.dtype)
    n_cols = RHS.shape[1]
    alphas = torch.ones((iters, n_cols), dtype=RHS.dtype, device=RHS.device)
    betas = torch.zeros((iters, n_cols), dtype=RHS.dtype, device=RHS.device)
    one = torch.ones((), dtype=RHS.dtype, device=RHS.device)
    zero = torch.zeros((), dtype=RHS.dtype, device=RHS.device)
    i = 0
    while i < iters and _above(rz, exit_floor):
        active = rz > floor
        AD = mv(D)
        dAd = reduce(torch.sum(D * AD, dim=0))
        alpha = torch.where(active, rz / torch.where(active, dAd, one), zero)
        X = X + D * alpha
        R = R - AD * alpha
        Z2 = _block_apply(Minv, R)
        rz2 = reduce(torch.sum(R * Z2, dim=0))
        beta = torch.where(active, rz2 / torch.where(active, rz, one), zero)
        D = Z2 + D * beta
        alphas[i] = torch.where(active, alpha, one)
        betas[i] = torch.where(active, beta, zero)
        rz = rz2
        i += 1
    trace.count("mbcg_iterations", i)
    return X, alphas, betas


def _t_quadrature(alphas, betas, u_norm2):
    """Per-probe e1-quadrature of log on the CG-coefficient tridiagonals
    (T(i,i) = 1/α_i + β_{i-1}/α_{i-1}, T(i,i+1) = √β_i/α_i).
    alphas/betas: (iters, P).  Returns (mean, variance / P)."""
    a = alphas.T
    b = betas.T
    P = a.shape[0]
    prev = torch.cat([torch.zeros((P, 1), dtype=a.dtype, device=a.device),
                      b[:, :-1] / a[:, :-1]], dim=1)
    diag = 1.0 / a + prev
    off = torch.sqrt(torch.clamp(b[:, :-1], min=0.0)) / a[:, :-1]
    T = (torch.diag_embed(diag) + torch.diag_embed(off, offset=1)
         + torch.diag_embed(off, offset=-1))
    theta, Uq = torch.linalg.eigh(T)
    theta = torch.clamp(theta, min=1e-30)
    vals = u_norm2 * torch.sum(Uq[:, 0, :] ** 2 * torch.log(theta), dim=1)
    return torch.mean(vals), torch.var(vals, unbiased=False) / P


class _QuadLogdet(torch.autograd.Function):
    """Fused quadratic term + log-determinant (the mBCG recipe).

    Forward: ONE preconditioned CG over ``[ym | L_M·U]`` gives the solve x
    (column 0) and, from the CG coefficients, a degree-``iters`` Lanczos
    quadrature of log|M⁻¹(K+V)| with probes z = L_M u; log|M| is exact from
    the block Cholesky diagonals.

    Backward (no extra solve):
      d quad   = -xᵀ d(K+V) x
      d logdet ≈ (1/P) Σ_j s_jᵀ d(K+V) (M⁻¹z_j)     (s_j = (K+V)⁻¹z_j)
    both as ONE matvec-VJP over the stacked primal/cotangent, giving the
    tile cotangent (a batched outer product) and the noise cotangent.
    ``Minv``/``Lm`` get no cotangent (they only steer the iteration).

    ``spmv`` is ``_spmv_for``'s SpMM (by default the single-device one of
    ``nb``, ``B``) and ``halo`` its plan arguments.  On a mesh the vectors are the rank's rows: the quadratic term, the probes'
    norms and log|M| are summed over the ranks in the forward, and the
    backward gives the rank's own tile and noise cotangents, which the
    hyperparameter gradient sums once (``mesh.replicate``)."""

    @staticmethod
    def forward(ctx, tiles, noise, Minv, Lm, ym, U, rows, cols_c, nb, B,
                iters, mv_dtype, tol, spmv=None, halo=()):
        spmv = spmv or _LocalSpmv(nb, B, mv_dtype)
        if Lm.shape != Minv.shape:
            raise ValueError("mBCG: the preconditioner factor and its "
                             "inverse must share a shape")

        def mv(X):
            return spmv(rows, cols_c, tiles, X, *halo) + noise[:, None] * X

        with trace.span("fvgp.sparse_lml.mbcg"):
            Z = _block_apply(Lm, U)
            RHS = torch.cat([ym[:, None], Z], dim=1)
            X, alphas, betas = _pcg_coeffs(mv, Minv, RHS, iters, tol,
                                           mv_dtype, spmv.reduce)
            x = X[:, 0]
            S = X[:, 1:]
            quad = spmv.reduce(torch.dot(ym, x))
            u2 = spmv.reduce(torch.sum(U * U, dim=0))
            ld_C, ld_var = _t_quadrature(alphas[:, 1:], betas[:, 1:], u2)
            ld_M = spmv.reduce(2.0 * torch.sum(torch.log(
                torch.diagonal(Lm, dim1=1, dim2=2))))
        ctx.save_for_backward(tiles, Minv, x, S, Z, rows, cols_c)
        ctx.spmv, ctx.halo = spmv, halo
        return quad, ld_M + ld_C, ld_var

    @staticmethod
    def backward(ctx, qb, lb, _):
        tiles, Minv, x, S, Z, rows, cols_c = ctx.saved_tensors
        P = S.shape[1]
        with trace.span("fvgp.sparse_lml.mbcg_bwd"):
            Xp = torch.cat([x[:, None], _block_apply(Minv, Z)], dim=1)
            Cot = torch.cat([(-qb) * x[:, None], (lb / P) * S], dim=1)
            tiles_bar = None
            if ctx.needs_input_grad[0]:
                tiles_bar = ctx.spmv.tiles_vjp(rows, cols_c, tiles, Xp, Cot,
                                               *ctx.halo)
            noise_bar = torch.sum(Cot * Xp, dim=1) \
                if ctx.needs_input_grad[1] else None
            ym_bar = (2.0 * qb) * x
        return (tiles_bar, noise_bar, None, None, ym_bar, None, None, None,
                None, None, None, None, None, None, None)


class _SymmetricSpmm(torch.autograd.Function):
    """``A @ X`` on K1 with a backward that uses the schedule's mirror
    symmetry: a covariance schedule holds every tile and its mirror (the
    tile at (c, r) is the tile at (r, c) transposed), so ``Aᵀ Ȳ = A Ȳ`` is
    one more K1 launch instead of the general VJP's plain transposed
    scatter.  The tiles' cotangent is the general VJP's (``need_x=False``).
    The forward saves X and nothing of the tiles' gathers.  On a mesh both
    are rank-local: the rank's rows of ``A Ȳ`` are one more mesh SpMM, and
    its tiles' cotangent reads the gathered X."""

    @staticmethod
    def forward(ctx, tiles, X, rows, cols_c, nb, B, mv_dtype, spmv=None,
                halo=()):
        spmv = spmv or _LocalSpmv(nb, B, mv_dtype)
        ctx.save_for_backward(tiles, X, rows, cols_c)
        ctx.spmv, ctx.halo = spmv, halo
        return spmv(rows, cols_c, tiles, X, *halo)

    @staticmethod
    def backward(ctx, ybar):
        tiles, X, rows, cols_c = ctx.saved_tensors
        tiles_bar = X_bar = None
        if ctx.needs_input_grad[0]:
            tiles_bar = ctx.spmv.tiles_vjp(rows, cols_c, tiles, X, ybar,
                                           *ctx.halo)
        if ctx.needs_input_grad[1]:
            X_bar = ctx.spmv(rows, cols_c, tiles, ybar, *ctx.halo)
        return tiles_bar, X_bar, None, None, None, None, None, None, None


def _slq_fixed(matvec, Z, degree, gsum=None):
    """SLQ log-determinant with fixed probes ``Z`` (n_pad, P) and a fixed
    degree; Rademacher probes are zero on padded rows, so the estimate
    covers the logical matrix.  One Lanczos recursion batched over the P
    columns (one SpMM of width P per step, per-column alpha / beta), then
    one batched ``eigh`` of the P tridiagonals.  Returns the mean of the P
    estimates and their population variance over P.

    The JAX package checkpoints every step so that its backward does not
    keep the step's gathered (T, B, k) tile blocks.  Here the step's SpMM
    is an autograd Function that saves X only, so no recompute is needed.

    On a mesh ``Z`` is the rank's rows and ``gsum`` (``mesh.global_sum``)
    sums each inner product over the ranks; its cotangent passes through
    unchanged, so the replicated recursion is differentiated once."""
    if gsum is None:
        def norm(A):
            return torch.linalg.norm(A, dim=0)

        def dot(A, C):
            return torch.sum(A * C, dim=0)
    else:
        def norm(A):
            return torch.sqrt(gsum(torch.sum(A * A, dim=0)))

        def dot(A, C):
            return gsum(torch.sum(A * C, dim=0))
    P = Z.shape[1]
    tiny = torch.finfo(Z.dtype).tiny
    v = Z / norm(Z)
    v_prev = torch.zeros_like(v)
    beta_prev = torch.zeros(P, dtype=Z.dtype, device=Z.device)
    alphas, betas = [], []
    for _ in range(int(degree)):
        w = matvec(v)
        alpha = dot(w, v)
        w = w - alpha * v - beta_prev * v_prev
        beta = norm(w)
        # breakdown guard in the working dtype: a literal 1e-300 is 0 in
        # float32, and an exact breakdown (diagonal K+V) would give 0/0
        v_prev, v = v, w / torch.clamp(beta, min=tiny)
        beta_prev = beta
        alphas.append(alpha)
        betas.append(beta)
    a = torch.stack(alphas, dim=1)
    b = torch.stack(betas[:-1], dim=1) if len(betas) > 1 \
        else a[:, :0]
    T = (torch.diag_embed(a) + torch.diag_embed(b, offset=1)
         + torch.diag_embed(b, offset=-1))
    theta, U = torch.linalg.eigh(T)
    theta = torch.clamp(theta, min=1e-30)
    vals = dot(Z, Z) * torch.sum(U[:, 0, :] ** 2 * torch.log(theta), dim=1)
    return torch.mean(vals), torch.var(vals, correction=0) / P


class _ImplicitCG(torch.autograd.Function):
    """(K+V)⁻¹ Bv by CG, differentiated by the implicit-function theorem:
    for X = (K+V)⁻¹ Bv the backward is one more CG, W = (K+V)⁻¹ X̄, and one
    matvec-VJP at the primal solution with every cotangent negated:
    tiles get -W[r] X[c]ᵀ, the noise -Σ_k W·X, Bv gets W.  ``Minv`` (the
    block-inverse preconditioner, or None) only steers the iteration and
    gets no cotangent.  On a mesh every vector is the rank's rows and both
    CGs reduce their inner products over the ranks (``spmv.reduce``)."""

    @staticmethod
    def forward(ctx, tiles, noise, Minv, Bv, rows, cols_c, nb, B, iters,
                mv_dtype, tol, spmv=None, halo=()):
        spmv = spmv or _LocalSpmv(nb, B, mv_dtype)

        def mv(X):
            return spmv(rows, cols_c, tiles, X, *halo) + noise[:, None] * X

        M = None if Minv is None else (lambda X: _block_apply(Minv, X))
        X = _cg_fixed(mv, Bv, iters, M=M, tol=tol, mv_dtype=mv_dtype,
                      reduce=spmv.reduce)
        ctx.save_for_backward(tiles, noise, Minv, X, rows, cols_c)
        ctx.spmv, ctx.halo, ctx.iters = spmv, halo, iters
        ctx.mv_dtype, ctx.tol = mv_dtype, tol
        return X

    @staticmethod
    def backward(ctx, Xbar):
        tiles, noise, Minv, X, rows, cols_c = ctx.saved_tensors
        spmv, halo = ctx.spmv, ctx.halo

        def mv(V):
            return spmv(rows, cols_c, tiles, V, *halo) + noise[:, None] * V

        M = None if Minv is None else (lambda V: _block_apply(Minv, V))
        W = _cg_fixed(mv, Xbar.contiguous(), ctx.iters, M=M, tol=ctx.tol,
                      mv_dtype=ctx.mv_dtype, reduce=spmv.reduce)
        tiles_bar = noise_bar = None
        if ctx.needs_input_grad[0]:
            tiles_bar = spmv.tiles_vjp(rows, cols_c, tiles, X, -W, *halo)
        if ctx.needs_input_grad[1]:
            noise_bar = -torch.sum(W * X, dim=1)
        return (tiles_bar, noise_bar, None, W, None, None, None, None, None,
                None, None, None, None)


def make_sparse_lml(kernel_fn, nb, B, *, cg_iters=64, slq_degree=20,
                    with_variance=False, mean_mode="data", prior_mean_fn=None,
                    precondition=True, solver_dtype=None, solver="mbcg",
                    mesh=None, precond_width=1, halo_S=None, cg_tol=None):
    """The sparse LML as a differentiable function

        lml(hps, rows, cols, xb, mask, y_pad, ypad_mask, noise_diag_pad, Z
            [, *plan, cols_remap])

    ``hps`` is a tensor (``requires_grad`` for the gradient).  ``rows`` /
    ``cols`` are the tile schedule with sentinel entries (index == nb) for
    bucket padding; on the card the schedule must be ROW-SORTED (the K1
    kernel owns one output row block per thread block) — sort it once per
    structure on the host, sentinels at the tail.  The SpMM gets the
    sentinel rows unclamped, so it skips them: clamped into the last row
    block they would serialize that block's work.  y/noise arrive padded
    to nb*B with a validity mask (padded noise is 1.0; probes ``Z`` are
    zero on padded rows, so padding adds log(1) = 0).

    ``solver="mbcg"`` (the default) is the fused estimator; ``"slq"`` runs
    an implicit-gradient CG solve (preconditioned by the block inverses
    when ``precondition``) and a degree-``slq_degree`` Lanczos quadrature
    of log|K+V| on the probes.  The SLQ backward takes ``Aᵀ = A`` from the
    schedule's mirror symmetry: the schedule must hold every tile and its
    mirror, as a covariance's does.  ``mean_mode="data"`` centres y on its
    mean, anything else on ``prior_mean_fn(hps)``.

    ``cg_iters`` is a maximum: the solve exits once every column's relative
    preconditioned residual is below ``cg_tol`` (per-dtype defaults in
    ``_freeze_tol_sq``); the mBCG quadrature degree follows the exit
    point.

    ``mesh`` (more than one rank; ``nb`` a multiple of the rank count):
    ``rows``/``cols`` are the rank's segment of the partitioned schedule
    (``partition.partition_schedule``: global block indices, row-sorted,
    sentinels == nb at the tail) and ``y_pad``, ``ypad_mask``,
    ``noise_diag_pad`` and ``Z`` the rank's W·B rows; ``hps``, ``xb`` and
    ``mask`` are replicated.  With ``halo_S`` (the plan key of
    ``partition.choose_halo``) the rank's rows of the plan arrays and its
    remapped columns follow ``Z``: tile assembly keeps the global columns,
    only the SpMM reads the remapped ones.  Every rank returns the same
    value and gradient."""
    if solver not in ("slq", "mbcg"):
        raise ValueError(f"unknown sparse-LML solver {solver!r}; "
                         "use 'mbcg' (fused, the default — also what the GP "
                         "facade and bench use) or 'slq'")
    n_dev = 1
    if mesh is not None:
        n_dev = tile_device_count(mesh)
        if n_dev > 1 and nb % n_dev:
            raise ValueError(
                f"make_sparse_lml(mesh=...): nb ({nb}) must be a multiple of "
                f"the mesh size ({n_dev}); pad the point blocking "
                "(make_padded_inputs(..., row_multiple=n_dev))")
    if n_dev <= 1:
        mesh = None
    if mesh is None:
        halo_S = None
    spmv = _spmv_for(nb, B, mesh, mv_dtype=solver_dtype, halo_S=halo_S)
    row0 = flat_tile_index(mesh) * (nb // n_dev) if mesh is not None else 0

    def gsum(t):
        return global_sum(t, mesh) if mesh is not None else t

    def lml(hps, rows, cols, xb, mask, y_pad, ypad_mask, noise_diag_pad, Z,
            *halo_args):
        # the rank's tiles and the mean enter its own work: their
        # hyperparameter cotangents are summed over the ranks once, here
        hps_l = replicate(hps, mesh) if mesh is not None else hps
        with trace.span("fvgp.sparse_lml.assemble"):
            rows_c = torch.clamp(rows, max=nb - 1)
            cols_c = torch.clamp(cols, max=nb - 1)
            tiles = _assemble_chunked_tiles(kernel_fn, B, solver_dtype, hps_l,
                                            rows_c, cols_c, rows < nb, xb,
                                            mask)
        if halo_S is not None:
            mv_cols, halo = halo_args[-1], tuple(halo_args[:-1])
        else:
            mv_cols, halo = cols_c, ()
        Minv = Lb = None
        if solver == "mbcg" or precondition:
            with trace.span("fvgp.sparse_lml.precond"):
                Minv, Lb = _diag_precond_blocks(kernel_fn, B, precond_width,
                                                hps, xb, mask, noise_diag_pad,
                                                i0=row0)
        n = spmv.reduce(torch.sum(ypad_mask))
        if mean_mode == "data":
            m = spmv.reduce(torch.sum(y_pad)) / n
        else:
            m = prior_mean_fn(hps_l)
        ym = (y_pad - m) * ypad_mask
        if solver == "mbcg":
            quad, logdet, logdet_var = _QuadLogdet.apply(
                tiles, noise_diag_pad, Minv, Lb, ym, Z, rows, mv_cols, nb, B,
                cg_iters, solver_dtype, cg_tol, spmv, halo)
        else:
            alpha = _ImplicitCG.apply(
                tiles, noise_diag_pad, Minv if precondition else None,
                ym[:, None], rows, mv_cols, nb, B, cg_iters, solver_dtype,
                cg_tol, spmv, halo)[:, 0]
            quad = gsum(torch.dot(ym, alpha))

            def matvec(X):
                return (_SymmetricSpmm.apply(tiles, X, rows, mv_cols, nb, B,
                                             solver_dtype, spmv, halo)
                        + noise_diag_pad[:, None] * X)

            logdet, logdet_var = _slq_fixed(
                matvec, Z, slq_degree, gsum if mesh is not None else None)
        value = -0.5 * (quad + logdet + n * math.log(2.0 * math.pi))
        if with_variance:
            return value, logdet_var
        return value

    return lml


def _coarse_inverse(tiles, rows, cols, noise_diag_pad, nb, B, cw, row0=0,
                    reduce=None):
    """Inverse of the Galerkin coarse matrix A_c = Pᵀ(K+V)P for the
    block-constant prolongation P over groups of ``cw`` point blocks
    (``ops/precond.build_two_level_op``'s correction, rebuilt from the
    committed tile set): per-tile sums scatter-added into (nbg, nbg), the
    groups' noise sums on the diagonal, one dense Cholesky and an explicit
    inverse.  Float32 throughout: the coarse grid only steers the CG
    iteration, never the solution.  Sentinel tiles are zero, so their
    clamped scatter targets get nothing.  The float32 scatter adds in
    another order from run to run on the card; only the iteration count
    can notice.  On a mesh the rank's tiles and noise rows (from block
    ``row0``) give its share of A_c, which ``reduce`` sums over the ranks:
    every rank then holds the same coarse inverse."""
    nbg = -(-nb // cw)
    T = tiles.shape[0]
    ts = torch.empty(T, dtype=torch.float32, device=tiles.device)
    step = 16384
    for s in range(0, T, step):
        ts[s:s + step] = torch.sum(tiles[s:s + step].to(torch.float32),
                                   dim=(1, 2))
    gr = torch.clamp(rows.long() // cw, max=nbg - 1)
    gc = torch.clamp(cols.long() // cw, max=nbg - 1)
    Ac = torch.zeros((nbg, nbg), dtype=torch.float32, device=tiles.device)
    Ac.index_put_((gr, gc), ts, accumulate=True)
    nb_loc = noise_diag_pad.shape[0] // B
    ns = torch.sum(noise_diag_pad.to(torch.float32).reshape(nb_loc, B),
                   dim=1)
    gb = torch.clamp((row0 + torch.arange(nb_loc, device=tiles.device))
                     // cw, max=nbg - 1)
    Ac.index_put_((gb, gb), ns, accumulate=True)
    if reduce is not None:
        Ac = reduce(Ac)
    # mirrored tiles make A_c symmetric up to the scatter's rounding; the
    # small relative jitter covers the float32 sums (PᵀAP of an SPD A is SPD)
    Ac = 0.5 * (Ac + Ac.T)
    eye = torch.eye(nbg, dtype=torch.float32, device=tiles.device)
    L = torch.linalg.cholesky(Ac + (1e-6 * torch.mean(torch.diagonal(Ac)))
                              * eye)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    return Linv.T @ Linv


def _two_level_apply(pdata, X, B, cw, row0=0, reduce=None):
    """M⁻¹X = block-Jacobi smoother + additive coarse correction
    P A_c⁻¹ Pᵀ X (block-constant P over ``cw``-block groups; the last group
    may be short).  The correction is added into the smoother's output in
    place.  On a mesh X is the rank's rows, from block ``row0``: Pᵀ X is
    summed over the ranks by ``reduce`` and each rank adds the correction
    of its own rows."""
    Minv, Acinv = pdata
    z = _block_apply(Minv, X)
    nbg = Acinv.shape[0]
    gsz = cw * B
    n, k = X.shape
    if reduce is not None:
        g = torch.clamp((row0 * B + torch.arange(n, device=X.device)) // gsz,
                        max=nbg - 1)
        r_c = torch.zeros((nbg, k), dtype=X.dtype, device=X.device)
        r_c = reduce(r_c.index_add_(0, g, X))
        y = (Acinv @ r_c.to(Acinv.dtype)).to(z.dtype)
        return z.add_(y[g])
    full = n // gsz
    r_c = torch.zeros((nbg, k), dtype=X.dtype, device=X.device)
    if full:
        r_c[:full] = torch.sum(X[:full * gsz].reshape(full, gsz, k), dim=1)
    if full < nbg:
        r_c[full] = torch.sum(X[full * gsz:], dim=0)
    y = (Acinv @ r_c.to(Acinv.dtype)).to(z.dtype)
    if full:
        z[:full * gsz].view(full, gsz, k).add_(y[:full, None, :])
    if full < nbg:
        z[full * gsz:].add_(y[full])
    return z


def _normalize_committed_precond(name):
    """Canonical name of the committed solver's preconditioner."""
    n = str(name).lower()
    if n in ("two_level", "twolevel", "two-level") or "amg" in n:
        return "two_level"
    if n in ("block_jacobi", "jacobi", "bj", "diag", "diagonal"):
        return "block_jacobi"
    raise Exception(f"Unknown committed-solver preconditioner: {name!r}. "
                    f"Known: block_jacobi, two_level/amg.")


def _coarse_width(nb, coarse_width=None):
    """Point blocks per coarse aggregate of the two-level preconditioner:
    the caller's, else sized so the coarse grid stays at most 4096."""
    return int(coarse_width) if coarse_width else max(1, -(-nb // 4096))


def _refined(cg, matvec, RHS, refine):
    """``cg(RHS)``'s (X, trips), then ``refine`` rounds of iterative
    refinement: each solves the residual RHS − A·X, formed with the
    operator's own product, by ``cg`` again and adds the correction, so
    the exit floor bounds each round's residual relative to the last."""
    X, it = cg(RHS)
    for _ in range(refine):
        dX, more = cg(RHS - matvec(X))
        X, it = X + dX, it + more
    return X, it


def make_committed_solver(kernel_fn, nb, B, *, cg_iters=96, solver_dtype=None,
                          precond_width=1, cg_tol=None, row_chunk=None,
                          mesh=None, halo_S=None,
                          precond_type="block_jacobi", coarse_width=None):
    """Committed-state WIDE solve (K+V)⁻¹ RHS, on one device or a mesh:

        assemble(hps, rows, cols, xb, mask, noise_diag_pad) -> (tiles, pdata)
        solve(tiles, pdata, rows, cols, noise_diag_pad, RHS[, *plan],
              refine=0) -> (X, iters)

    ``assemble`` runs once per committed state; ``solve`` once per column
    chunk, with ``refine`` rounds of iterative refinement after its CG
    (``_refined``).  The CG drops the columns that have met its exit floor
    (``_cg_fixed(compact=True)``), so a solve costs its columns' own
    trips, not the slowest column's trips times the width.
    ``precond_type`` is ``"block_jacobi"`` (pdata = the batched
    block inverses) or ``"two_level"`` / ``"amg"`` (pdata = (block inverses,
    the coarse inverse of ``_coarse_inverse``), ``coarse_width`` blocks per
    coarse aggregate, default sized so the coarse grid stays at most 4096).
    The mBCG training solver cannot use the two-level operator: its
    quadrature needs probes z = L_M·u and an exact log|M|, which a
    block-diagonal M gives and the two-level one does not.

    ``rows``/``cols`` arrive UNCLAMPED (sentinel == nb) and ROW-SORTED.
    With ``row_chunk`` set, ``solve``'s ``rows`` is the per-chunk row index
    of ``row_aligned_schedule`` and the SpMM is the fused K2 path
    (float32/bfloat16 only); otherwise wide right-hand sides stream the
    tiles through ``_spmv_scan`` and narrow ones take the flat SpMM (K1 on
    the card).  Padded rows carry unit noise and zero RHS, so their
    solution is exactly zero.

    MESH PATH (``mesh`` with more than one rank): the training step's
    design.  ``rows``/``cols`` are the rank's segment of a partitioned
    schedule (row-sorted, sentinels at its tail); ``noise_diag_pad`` and
    ``RHS`` (and X) the rank's W·B rows.  Each rank assembles its own tiles
    and preconditioner blocks; the matvec is the mesh SpMM of
    ``_spmv_for(nb, B, mesh, halo_S)`` (K1 on the rank's rows; K2 is off
    this path, as in the JAX package), whose halo form takes ``solve``'s
    ``cols`` remapped and the rank's plan rows after RHS; the CG's inner
    products reduce over the ranks, and the two-level coarse matrix is the
    sum of the ranks' shares.  ``row_chunk`` cannot combine with a mesh."""
    n_dev = tile_device_count(mesh) if mesh is not None else 1
    if n_dev <= 1:
        mesh = halo_S = None
    if mesh is not None:
        if row_chunk is not None:
            raise ValueError("make_committed_solver: row_chunk (the fused "
                             "single-device SpMM) cannot combine with a mesh")
        if nb % n_dev:
            raise ValueError(
                f"make_committed_solver(mesh=...): nb ({nb}) must be a "
                f"multiple of the mesh size ({n_dev}); pad the point "
                "blocking (make_padded_inputs(..., row_multiple=n_dev))")
    flat_spmv = _spmv_for(nb, B, mesh, mv_dtype=solver_dtype, halo_S=halo_S)
    row0 = flat_tile_index(mesh) * (nb // n_dev) if mesh is not None else 0
    reduce = flat_spmv.reduce if mesh is not None else None
    ptype = _normalize_committed_precond(precond_type)
    cw = _coarse_width(nb, coarse_width) if ptype == "two_level" else None

    def m_for(pdata):
        if ptype == "two_level":
            return lambda X: _two_level_apply(pdata, X, B, cw, row0, reduce)
        return lambda X: _block_apply(pdata, X)

    def run_cg(matvec, pdata, RHS, refine):
        def cg(rhs):
            return _cg_fixed(matvec, rhs, cg_iters, M=m_for(pdata),
                             tol=cg_tol, mv_dtype=solver_dtype,
                             with_iters=True, reduce=reduce, compact=True)

        with torch.no_grad():
            return _refined(cg, matvec, RHS, refine)

    def assemble(hps, rows, cols, xb, mask, noise_diag_pad):
        with torch.no_grad():
            rows_c = torch.clamp(rows, max=nb - 1)
            cols_c = torch.clamp(cols, max=nb - 1)
            # row-aligned schedules pad WITHIN rows using a column sentinel
            # (row real, col == nb) — zero those tiles too
            live = (rows < nb) & (cols < nb)
            tiles = _assemble_chunked_tiles(kernel_fn, B, solver_dtype, hps,
                                            rows_c, cols_c, live, xb, mask)
            Minv, _ = _diag_precond_blocks(kernel_fn, B, precond_width, hps,
                                           xb, mask, noise_diag_pad, i0=row0)
            if ptype == "two_level":
                return tiles, (Minv, _coarse_inverse(
                    tiles, rows, cols, noise_diag_pad, nb, B, cw, row0,
                    reduce))
        return tiles, Minv

    if mesh is not None:
        def mesh_solve(tiles, pdata, rows, cols, noise_diag_pad, RHS, *halo,
                       refine=0):
            # all-gather: global columns, the sentinels clamped (their tiles
            # are zero); halo: the remapped columns are in range
            mv_cols = cols if halo_S is not None \
                else torch.clamp(cols, max=nb - 1)

            def matvec(X):
                return (flat_spmv(rows, mv_cols, tiles, X, *halo)
                        + noise_diag_pad[:, None] * X)

            return run_cg(matvec, pdata, RHS, refine)

        return assemble, mesh_solve

    def solve(tiles, pdata, rows, cols, noise_diag_pad, RHS, refine=0):
        if row_chunk is not None and RHS.dtype == torch.float64:
            raise ValueError(
                "make_committed_solver(row_chunk=...): the fused row-aligned "
                "SpMM accumulates in float32 — float64 solves must keep "
                "row_chunk=None")
        cols_c = torch.clamp(cols, max=nb - 1)
        c = RHS.shape[1]
        acc_bytes = 8 if RHS.dtype == torch.float64 else 4
        wide = cols.shape[0] * B * c * acc_bytes * 2 > _SPMV_FLAT_BUDGET

        def matvec(X):
            if row_chunk is not None:
                out = _spmv_scan_fused(rows, cols, tiles, X, nb, B,
                                       C=row_chunk, mv_dtype=solver_dtype)
            elif wide:
                out = _spmv_scan(rows, cols_c, tiles, X, nb, B,
                                 mv_dtype=solver_dtype)
            else:
                out = flat_spmv(rows, cols_c, tiles, X)
            return out + noise_diag_pad[:, None] * X

        return run_cg(matvec, pdata, RHS, refine)

    return assemble, solve


def make_padded_inputs(x, y, noise_diag, block_size, dtype=torch.float32,
                       row_multiple=1, device="cuda"):
    """Host helper: pad (x, y, noise) to full blocks and build masks, as
    tensors on ``device`` (the card unless asked) in ``dtype`` (a torch or
    numpy dtype, or its name).  Padded noise is 1.0 (keeps K+V PD on
    padded rows).  ``row_multiple`` rounds the block count up."""
    dtype = config.as_torch_dtype(dtype)
    import numpy as np
    n, d = x.shape
    nb = -(-n // block_size)
    nb = -(-nb // row_multiple) * row_multiple
    n_pad = nb * block_size
    xb = np.zeros((n_pad, d))
    xb[:n] = x
    mask = np.zeros(n_pad)
    mask[:n] = 1.0
    y_pad = np.zeros(n_pad)
    y_pad[:n] = y
    noise_pad = np.ones(n_pad)
    noise_pad[:n] = noise_diag

    def t(a):
        return torch.as_tensor(a, dtype=dtype).to(device)

    return (t(xb.reshape(nb, block_size, d)), t(mask.reshape(nb, block_size)),
            t(y_pad), t(mask), t(noise_pad))
