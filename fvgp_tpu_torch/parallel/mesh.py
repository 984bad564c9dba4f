"""Process-group mesh — the communication backend of the scale path
(counterpart of ``fvgp_tpu/parallel/mesh.py``).

The JAX package drives an n-device mesh from one process (``shard_map``).
The port is SPMD over ``torch.distributed``: each rank is one process with
one device, launched by ``torchrun`` (or spawned), every rank builds the
same model from the same replicated points and returns the same LML,
gradient and posterior.  A :class:`Mesh` is a process group plus its shape,
``{"tiles": n}`` or ``{"slice": ns, "tiles": ps}``: ``slice`` is the node
(traffic between nodes takes the place of the TPU's DCN, the link within a
node that of ICI), and the flat rank is slice-major, so ``choose_halo`` and
the partition code read ``mesh.shape`` and :func:`tile_device_count`
unchanged.

Collectives, each with its autograd rule (every rank seeds the same
cotangent of a replicated loss, so a rule that sums twice would give
``n`` times the gradient):

* :func:`replicate` — forward identity, backward all-reduce: the transpose
  of a replicated input whose uses are rank-local work.
* :func:`global_sum` — forward all-reduce, backward identity.
* :func:`gather_rows` — all-gather of equal row blocks; backward: this
  rank's rows of the all-reduced cotangent.
* :func:`exchange_blocks` — ``all_to_all_single`` with equal splits; its
  transpose is the same exchange of the cotangent.

Host-side agreement, without autograd: :func:`rank_values` (one host
number from every rank, the same array on each), :func:`all_agree` and
:func:`sync_host_random` (rank 0's numpy global random state on every
rank, so host draws — MCMC proposals and accept tests, random starts —
are the same everywhere).  :func:`owned_rows` is a rank's contiguous range
of row blocks, the ownership of the stored ``BlockSparseMatrix`` and of the
partitioned schedules.

On the card's torch (2.11) gloo takes all four on CUDA tensors (measured:
all-reduce, all-gather, all-to-all, broadcast and reduce-scatter), so no
operation is staged through host memory.  NCCL refuses two ranks on one
card; gloo does not.
"""

import collections
import contextlib
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "make_mesh_2d", "tile_axes",
           "tile_device_count", "flat_tile_index", "set_mesh",
           "current_mesh", "use_mesh", "shard_tiles", "replicate",
           "global_sum", "gather_rows", "exchange_blocks", "all_agree",
           "owned_rows", "rank_values", "sync_host_random"]

_ACTIVE_MESH = None

TILE_AXIS = "tiles"
SLICE_AXIS = "slice"


class Mesh:
    """A process group, its shape, this rank's device and the sub-groups
    of a 2-D mesh.

    ``group`` spans every rank of the mesh in flat (slice-major) order;
    ``tiles_group`` is this rank's slice (the whole group on a 1-D mesh),
    ``slice_group`` the ranks of every slice at this rank's tiles
    coordinate (None on a 1-D mesh).  ``ranks_per_device`` is how many of
    the node's ranks share this rank's card (gloo places them round-robin;
    they share its memory).  ``ops`` counts the collectives this rank
    issued, by name."""

    def __init__(self, group, shape, device, tiles_group=None,
                 slice_group=None):
        self.group = group
        self.shape = dict(shape)
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group))
        self.device = torch.device(device)
        self.ranks_per_device = 1
        if self.device.type == "cuda":
            local = _env_int("LOCAL_WORLD_SIZE") or self.size
            self.ranks_per_device = -(-local // torch.cuda.device_count())
        self.tiles_group = tiles_group if tiles_group is not None else group
        self.slice_group = slice_group
        self.ops = collections.Counter()

    def __repr__(self):
        return (f"Mesh(shape={self.shape}, rank={self.rank}, "
                f"backend={self.backend!r}, device={self.device})")


def _env_int(name):
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def _init_default_group(backend):
    """The default process group from the ``torchrun`` environment (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT), or a one-rank world on an
    in-process store where that environment is absent."""
    if backend == "nccl":
        torch.cuda.set_device(_env_int("LOCAL_RANK") or 0)
    if _env_int("WORLD_SIZE") is None:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    else:
        dist.init_process_group(backend)


def _rank_device(backend, local_rank):
    """This rank's device: the card of its local rank (shared round-robin
    under gloo, where several ranks may sit on one card; NCCL needs one card
    per rank), or the CPU under gloo on a machine without one."""
    if backend == "nccl":
        return torch.device("cuda", local_rank)
    if torch.cuda.is_available():
        return torch.device("cuda", local_rank % torch.cuda.device_count())
    return torch.device("cpu")


def _slice_groups(n):
    """Flat ranks grouped by node, outer mesh axis first, or None without
    a visible node structure.  ``FVGP_TPU_ASSUME_SLICES=k`` splits the ranks
    into k equal slices (the documented way to exercise the 2-D layout on
    one node); otherwise the node is read from ``LOCAL_WORLD_SIZE``
    (``torchrun`` numbers each node's ranks contiguously)."""
    k = int(os.environ.get("FVGP_TPU_ASSUME_SLICES", "0") or 0)
    if k > 1:
        if n % k:
            raise ValueError(f"FVGP_TPU_ASSUME_SLICES={k} does not divide "
                             f"{n} ranks")
        per = n // k
        return [list(range(i * per, (i + 1) * per)) for i in range(k)]
    lws = _env_int("LOCAL_WORLD_SIZE")
    if lws and n % lws == 0 and n // lws > 1:
        return [list(range(i * lws, (i + 1) * lws)) for i in range(n // lws)]
    return None


def make_mesh(n_devices=None, layout="auto", backend=None, group=None,
              timeout=None):
    """A mesh over every rank of ``group`` (default: the world).

    Initialises the default group from the ``torchrun`` environment when
    none exists (a one-rank world without that environment).  ``backend``
    defaults to ``"nccl"`` on a machine with a card; ``"gloo"`` is taken
    only when asked for (on a machine without a card it must be).
    ``n_devices``, where given, must be the group's size: every rank of a
    process group takes part in its collectives.  ``layout="auto"`` gives a
    2-D ``(slice, tiles)`` mesh when the ranks span more than one node of
    equal size, ``"1d"`` the flat mesh, ``"2d"`` the 2-D one or raises
    where no node structure is visible.  ``timeout`` (seconds) bounds every
    collective of a group this call creates."""
    if layout not in ("auto", "1d", "2d"):
        raise ValueError(f"unknown mesh layout {layout!r}; use 'auto', '1d' "
                         "or '2d'")
    if not dist.is_initialized():
        if backend is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "make_mesh: no CUDA card on this machine; pass "
                    "backend='gloo' to build a mesh of CPU processes")
            backend = "nccl"
        _init_default_group(backend)
    group = group if group is not None else dist.group.WORLD
    actual = str(dist.get_backend(group))
    if backend is not None and backend != actual:
        raise ValueError(f"make_mesh: the process group runs {actual!r}, "
                         f"not {backend!r}")
    n = dist.get_world_size(group)
    if n_devices is not None and int(n_devices) != n:
        raise ValueError(f"make_mesh: n_devices={n_devices} but the process "
                         f"group has {n} ranks")
    if layout != "1d":
        groups = _slice_groups(n)
        if groups is not None and len(groups) > 1 \
                and len({len(g) for g in groups}) == 1:
            return make_mesh_2d(len(groups), len(groups[0]), group=group,
                                timeout=timeout)
        if layout == "2d":
            raise ValueError(
                "layout='2d' but the ranks expose no (equal-sized) node "
                "structure; run under torchrun on several nodes, call "
                "make_mesh_2d, or set FVGP_TPU_ASSUME_SLICES")
    local = _env_int("LOCAL_RANK")
    device = _rank_device(actual, dist.get_rank(group) if local is None
                          else local)
    return Mesh(group, {TILE_AXIS: n}, device)


def make_mesh_2d(n_slices, per_slice, group=None, timeout=None):
    """A 2-D ``(slice, tiles)`` mesh: ``n_slices`` slices of ``per_slice``
    consecutive ranks of ``group`` (default: the world, which must exist).
    Builds the two families of sub-groups with ``dist.new_group``; every
    rank creates every sub-group, in the same order."""
    group = group if group is not None else dist.group.WORLD
    n = dist.get_world_size(group)
    if n != n_slices * per_slice:
        raise ValueError(f"need {n_slices * per_slice} ranks, got {n}")
    ranks = dist.get_process_group_ranks(group)
    backend = str(dist.get_backend(group))
    kw = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=float(timeout))}
    me = dist.get_rank(group)
    tiles_group = slice_group = None
    for s in range(n_slices):
        g = dist.new_group([ranks[s * per_slice + t]
                            for t in range(per_slice)], backend=backend, **kw)
        if me // per_slice == s:
            tiles_group = g
    for t in range(per_slice):
        g = dist.new_group([ranks[s * per_slice + t]
                            for s in range(n_slices)], backend=backend, **kw)
        if me % per_slice == t:
            slice_group = g
    local = _env_int("LOCAL_RANK")
    device = _rank_device(backend, me if local is None else local)
    return Mesh(group, {SLICE_AXIS: n_slices, TILE_AXIS: per_slice}, device,
                tiles_group=tiles_group, slice_group=slice_group)


def tile_axes(mesh):
    """The mesh axes a row/tile-sharded array spans, outer first."""
    return tuple(n for n in (SLICE_AXIS, TILE_AXIS) if n in mesh.shape)


def tile_device_count(mesh):
    """Number of ranks in the (flattened) tile sharding."""
    n = 1
    for a in tile_axes(mesh):
        n *= int(mesh.shape[a])
    return n


def flat_tile_index(mesh):
    """This rank's index in the flattened tile order (slice-major)."""
    return mesh.rank


def set_mesh(mesh):
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def current_mesh():
    return _ACTIVE_MESH


@contextlib.contextmanager
def use_mesh(mesh):
    global _ACTIVE_MESH
    prev = _ACTIVE_MESH
    _ACTIVE_MESH = mesh
    try:
        yield mesh
    finally:
        _ACTIVE_MESH = prev


def owned_rows(nb, mesh):
    """``(r0, W)``: this rank owns row blocks ``[r0, min(r0 + W, nb))`` of
    an ``nb``-block grid, ``W = partition.local_row_blocks(nb, n)`` — the
    JAX package's contiguous ownership (the last ranks may own fewer
    blocks, or none).  One rank, or no mesh: ``(0, nb)``."""
    if mesh is None or mesh.size == 1:
        return 0, int(nb)
    from .partition import local_row_blocks
    W = local_row_blocks(int(nb), tile_device_count(mesh))
    return flat_tile_index(mesh) * W, W


def shard_tiles(bsm, mesh=None):
    """This rank's segment of a BlockSparseMatrix's tile list, whose length
    is a multiple of the rank count (the JAX package shards the same list
    over its devices)."""
    from .block_sparse import BlockSparseMatrix
    mesh = mesh or current_mesh()
    if mesh is None or mesh.size == 1:
        return bsm
    T = bsm.tiles.shape[0]
    if T % mesh.size:
        raise ValueError(f"shard_tiles: {T} tiles do not split over "
                         f"{mesh.size} ranks")
    per = T // mesh.size
    seg = slice(mesh.rank * per, (mesh.rank + 1) * per)
    return BlockSparseMatrix(bsm.n, bsm.n_cols, bsm.block_size,
                             bsm.rows[seg], bsm.cols[seg], bsm.tiles[seg],
                             diag=bsm.diag, device=bsm.tiles.device)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _all_reduce(t, mesh, group=None, op=dist.ReduceOp.SUM):
    out = t.detach().clone().contiguous()
    dist.all_reduce(out, op=op, group=group or mesh.group)
    mesh.ops["all_reduce"] += 1
    return out


def _all_gather(t, mesh):
    t = t.detach().contiguous()
    out = torch.empty((mesh.size * t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    dist.all_gather(list(out.chunk(mesh.size)), t, group=mesh.group)
    mesh.ops["all_gather"] += 1
    return out


def _all_to_all(t, mesh, group):
    t = t.detach().contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    mesh.ops["all_to_all"] += 1
    return out


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh), None


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        return _all_reduce(t, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh, ctx.rows = mesh, t.shape[0]
        return _all_gather(t, mesh)

    @staticmethod
    def backward(ctx, g):
        r0 = ctx.mesh.rank * ctx.rows
        return _all_reduce(g, ctx.mesh)[r0:r0 + ctx.rows], None


class _ExchangeBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, group):
        ctx.mesh, ctx.group = mesh, group
        return _all_to_all(t, mesh, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.mesh, ctx.group), None, None


def replicate(t, mesh=None):
    """``t`` itself; its cotangent is summed over the mesh.  Pass a
    replicated tensor (hyperparameters, points) through this where it
    enters rank-local work."""
    mesh = mesh or current_mesh()
    if mesh is None or mesh.size == 1:
        return t
    return _Replicate.apply(t, mesh)


def global_sum(t, mesh=None):
    """The sum of ``t`` over the mesh's ranks (each holds a partial sum);
    the cotangent passes through unchanged."""
    mesh = mesh or current_mesh()
    if mesh is None or mesh.size == 1:
        return t
    return _GlobalSum.apply(t, mesh)


def gather_rows(t, mesh=None):
    """The ranks' equal row blocks of ``t`` stacked in rank order."""
    mesh = mesh or current_mesh()
    if mesh is None or mesh.size == 1:
        return t
    return _GatherRows.apply(t, mesh)


def exchange_blocks(t, group=None, mesh=None):
    """All-to-all over ``group`` (default: the mesh's): the leading axis of
    ``t`` splits into the group's size of equal chunks, chunk j goes to
    group rank j, and chunk i of the result came from group rank i."""
    mesh = mesh or current_mesh()
    return _ExchangeBlocks.apply(t, mesh, group or mesh.group)


def rank_values(value, mesh=None):
    """A host number (or a short 1-d sequence) from every rank, as a numpy
    array with one row per rank in rank order, the same on every rank (one
    all-gather).  A sum or a maximum taken from it is the same bits on
    every rank."""
    mesh = mesh or current_mesh()
    v = torch.as_tensor(np.atleast_1d(np.asarray(value)),
                        dtype=torch.float64)
    if mesh is None or mesh.size == 1:
        return v.numpy()[None]
    out = _all_gather(v[None].to(mesh.device), mesh)
    return out.cpu().numpy()


def sync_host_random(mesh=None):
    """Every rank takes rank 0's numpy global random state (one broadcast),
    so what the ranks draw from it next is the same on each: an MCMC
    proposal and its accept test, a random start inside the bounds.
    Without it each rank, a process of its own, draws from its own state,
    the ranks propose different hyperparameters and enter the LML's
    collectives with different structures.  Nothing happens with one rank
    or no mesh."""
    mesh = mesh or current_mesh()
    if mesh is None or mesh.size == 1:
        return
    state = [np.random.get_state() if mesh.rank == 0 else None]
    dist.broadcast_object_list(
        state, src=dist.get_global_rank(mesh.group, 0), group=mesh.group,
        device=mesh.device if mesh.backend == "nccl" else None)
    mesh.ops["broadcast"] += 1
    np.random.set_state(state[0])


def all_agree(ok, mesh=None):
    """True on every rank when ``ok`` is true on every rank (one
    all-reduce): a decision that all ranks must take together, such as a
    retreat after one rank ran out of memory."""
    mesh = mesh or current_mesh()
    if mesh is None or mesh.size == 1:
        return bool(ok)
    flag = torch.tensor([0.0 if ok else 1.0], device=mesh.device)
    return float(_all_reduce(flag, mesh).item()) == 0.0
