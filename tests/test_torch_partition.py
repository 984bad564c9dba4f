"""The port's partition plans (``fvgp_tpu_torch/parallel/partition.py``, a
numpy copy) against the JAX package's on the JAX suite's cases
(``tests/test_scale.py``): every integer equal, no process group needed.
``choose_halo`` reads only ``mesh.shape``, so both packages get a stand-in
with a 1-D or a 2 × 4 shape."""

import types

import numpy as np
import pytest

import fvgp_tpu.parallel.partition as JP
import fvgp_tpu_torch.parallel.partition as TP
from fvgp_tpu.parallel.ordering import morton_order
from fvgp_tpu.parallel.sharded_cov import _candidate_pairs


def _equal(a, b):
    """Equal outputs: arrays element for element and of one dtype, dicts
    key for key, tuples item for item."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _equal(u, v)
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _random_schedule(seed, nb, T):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, nb, T).astype(np.int32),
            rng.integers(0, nb, T).astype(np.int32))


def _morton_schedule(n=8000, B=64, n_dev=8):
    """The mirrored candidate schedule of Morton-ordered points
    (``test_partition_balance_morton``)."""
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 60, (n, 2))
    x = x[morton_order(x)]
    rows, cols = _candidate_pairs(x, None, np.array([2.0, 2.0]), 1.0, B,
                                  symmetric=True)
    off = rows < cols
    rows_f = np.concatenate([rows, cols[off]])
    cols_f = np.concatenate([cols, rows[off]])
    nb = -(-(-(-n // B)) // n_dev) * n_dev
    return rows_f, cols_f, nb, B


def _clustered_schedule():
    """Tiles concentrated where the points cluster: the equal split is
    unbalanced, so ``tile_balanced_layout`` engages."""
    rng = np.random.default_rng(2)
    x = np.concatenate([rng.uniform(0, 10, (3000, 2)),
                        rng.uniform(0, 60, (1000, 2))])
    x = x[morton_order(x)]
    rows, cols = _candidate_pairs(x, None, np.array([1.5, 1.5]), 1.0, 32,
                                  symmetric=True)
    off = rows < cols
    return (np.concatenate([rows, cols[off]]).astype(np.int32),
            np.concatenate([cols, rows[off]]).astype(np.int32),
            -(-4000 // 32))


@pytest.mark.parametrize("nb,n_dev", [(24, 8), (25, 8), (7, 4), (1, 1)])
def test_local_row_blocks(nb, n_dev):
    assert TP.local_row_blocks(nb, n_dev) == JP.local_row_blocks(nb, n_dev)


@pytest.mark.parametrize("case", ["ownership", "pad_to", "morton"])
def test_partition_schedule(case):
    """``test_partition_schedule_ownership`` (nb 24 over 8), a pinned
    per-device count, and the Morton case."""
    kw = {}
    if case == "morton":
        rows, cols, nb, _ = _morton_schedule()
        n_dev = 8
    else:
        rows, cols = _random_schedule(0, 24, 200)
        nb, n_dev = 24, 8
        if case == "pad_to":
            kw["pad_to"] = 64
    _equal(TP.partition_schedule(rows, cols, nb, n_dev, **kw),
           JP.partition_schedule(rows, cols, nb, n_dev, **kw))


def test_schedule_stats_on_morton_points():
    """``test_partition_balance_morton``: the ownership and volume
    diagnostics of the partitioned Morton schedule."""
    rows, cols, nb, B = _morton_schedule()
    rp, cp, _, _ = TP.partition_schedule(rows, cols, nb, 8)
    got = TP.schedule_stats(rp, cp, nb, 8, B, n_rhs=17)
    _equal(got, JP.schedule_stats(rp, cp, nb, 8, B, n_rhs=17))
    assert got["balance"] < 1.5


@pytest.mark.parametrize("width", [None, 48])
def test_tile_balanced_layout_apply_and_permute(width):
    """The balanced layout of a clustered schedule, its remapped schedule
    and the permuted block arrays (pad value 1 as for the noise)."""
    rows, cols, nb = _clustered_schedule()
    t_layout, t_W = TP.tile_balanced_layout(rows, nb, 4, width=width)
    j_layout, j_W = JP.tile_balanced_layout(rows, nb, 4, width=width)
    assert t_layout is not None
    _equal((t_layout, t_W), (j_layout, j_W))
    _equal(TP.apply_block_layout(t_layout, rows, cols, nb),
           JP.apply_block_layout(j_layout, rows, cols, nb))
    arr = np.random.default_rng(1).standard_normal((nb, 32))
    _equal(TP.permute_blocked(t_layout, arr, pad_value=1.0),
           JP.permute_blocked(j_layout, arr, pad_value=1.0))


def test_tile_balanced_layout_declines_a_balanced_split():
    rows, _, nb, _ = _morton_schedule()
    _equal(TP.tile_balanced_layout(rows, nb, 8),
           JP.tile_balanced_layout(rows, nb, 8))


@pytest.mark.parametrize("bucket", [1, 8])
def test_halo_plan(bucket):
    """``test_halo_plan_covers_all_references`` (nb 32 over 8)."""
    rows, cols = _random_schedule(3, 32, 300)
    rp, cp, _, _ = TP.partition_schedule(rows, cols, 32, 8)
    _equal(TP.halo_plan(rp, cp, 32, 8, bucket=bucket),
           JP.halo_plan(rp, cp, 32, 8, bucket=bucket))


@pytest.mark.parametrize("bucket", [1, 8])
def test_halo_plan_hier(bucket):
    """``test_halo_plan_hier_structure`` (nb 32 on 2 × 4)."""
    rows, cols = _random_schedule(5, 32, 300)
    rp, cp, _, _ = TP.partition_schedule(rows, cols, 32, 8)
    _equal(TP.halo_plan_hier(rp, cp, 32, 2, 4, bucket=bucket),
           JP.halo_plan_hier(rp, cp, 32, 2, 4, bucket=bucket))


def test_dcn_split():
    """``test_dcn_split_diagnostic``."""
    n_dev, per_slice, S, W = 8, 4, 16, 100
    stats = {"S": S, "halo_words": n_dev * (n_dev - 1) * S,
             "allgather_words": n_dev * (n_dev - 1) * W}
    send_mask = np.zeros((n_dev, n_dev, S), np.float32)
    send_mask[0, 5, :3] = 1.0
    send_mask[0, 1, :7] = 1.0
    _equal(TP.dcn_split(stats, n_dev, per_slice, send_mask=send_mask),
           JP.dcn_split(stats, n_dev, per_slice, send_mask=send_mask))
    with pytest.raises(ValueError):
        TP.dcn_split(stats, 8, 3)


@pytest.mark.parametrize("shape", [{"tiles": 8}, {"slice": 2, "tiles": 4}])
@pytest.mark.parametrize("halo_mode", ["auto", "on", "hier", "off"])
def test_choose_halo(shape, halo_mode):
    """The shared cost model on a banded schedule (every rank references a
    few foreign blocks) over a 1-D and a 2 × 4 mesh."""
    nb = 64
    rows = np.repeat(np.arange(nb), 5)
    cols = np.clip(rows + np.tile(np.arange(-2, 3), nb), 0, nb - 1)
    rp, cp, _, _ = TP.partition_schedule(rows.astype(np.int32),
                                         cols.astype(np.int32), nb, 8)
    mesh = types.SimpleNamespace(shape=dict(shape))
    got = TP.choose_halo(rp, cp, nb, mesh, halo_mode=halo_mode)
    ref = JP.choose_halo(rp, cp, nb, mesh, halo_mode=halo_mode)
    _equal(got, ref)
    if halo_mode == "hier" and "slice" in shape:
        assert got["engaged"] == "hier"
