"""The gp2Scale tile schedules, bit for bit: digests of every schedule the
marginal likelihood and the committed posterior solver build on one seeded
CPU dataset (N = 3,000, B = 64) — the LML's padded schedule at the
hyperparameters and inside the drift band, the committed solver's
row-aligned and plain schedules, and each rank's segment, halo size and
remapped columns on 4 ranks under the flat halo, read on one process
through a stand-in mesh (no process group).  The digests were recorded
before the structure pass moved into ``parallel/tile_structure.py``: a
change that reorders or pads a schedule differently fails here."""

import hashlib
import warnings

import numpy as np
import pytest
import torch

import fvgp_tpu_torch.ops.sparse_lml as SL
from fvgp_tpu_torch import GP
from fvgp_tpu_torch.parallel.mesh import use_mesh
from fvgp_tpu_torch.parallel.tile_structure import rank_partition

N, D, B = 3000, 3, 64
HPS = np.array([1.0, 2.0, 2.0, 2.0])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (the suite's parallel
    workers would oversubscribe the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Rank:
    """Rank ``rank`` of a 1-D mesh of 4: what the host structure pass
    reads of a mesh, without a process group."""

    shape = {"tiles": 4}
    ranks_per_device = 1
    device = torch.device("cpu")

    def __init__(self, rank):
        self.rank = rank


def _digest(*arrays):
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a.numpy() if torch.is_tensor(a) else a)
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def _gp(**args):
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 18, (N, D))
    y = np.sin(0.5 * x[:, 0]) + 0.05 * rng.standard_normal(N)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return GP(x, y, init_hyperparameters=HPS,
                  noise_variances=np.full(N, 1e-2), gp2Scale=True,
                  compute_device="cpu", linalg_mode="sparseCGpre",
                  args={"gp2Scale_block_size": B,
                        "gp2Scale_structure_cache_dir": False, **args})


def _lml_run(gp, hps):
    ml = gp.marginal_likelihood
    return ml._sparse_structure(hps, ml._sparse_settings())[1]


def _spy(monkeypatch, name):
    """Record the ``halo_S`` that ``sparse_lml.<name>`` is built with."""
    seen = []
    real = getattr(SL, name)

    def spy(*a, **k):
        seen.append(k.get("halo_S"))
        return real(*a, **k)
    monkeypatch.setattr(SL, name, spy)
    return seen


DIGESTS = {
    "lml": "3100e058da3a41c7",
    # inside the drift band the known-dead tiles stay dropped: the schedule
    # at the reference lengthscales
    "lml_drifted": "3100e058da3a41c7",
    "lml_moved": "a428925acb7cb89f",
    "committed_plain": "e7849f3de76a878b",
    "committed_fused": "bfa2ed66773624c7",
    "lml_rank": (["c85a84fb386590ce", "6618ad77923151fb", "0aac18ba14838af8",
                  "bcc9540c8a3d3322"], [16] * 4),
    "committed_rank": (["ad2003a757c23a91", "a6fdc3183e5fc4ed",
                        "10d8f11d9e4d6f44", "863460215f3e1674"], [16] * 4),
}


def test_single_device_schedules():
    gp = _gp()
    got = {"lml": _digest(*_lml_run(gp, HPS)["static"][:2]),
           "lml_drifted": _digest(
               *_lml_run(gp, HPS * np.array([1, 0.96, 0.97, 1.04]))
               ["static"][:2]),
           "lml_moved": _digest(
               *_lml_run(gp, HPS * np.array([1, 0.9, 0.9, 0.9]))
               ["static"][:2])}
    ctx = gp.kv._fast_sparse_solver()
    got["committed_plain"] = _digest(ctx["arows"], ctx["cols"], ctx["rows"])
    ctx = _gp(dtype="float32").kv._fast_sparse_solver()
    got["committed_fused"] = _digest(ctx["arows"], ctx["cols"], ctx["rows"])
    assert got == {k: DIGESTS[k] for k in got}


def test_rank_segments_under_the_flat_halo(monkeypatch):
    lml_S = _spy(monkeypatch, "make_sparse_lml")
    com_S = _spy(monkeypatch, "make_committed_solver")
    lml, com = [], []
    for r in range(4):
        gp = _gp(gp2Scale_halo_exchange="on")
        with use_mesh(_Rank(r)):
            run = _lml_run(gp, HPS)
            ctx = gp.kv._fast_sparse_solver()
        lml.append(_digest(*run["static"][:2], *run["halo"]))
        com.append(_digest(ctx["arows"], ctx["cols"], ctx["scols"],
                           *ctx["halo_args"]))
    got = {"lml_rank": (lml, lml_S), "committed_rank": (com, com_S)}
    assert got == {k: DIGESTS[k] for k in got}


def test_the_partition_function_gives_each_rank_its_segment():
    """``rank_partition`` on the structure alone, with no model's program
    around it, gives the committed solver's segments above (the LML's run
    on its tile-balanced block layout, which permutes the structure
    first)."""
    gp = _gp(gp2Scale_halo_exchange="on")
    tiles = gp.data.tile_structure
    rows, cols = tiles.exact(*tiles.support(gp.prior, HPS), B)
    nb = -(-N // B // 4) * 4
    com, halo_S = [], []
    for r in range(4):
        part = rank_partition(rows, cols, nb, B, _Rank(r), gp.args,
                              torch.float64, torch.device("cpu"))
        com.append(_digest(part["rows"], part["cols"], part["cols_remap"],
                           *part["plan"]))
        halo_S.append(part["halo_S"])
    assert (com, halo_S) == DIGESTS["committed_rank"]


def test_training_shares_the_committed_structure():
    """The training pass's filtered structure at the committed
    hyperparameters is the one the committed solver computes itself."""
    gp = _gp()
    _lml_run(gp, HPS)
    tiles = gp.data.tile_structure
    ls, radius = tiles.support(gp.prior, HPS)
    shared = tiles.exact(ls, radius, B)
    tiles.clear()
    own = tiles.exact(ls, radius, B)
    assert own[0] is not shared[0]
    for a, b in zip(shared, own):
        np.testing.assert_array_equal(a, b)
