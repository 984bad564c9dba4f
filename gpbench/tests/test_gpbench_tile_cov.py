"""tile_cov_roofline and its count: the bytes of K5 on a hand-made case,
and the reader on synthetic kernel events, with and without K5."""

import importlib
from types import SimpleNamespace

import pytest
from gpbench_toy import REPO, spec


def _count():
    return importlib.import_module("gpbench.counts.tile_cov")


def test_tile_cov_hand_count():
    tc = _count()
    # 3 live tiles of 8x8: the forward writes and the VJP reads 3·64 values
    assert tc.step_bytes(3, 8, "float32") == 2 * 3 * 64 * 4
    assert tc.step_bytes(3, 8, "bfloat16") == 2 * 3 * 64 * 2
    assert tc.bound_s(3, 8, "float32") == pytest.approx(2 * 3 * 64 * 4
                                                        / 3.35e12)


def test_tile_cov_bound_at_the_cell_shape():
    """219,631 float32 tiles of 128²: 14.4 GB written and as many read,
    4.3 ms each at 3.35 TB/s."""
    t = _count().bound_s(219_631, 128, "float32")
    assert 8.5e-3 < t < 8.7e-3


class _Structure:
    def __init__(self):
        self.seen = []

    def live_tiles(self, h):
        self.seen.append(list(h))
        return 1000


def _ctx(kernels, dtype=None):
    args = {"gp2Scale_block_size": 128}
    if dtype:
        args["gp2Scale_solver_dtype"] = dtype
    requests = [{"h": [1.0, 2.0, 2.0, 2.0]}, {"h": [1.0, 2.1, 2.0, 1.9]}]
    return SimpleNamespace(
        config={"gp": {"args": args}}, count=spec(REPO).count,
        reference=_Structure(),
        profile={"kernels": kernels, "requests": requests,
                 "counters": [{}, {}]})


def _reader():
    return spec(REPO).metric("tile_cov_roofline")


def test_reader_gives_nothing_without_k5():
    """The parent's trace: the chunked assembly's generic kernels, K1 and
    K3, none of them K5's."""
    ctx = _ctx([("void at::native::vectorized_elementwise_kernel<4>", 0, 9),
                ("void segment_mma_kernel<float, float>", 10, 20),
                ("void dense_cov_kernel<float, 1, 3, true>", 20, 30)])
    assert _reader().read(ctx) is None
    assert ctx.reference.seen == []


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_reader_share_on_synthetic_events(dtype):
    """Two steps: the bound of each step's live tiles over the time of
    every kernel named ``tile_cov``, and of no other."""
    fwd, vjp = 4_000_000, 6_000_000           # ns
    kernels = [("void (anonymous namespace)::tile_cov_kernel<float, 3>",
                0, fwd),
               ("void (anonymous namespace)::tile_cov_vjp_kernel<float, 3>",
                fwd, fwd + vjp),
               ("void segment_mma_kernel<float, float>", 0, 10 ** 9)] * 2
    ctx = _ctx(kernels, dtype)
    item = 2 if dtype else 4
    want = 100.0 * 2 * (2 * 1000 * 128 * 128 * item / 3.35e12) \
        / (2 * (fwd + vjp) * 1e-9)
    assert _reader().read(ctx) == pytest.approx(want)
    assert ctx.reference.seen == [[1.0, 2.0, 2.0, 2.0], [1.0, 2.1, 2.0, 1.9]]
