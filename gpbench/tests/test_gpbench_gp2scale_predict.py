"""The gp2scale-predict cell: every request of every seed asks for the same
500 points' work, its files and readers resolve by name, its counts meet
hand counts, its readers give nothing where there is nothing to read, and
the cell runs end to end on the CPU at a toy N."""

import itertools
import json
import time
from types import SimpleNamespace

import pytest
from gpbench_toy import REPO, spec, toy_checkout

from gpbench.harness import bench
from gpbench.harness.inputs import Traffic
from gpbench.harness.spec import Spec

CELL = "gp2scale-predict"
SPEC = Spec(REPO)
NEW_METRICS = {"k2_roofline", "cg_iters.committed", "predict_mfu.gp2scale",
               "device_idle.predict.gp2scale", "host_syncs.predict.gp2scale"}


@pytest.fixture(autouse=True)
def _one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cell():
    w = SPEC.workload(CELL)
    return w, SPEC.config(w["config"]), SPEC.traffic(w["traffic"])


@pytest.mark.parametrize("seed", [1, 99, 2 ** 31 + 5, 2 ** 40 + 3])
def test_every_request_of_every_seed_is_500_points(seed):
    _, cfg, mix = _cell()
    t = Traffic(mix, cfg, seed, SPEC.op(mix["op"]))
    warm = t.warmup()
    window = list(itertools.islice(iter(t), 50))
    assert len(warm) == 3
    assert {r["xq"].shape for r in warm + window} == {(500, 3)}
    lo, hi = cfg["data"]["box"]
    assert all(lo <= r["xq"].min() and r["xq"].max() <= hi for r in window)


def test_the_cell_resolves_by_name():
    w, cfg, mix = _cell()
    assert w["chips"] == 1 and w["config"] == "gp2scale-wendland-1m-posterior"
    assert cfg["family"] == "gp2scale" and cfg["data"]["n"] == 10 ** 6
    train = SPEC.config("gp2scale-wendland-1m")
    assert cfg["data"] == train["data"] and cfg["gp"] == train["gp"]
    assert mix["op"] == "predict" and list(SPEC.op("predict").sizes(mix)) \
        == [500]
    assert callable(SPEC.reference("gp2scale", "predict").make)
    cell = SPEC.cell(CELL)
    assert set(cell["limits"]) == set(SPEC.op("predict").NUMBERS)
    assert cell["sample"] >= 4 and cell["host_threads"] == 1
    e2e, per_layer = SPEC.metrics_of(CELL)
    assert {m["name"] for m in e2e} == {"setup_s", "predict_ms",
                                        "predict_p95_ms"}
    assert {m["name"] for m in per_layer} == NEW_METRICS
    for m in per_layer:
        assert callable(SPEC.metric(m["name"]).read)


def test_k2_hand_count():
    k2 = SPEC.count("k2")
    # 2 float32 tiles of 32², 3 blocks, 2 trips multiplying 3 columns in
    # all: the tiles each trip, X and the output each column
    by_hand = 2 * 2 * 32 * 32 * 4 + 3 * 3 * 32 * (4 + 4)
    assert k2.request_bytes(2, 3, 32, 2, 3, "float32") == by_hand
    assert k2.request_ops(2, 32, 3) == 2 * 2 * 32 * 32 * 3
    assert k2.bound_s(2, 3, 32, 2, 3, "float32") == pytest.approx(
        max(by_hand / 3.35e12, 3 * 2 * 2 * 32 * 32 * 3 / 495e12))


def test_k2_bound_at_the_cell_shape():
    """One trip of 219,631 float32 tiles of 128² at 500 columns: the
    operations bound it, 3 × 2 · 3.6e9 · 500 at 495 TFLOP/s is 21.8 ms
    (the bytes, 18.4 GB, 5.5 ms); at 8 columns the tiles' bytes do
    (4.3 ms)."""
    k2 = SPEC.count("k2")
    t = k2.bound_s(219_631, 7_813, 128, 1, 500, "float32")
    assert t == pytest.approx(3 * 2 * 219_631 * 128 ** 2 * 500 / 495e12)
    assert 21.7e-3 < t < 21.9e-3
    t8 = k2.bound_s(219_631, 7_813, 128, 1, 8, "float32")
    assert t8 == pytest.approx(k2.request_bytes(219_631, 7_813, 128, 1, 8,
                                                "float32") / 3.35e12)
    assert 4.3e-3 < t8 < 4.4e-3


def test_predict_gp2scale_hand_count():
    count = SPEC.count("predict_gp2scale")
    # N = 10, n = 2, D = 3 (26 operations a Wendland value), 2 tiles of
    # 4² in 3 blocks, 5 iterations: the values twice (1040), the mean's and
    # the diagonal's products (40 each), 5 · 2 · 16 · 2 · (2 + 3) = 1600
    assert count.ops(10, 2, 3, 2, 3, 4, iters=5) == 1040 + 40 + 1600 + 40
    _, cfg, _ = _cell()
    ref = SimpleNamespace(live_tiles=lambda h: 219_631)
    req = {"xq": [[0.0] * 3] * 500}
    assert count.request_ops(cfg, req, ref) == count.ops(
        10 ** 6, 500, 3, 219_631, 7_813, 128)


def _traced(counters, kernels=(("segment_mma_kernel<float>", 0, 10 ** 9),)):
    _, cfg, _ = _cell()
    return SimpleNamespace(
        config=cfg, count=SPEC.count,
        reference=SimpleNamespace(live_tiles=lambda h: 219_631),
        profile={"kernels": list(kernels), "counters": counters,
                 "requests": [{"xq": [[0.0] * 3] * 500}] * len(counters)})


def test_k2_roofline_reads_only_k2():
    read = SPEC.metric("k2_roofline").read
    one = {"k1": 0, "k2": 27, "k4": 0, "cg_iterations": 10,
           "cg_columns": 3000}
    # one request, 10 trips over 3,000 columns, 1 s of K2
    assert read(_traced([one])) == pytest.approx(
        100 * SPEC.count("k2").bound_s(219_631, 7_813, 128, 10, 3000,
                                       "float32"))
    assert read(_traced([dict(one, k1=1)])) is None
    assert read(_traced([dict(one, k4=2)])) is None
    assert read(_traced([dict(one, k2=0)])) is None
    # a program without the solver's counters, or without cg_columns
    assert read(_traced([{"k1": 0, "k2": 27, "k4": 0}])) is None
    assert read(_traced([dict(one, cg_columns=0)])) is None
    assert read(_traced([one], kernels=())) is None
    assert {"cg_iterations", "cg_columns"} <= set(
        SPEC.metric("k2_roofline").COUNTERS)


def test_cg_iters_committed_reads_the_counter_or_nothing():
    read = SPEC.metric("cg_iters.committed").read
    assert read(_traced([{"cg_iterations": 16}, {"cg_iterations": 18}])) \
        == 17
    # a program whose trace has no such counter, or where it never moved
    assert read(_traced([{"k2": 3}, {"k2": 3}])) is None
    assert read(_traced([{"cg_iterations": 0}])) is None
    assert "cg_iterations" in SPEC.metric("cg_iters.committed").COUNTERS


def _toy_root(tmp):
    """A toy checkout with the cell's configuration cut to N = 2,100 on
    the box that keeps ~40 support neighbours, in blocks of 32: above the
    2,001 points below which the auto mode factors K+V densely, so the
    committed PCG serves it; the traffic unchanged."""
    root = toy_checkout(tmp)
    p = root / "gpbench" / "configs" / "gp2scale-wendland-1m-posterior.json"
    cfg = json.loads(p.read_text())
    n = 2100
    cfg["data"]["n"] = n
    cfg["data"]["box"] = [0.0, (n * 4.19 * 8 / 40) ** (1 / 3)]
    cfg["gp"]["args"]["gp2Scale_block_size"] = 32
    p.write_text(json.dumps(cfg))
    return root


def test_the_cell_runs_end_to_end_on_the_cpu(tmp_path):
    root = _toy_root(tmp_path)
    for traced in (False, True):
        r = bench.run_cell(spec(root), CELL, 2 ** 31 + 77, 0.5, traced,
                           "cpu", time.perf_counter())
        assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
        assert r["checks"]["mean_rel"]["value"] < 1e-6
        if not traced:
            assert set(r["metrics"]) == {"setup_s", "predict_ms",
                                         "predict_p95_ms"}
            continue
        # no K2 on the CPU: its roofline has nothing to read
        assert set(r["metrics"]) == NEW_METRICS - {"k2_roofline"}
        assert r["metrics"]["cg_iters.committed"]["value"] >= 1
