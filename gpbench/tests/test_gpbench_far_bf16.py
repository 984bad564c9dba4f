"""The cells gp2scale-train-far and gp2scale-bf16-train: every name they
add resolves through ``Spec``, their new readers give nothing where the
program keeps no such counter, ``step_mfu.gp2scale_bf16`` divides by the
bfloat16 peak, and both run end to end at toy sizes, judged correct, with
their per-layer metrics in the traced line."""

import json
import time
from types import SimpleNamespace

import pytest
from gpbench_toy import REPO, spec, toy_checkout

from gpbench.harness import bench, structure_counters

CELLS = ("gp2scale-train-far", "gp2scale-bf16-train")
SEED = 2 ** 31 + 91


@pytest.fixture(autouse=True)
def _one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """The toy checkout with the bfloat16 configuration cut as the float32
    one is."""
    root = toy_checkout(tmp_path_factory.mktemp("toyfar"))
    p = root / "gpbench" / "configs" / "gp2scale-wendland-1m-bf16.json"
    cfg = json.loads(p.read_text())
    f32 = json.loads((root / "gpbench" / "configs"
                      / "gp2scale-wendland-1m.json").read_text())
    cfg["data"] = f32["data"]
    p.write_text(json.dumps(cfg))
    return root


def _metrics_of(s, name):
    return [m["name"] for m in s.metrics_of(name)[1]]


@pytest.mark.parametrize("name", CELLS)
def test_every_new_name_resolves(name):
    s = spec(REPO)
    w = s.workload(name)
    config = s.config(w["config"])
    mix = s.traffic(w["traffic"])
    op = s.op(mix["op"])
    assert set(s.cell(name)["limits"]) == set(op.NUMBERS)
    ref = s.reference(config["family"], mix["op"])
    assert callable(ref.make)
    assert callable(s.count(f"lml_grad_{config['family']}").step_ops)
    e2e, per_layer = s.metrics_of(name)
    assert {m["name"] for m in e2e} == {"setup_s", "lml_grad_s.gp2scale"}
    for m in per_layer:
        assert callable(s.metric(m["name"]).read)
    assert {m["name"] for m in per_layer} == {
        "gp2scale-train-far": {"structure_passes.far", "step_mfu.gp2scale"},
        "gp2scale-bf16-train": {"step_mfu.gp2scale_bf16"},
    }[name] | {"device_idle.train.gp2scale", "k1_roofline", "assembly_ms",
               "cg_iters", "host_syncs.gp2scale", "tile_cov_roofline"}


def test_bf16_configuration_is_the_float32_one_in_bf16():
    s = spec(REPO)
    f32 = s.config("gp2scale-wendland-1m")
    bf = s.config("gp2scale-wendland-1m-bf16")
    assert bf["family"] == "gp2scale_bf16" and bf["reduced"] == {}
    assert bf["data"] == f32["data"]
    args = dict(bf["gp"]["args"])
    assert args.pop("gp2Scale_solver_dtype") == "bfloat16"
    assert args.pop("gp2Scale_storage_dtype") == "bfloat16"
    assert args == f32["gp"]["args"]
    assert {k: v for k, v in bf["gp"].items() if k != "args"} == \
        {k: v for k, v in f32["gp"].items() if k != "args"}


def test_structure_passes_reads_the_mean_and_none_without_the_counter(
        monkeypatch):
    reader = spec(REPO).metric("structure_passes.far")
    assert reader.COUNTERS == {"structure_passes": (
        "gpbench.harness.structure_counters", "structure_passes")}

    def ctx(counters):
        return SimpleNamespace(profile={"counters": counters,
                                        "requests": [{}] * len(counters)})

    newer = SimpleNamespace(counters=lambda: {"structure_passes": 3})
    monkeypatch.setattr(structure_counters, "_program", lambda: newer)
    assert reader.read(ctx([{"structure_passes": 1},
                            {"structure_passes": 1}])) == 1.0
    # a program that never counted a pass, not even in its set-up, does
    # not keep the counter: nothing, where the traced steps read 0
    older = SimpleNamespace(counters=lambda: {"mbcg_iterations": 64})
    monkeypatch.setattr(structure_counters, "_program", lambda: older)
    assert reader.read(ctx([{"structure_passes": 0},
                            {"structure_passes": 0}])) is None
    monkeypatch.setattr(structure_counters, "_program", lambda: None)
    assert reader.read(ctx([{}, {}])) is None


def test_structure_counters_name_nothing_without_the_counters_module(
        monkeypatch):
    from gpbench.harness import program_counters
    monkeypatch.setattr(program_counters, "_program", lambda: None)
    assert structure_counters.named("structure_passes") == {}
    monkeypatch.undo()
    assert structure_counters.named("structure_passes") == {
        "structure_passes": (structure_counters.__name__,
                             "structure_passes")}


def test_step_mfu_bf16_divides_by_the_bf16_peak():
    s = spec(REPO)
    config = s.config("gp2scale-wendland-1m-bf16")
    ref = SimpleNamespace(live_tiles=lambda h: 219_631)
    ctx = SimpleNamespace(window={"seconds": 30.0, "done": 100},
                          config=config, reference=ref, count=s.count)
    ops = s.count("lml_grad_gp2scale_bf16").step_ops(config, ref)
    assert ops == s.count("lml_grad_gp2scale").step_ops(config, ref)
    want = 100.0 * ops / 0.3 / 989e12
    assert s.metric("step_mfu.gp2scale_bf16").read(ctx) == \
        pytest.approx(want, rel=1e-12)
    # the float32 cells' reader takes the TF32 peak
    assert s.metric("step_mfu.gp2scale").read(ctx) == \
        pytest.approx(want * 989 / 495, rel=1e-12)
    assert s.metric("step_mfu.gp2scale_bf16").read(
        SimpleNamespace(window={"seconds": 1.0, "done": 0})) is None


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_with_its_traced_metrics(toy, name):
    r = bench.run_cell(spec(toy), name, SEED, 0.5, True, "cpu",
                       time.perf_counter())
    assert r["correct"] and r["failed"] == 0, r
    got = r["metrics"]
    if name == "gp2scale-train-far":
        assert got["structure_passes.far"]["value"] == 1.0
    assert 1 <= got["cg_iters"]["value"] <= 32
    assert "step_mfu" + (".gp2scale" if name.endswith("far")
                         else ".gp2scale_bf16") in got
    assert "host_syncs.gp2scale" in got and "assembly_ms" in got
