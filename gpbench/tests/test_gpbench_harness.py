"""The harness end to end on the CPU at toy sizes (its look for a card
skipped): a run is judged correct, a new configuration, mix, request kind,
reference, data maker and metric added as files run without an edit to any
file already there, the timed path broken underneath makes ``correct``
false, and ``run.py`` refuses to run without a card or without the
program."""

import json
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
from gpbench_toy import REPO, spec, toy_checkout

from gpbench.harness import bench
from gpbench.harness.system import System

SEED = 2 ** 31 + 77


@pytest.fixture(autouse=True)
def _one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    return toy_checkout(tmp_path_factory.mktemp("toy"))


def _run(root, name, traced=False, seconds=0.5):
    return bench.run_cell(spec(root), name, SEED, seconds, traced, "cpu",
                          time.perf_counter())


@pytest.mark.parametrize("name", ["dense-train", "dense-predict",
                                  "gp2scale-train"])
def test_a_sound_run_is_correct(toy, name):
    r = _run(toy, name)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == set(json.loads(
        (toy / "gpbench" / "cells" / f"{name}.json").read_text())["limits"])
    assert "setup_s" in r["metrics"] and len(r["metrics"]) >= 2


def test_a_cell_sets_its_host_threads(tmp_path):
    import torch
    root = toy_checkout(tmp_path)
    p = root / "gpbench" / "cells" / "dense-predict.json"
    cell = json.loads(p.read_text())
    assert cell["host_threads"] == 1
    p.write_text(json.dumps(dict(cell, host_threads=2)))
    assert torch.get_num_threads() == 1
    assert _run(root, "dense-predict")["correct"]
    assert torch.get_num_threads() == 2


def test_a_traced_run_reports_its_per_layer_metrics(toy):
    r = _run(toy, "dense-train", traced=True)
    assert r["correct"]
    assert {"step_mfu.dense", "device_idle.train.dense",
            "dense_linalg_ms"} <= set(r["metrics"])
    assert "setup_s" not in r["metrics"]
    assert r["device"]["window_s"] > 0 and "breakdown" in r


def test_new_config_mix_and_metric_need_no_edit(tmp_path):
    root = toy_checkout(tmp_path)
    before = {p: p.read_bytes() for p in (root / "gpbench").rglob("*")
              if p.is_file()}
    g = root / "gpbench"
    cfg = json.loads((g / "configs" / "dense-matern-10k.json").read_text())
    cfg["data"]["n"] = 300
    cfg["gp"]["init_hyperparameters"] = [2.0, 1.0, 1.0, 1.0]
    (g / "configs" / "toy-dense.json").write_text(json.dumps(cfg))
    (g / "traffic" / "toy-walk.json").write_text(json.dumps(
        {"op": "lml_grad", "walk_half_width": 0.1, "warmup": 1}))
    (g / "cells" / "toy-cell.json").write_text(json.dumps(
        {"sample": 2, "traced": 2,
         "limits": {"lml_rel": 1e-6, "grad_rel": 1e-6}}))
    (g / "metrics" / "toy_steps.py").write_text(
        "def read(ctx):\n    return ctx.window['done']\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "toy-dense", "source": "a test",
                         "file": "gpbench/configs/toy-dense.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "toy-cell", "config": "toy-dense",
                           "traffic": "toy-walk", "chips": 1, "why": "a test"})
    _e2e(b, "lml_grad_s.dense")["workloads"].append("toy-cell")
    b["per_layer"].append({"name": "toy_steps", "unit": "steps",
                           "better": "higher", "source": "host_clock",
                           "layer": "whole step",
                           "moves": "lml_grad_s.dense",
                           "workloads": ["toy-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    r0 = _run(root, "toy-cell")
    r1 = _run(root, "toy-cell", traced=True)
    assert r0["correct"] and "lml_grad_s.dense" in r0["metrics"]
    assert r1["correct"] and r1["metrics"]["toy_steps"]["value"] >= 1
    after = {p: p.read_bytes() for p in before}
    assert after == before


def _e2e(b, name):
    return next(m for m in b["end_to_end"] if m["name"] == name)


TOY_OP = """import numpy as np

NUMBERS = ("lml_rel",)


def warmup(mix, config, r):
    return [{"h": np.asarray(config["gp"]["init_hyperparameters"], float)}]


def requests(mix, config, r):
    h0 = np.asarray(config["gp"]["init_hyperparameters"], float)
    while True:
        yield {"h": h0 * np.exp(r.uniform(-mix["w"], mix["w"], h0.shape))}


def call(model, req, index):
    v, _ = model.marginal_likelihood.log_likelihood_value_and_gradient(
        req["h"])
    return {"value": float(v)}


def pick(results, k, r):
    return list(range(min(k, len(results))))


def numbers(answer, ref, config, data):
    return {"lml_rel": abs(answer["value"] - ref["value"])
            / abs(ref["value"])}
"""

TOY_REF = """from .dense_lml_grad import DenseLmlGrad


class ValueOnly(DenseLmlGrad):
    def answers(self, reqs, outs):
        return [{"value": self.lml_grad(r["h"])[0]} for r in reqs]


def make(config, data, device, precision="exact"):
    return ValueOnly(config, data, device, precision)
"""

TOY_DATA = """import numpy as np


def make(p, r):
    x = r.uniform(0.0, p["side"], (int(p["n"]), int(p["dim"])))
    y = np.cos(x[:, 0]) + 0.05 * r.standard_normal(len(x))
    return {"x": x, "y": y, "noise": np.full(len(x), p["noise_variance"])}
"""


def test_new_request_kind_reference_data_and_end_to_end_metric_need_no_edit(
        tmp_path):
    root = toy_checkout(tmp_path)
    g = root / "gpbench"
    before = {p: p.read_bytes() for p in g.rglob("*") if p.is_file()}
    (g / "ops" / "toy_value.py").write_text(TOY_OP)
    (g / "reference" / "dense_toy_value.py").write_text(TOY_REF)
    (g / "data" / "toy_cos.py").write_text(TOY_DATA)
    (g / "end_to_end" / "toy_steps_per_s.py").write_text(
        "def read(ctx):\n    return ctx.window['done'] / "
        "ctx.window['seconds']\n")
    cfg = json.loads((g / "configs" / "dense-matern-10k.json").read_text())
    cfg["data"] = {"maker": "toy_cos", "n": 250, "dim": 3, "side": 6.0,
                   "noise_variance": 0.01}
    (g / "configs" / "toy-cos.json").write_text(json.dumps(cfg))
    (g / "traffic" / "toy-value-mix.json").write_text(json.dumps(
        {"op": "toy_value", "w": 0.05}))
    (g / "cells" / "toy-value.json").write_text(json.dumps(
        {"sample": 3, "traced": 2, "limits": {"lml_rel": 1e-6}}))
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "toy-cos", "source": "a test",
                         "file": "gpbench/configs/toy-cos.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "toy-value", "config": "toy-cos",
                           "traffic": "toy-value-mix", "chips": 1,
                           "why": "a test"})
    b["end_to_end"].append({"name": "toy_steps_per_s", "unit": "1/s",
                            "better": "higher", "bound": 0.05,
                            "source": "host_clock",
                            "workloads": ["toy-value"]})
    b["per_layer"].append({"name": "device_idle.toy", "unit": "%",
                           "better": "lower", "source": "device_trace",
                           "layer": "device", "moves": "toy_steps_per_s",
                           "workloads": ["toy-value"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    r0 = _run(root, "toy-value")
    r1 = _run(root, "toy-value", traced=True)
    assert r0["correct"] and set(r0["checks"]) == {"lml_rel"}
    assert set(r0["metrics"]) == {"setup_s", "toy_steps_per_s"}
    assert r1["correct"] and set(r1["metrics"]) == {"device_idle.toy"}
    assert {p: p.read_bytes() for p in before} == before


def _break(monkeypatch, fault):
    """Every answer of the system passed through ``fault`` (the answer and
    the state the fault keeps between calls)."""
    real = System.run
    state = {}

    def broken(self, req):
        return fault(real(self, req), state)

    monkeypatch.setattr(System, "run", broken)


def _alter_value(out, state):
    return dict(out, value=out["value"] * (1 + 1e-2))


def _alter_grad(out, state):
    g = out["grad"].copy()
    g[1] *= 1.5
    return dict(out, grad=g)


def _half_left_out(out, state):
    """Half the request's points answered with the prior alone."""
    m, v = out["mean"].copy(), out["var"].copy()
    h = len(m) // 2
    m[h:] = np.mean(m)
    v[h:] = 1.0
    return dict(out, mean=m, var=v)


def _alter_mean(out, state):
    m = out["mean"].copy()
    m[0] += 0.1
    return dict(out, mean=m)


def _unchanged(out, state):
    """A step that returns what the one before it returned."""
    before = state.get("last")
    state["last"] = out
    return out if before is None else before


@pytest.mark.parametrize("name,fault", [
    ("dense-train", _alter_value),
    ("dense-train", _alter_grad),
    ("dense-train", _unchanged),
    ("gp2scale-train", _alter_value),
    ("gp2scale-train", _alter_grad),
    ("gp2scale-train", _unchanged),
    ("dense-predict", _half_left_out),
    ("dense-predict", _alter_mean),
    ("dense-predict", _unchanged),
])
def test_a_broken_timed_path_is_not_correct(toy, monkeypatch, name, fault):
    _break(monkeypatch, fault)
    r = _run(toy, name)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def _cli(root, *extra, env=None):
    return subprocess.run(
        [sys.executable, "gpbench/run.py", "--workload", "dense-train",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0", *extra],
        cwd=root, capture_output=True, text=True, timeout=300, env=env)


def test_run_refuses_without_a_card(toy):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present; the refusal is for a machine "
                    "without one")
    p = _cli(toy)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_run_refuses_in_a_bare_directory(tmp_path):
    shutil.copytree(REPO / "gpbench", tmp_path / "gpbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = _cli(tmp_path)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
