"""BENCHMARK.json against the rules it is written to, and every name in
it resolving to its files."""

import ast
import json
import re

import pytest
from gpbench_toy import REPO

from gpbench.harness.spec import Spec

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
GPBENCH = REPO / "gpbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch") and p != "fvgp_tpu"
    assert len(BENCH["command"]) <= 32
    assert BENCH["command"][1].split("/")[0] in BENCH["paths"]


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_are_allowed_and_unique(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    if kind == "workloads":
        for w in BENCH[kind]:
            assert NAME.match(w["config"]) and NAME.match(w["traffic"])
            assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    if kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            assert UNIT.match(m["unit"]), m["unit"]
            assert m["better"] in ("lower", "higher")
            assert m["source"] in SOURCES


def test_metric_rules():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in cells
            assert "workloads" not in moved or w in moved["workloads"]
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
        if m["unit"] == "%" and m["name"].endswith("_roofline"):
            assert m["better"] == "higher"
    assert all(len(v) == 1 for v in layers.values())
    for w in cells:
        reports = [m for m in BENCH["end_to_end"]
                   if "workloads" not in m or w in m["workloads"]]
        assert {"setup_s"} < {m["name"] for m in reports}
        assert any(w in m["workloads"] for m in BENCH["per_layer"])


def test_every_name_resolves_to_its_files():
    spec = Spec(REPO)
    configs = {c["name"]: c for c in BENCH["configs"]}
    used = set()
    for w in BENCH["workloads"]:
        c = configs[w["config"]]
        used.add(c["name"])
        assert w["chips"] in (1, 4)
        cfg = json.loads((REPO / c["file"]).read_text())
        assert c["file"] == f"gpbench/configs/{c['name']}.json"
        assert (GPBENCH / "data" / f"{cfg['data']['maker']}.py").exists()
        assert (GPBENCH / "systems" / f"{cfg['system']}.py").exists()
        mix = json.loads((GPBENCH / "traffic" / f"{w['traffic']}.json")
                         .read_text())
        op = spec.op(mix["op"])
        assert (GPBENCH / "reference"
                / f"{cfg['family']}_{mix['op']}.py").exists()
        cell = json.loads((GPBENCH / "cells" / f"{w['name']}.json")
                          .read_text())
        assert cell["limits"] and cell["sample"] >= 1
        assert set(cell["limits"]) == set(op.NUMBERS)
    assert used == set(configs)
    for kind, dirname in (("end_to_end", "end_to_end"),
                          ("per_layer", "metrics")):
        for m in BENCH[kind]:
            _assert_reader(spec.reader_path(dirname, m["name"]))


def _assert_reader(path):
    tree = ast.parse(path.read_text())
    assert any(isinstance(n, ast.FunctionDef) and n.name == "read"
               for n in tree.body), path


def test_reduced_names_no_width():
    for c in BENCH["configs"]:
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k)
            assert not k.endswith(("_dim", "_rank", "_size"))
        cfg = json.loads((REPO / c["file"]).read_text())
        assert set(c["reduced"]) == set(cfg["reduced"])


def test_cells_within_the_four_chip_share():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_metric_readers_name_their_counters_and_kernels():
    """A reader that reads a program counter names it in its own file."""
    for m in BENCH["per_layer"]:
        src = Spec(REPO).reader_path("metrics", m["name"]).read_text()
        if "COUNTERS" in src:
            tree = ast.parse(src)
            assigned = {t.id for n in tree.body if isinstance(n, ast.Assign)
                        for t in n.targets if isinstance(t, ast.Name)}
            assert "COUNTERS" in assigned
