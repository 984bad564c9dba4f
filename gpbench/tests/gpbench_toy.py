"""A checkout of the benchmark at toy sizes, for the CPU tests: a copy of
``gpbench/`` and ``BENCHMARK.json`` in a temporary directory with the
configurations cut to a few thousand points (the cells, mixes, metrics
and references unchanged)."""

import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TOY_N = {"gp2scale-wendland-1m": 2500, "dense-matern-10k": 400}


def toy_checkout(tmp):
    """``tmp`` holding BENCHMARK.json and gpbench/ at toy sizes."""
    tmp = Path(tmp)
    shutil.copytree(REPO / "gpbench", tmp / "gpbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for name, n in TOY_N.items():
        p = tmp / "gpbench" / "configs" / f"{name}.json"
        cfg = json.loads(p.read_text())
        if cfg["family"] == "gp2scale":
            # keep ~40 support neighbours at lengthscale 2
            cfg["data"]["box"] = [0.0, (n * 4.19 * 8 / 40) ** (1 / 3)]
        cfg["data"]["n"] = n
        p.write_text(json.dumps(cfg))
    return tmp


def spec(root):
    from gpbench.harness.spec import Spec
    return Spec(root)
