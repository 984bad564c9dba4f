"""Name resolution: everything a cell needs is found by the names in
``BENCHMARK.json``, each in a file of its own under ``gpbench/``.

    configs/<config>.json         the configuration, as it is run; its
                                  ``data.maker`` and ``system`` name
    data/<maker>.py               the maker of its data from the seed
    systems/<system>.py           the builder of the system under test
    traffic/<traffic>.json        the traffic mix's parameters; its ``op``
                                  names the request kind
    ops/<op>.py                   a request kind: its requests from the mix,
                                  the call it makes of the system, and the
                                  numbers its answers are compared by
    cells/<workload>.json         the cell's correctness limits, its check's
                                  sample, its traced sub-window and, where
                                  it sets them, its host threads
    end_to_end/<metric>.py        one end-to-end metric's reader
    metrics/<metric>.py           one per-layer metric's reader
    counts/<name>.py              operation and byte formulas, the peak table
                                  (``name`` a Python identifier)
    reference/<family>_<op>.py    the plain reference of a configuration
                                  family's answers to one request kind

A metric named ``<base>.<variant>`` is read by ``<base>.<variant>.py`` or,
where that file does not exist, by ``<base>.py``: the variants of one
quantity in cells that report different end-to-end metrics share a reader.
"""

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


class Spec:
    """``BENCHMARK.json`` of the checkout at ``root`` and the files its
    names resolve to."""

    def __init__(self, root=ROOT):
        self.root = Path(root)
        self.dir = self.root / "gpbench"
        with open(self.root / "BENCHMARK.json") as f:
            self.bench = json.load(f)
        self._modules = {}

    def _json(self, kind, name):
        with open(self.dir / kind / f"{name}.json") as f:
            return json.load(f)

    def workload(self, name):
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")

    def config(self, name):
        return self._json("configs", name)

    def traffic(self, name):
        return self._json("traffic", name)

    def cell(self, workload):
        return self._json("cells", workload)

    def reader_path(self, kind, name):
        path = self.dir / kind / f"{name}.py"
        if not path.exists():
            path = self.dir / kind / f"{name.split('.')[0]}.py"
        return path

    def _module(self, kind, name, package=None):
        """The module of ``<kind>/<name>.py`` in this checkout; a module of
        a package (``package``) resolves its relative imports there."""
        key = (kind, name)
        if key not in self._modules:
            path = self.reader_path(kind, name)
            modname = f"{package}.{name}" if package else \
                f"gpbench_{kind}_{name}".replace(".", "_").replace("-", "_")
            spec = importlib.util.spec_from_file_location(modname, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[key] = mod
        return self._modules[key]

    def data(self, name):
        return self._module("data", name)

    def system(self, name):
        return self._module("systems", name)

    def op(self, name):
        return self._module("ops", name)

    def end_to_end(self, name):
        return self._module("end_to_end", name)

    def metric(self, name):
        return self._module("metrics", name)

    def count(self, name):
        return self._module("counts", name, "gpbench.counts")

    def reference(self, family, op):
        return self._module("reference", f"{family}_{op}",
                            "gpbench.reference")

    def metrics_of(self, workload):
        """The cell's end-to-end and per-layer metric entries.  A metric
        with ``workloads`` belongs to the cells it lists; an end-to-end
        metric without it to every cell, a per-layer one to every cell
        that reports the end-to-end metric it moves."""
        def listed(m):
            return workload in m.get("workloads", [workload])
        e2e = [m for m in self.bench["end_to_end"] if listed(m)]
        names = {m["name"] for m in e2e}
        return e2e, [m for m in self.bench["per_layer"]
                     if listed(m) and m["moves"] in names]
