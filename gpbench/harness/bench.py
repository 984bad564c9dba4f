"""One run of one cell: set-up, the measured window, the traced
sub-window (``--trace 1``), the check, and the result line."""

import argparse
import gc
import json
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from . import check, trace
from .inputs import Traffic, make_data
from .spec import Spec
from .system import System

FORBIDDEN = ("jax", "jaxlib", "flax", "fvgp_tpu")


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def measure(spec, name, seed, seconds, traced, device, t0, config=None):
    """Set-up, the measured window and (``traced``) the traced sub-window
    of one cell; the program's state is freed before it returns.
    ``config`` replaces the cell's configuration file (the control's
    readings of another program path use it)."""
    w = spec.workload(name)
    config = config or spec.config(w["config"])
    mix = spec.traffic(w["traffic"])
    op = spec.op(mix["op"])
    cell = spec.cell(name)
    e2e, per_layer = spec.metrics_of(name)
    if "host_threads" in cell:    # the client process's CPU threads
        torch.set_num_threads(int(cell["host_threads"]))

    data = make_data(spec, config, seed)
    system = System(spec, config, data, device, op)
    traffic = Traffic(mix, config, seed, op)
    for req in traffic.warmup():
        system.run(req)
    system.sync()
    setup_s = time.perf_counter() - t0

    results = []
    stream = iter(traffic)
    start = time.perf_counter()
    while True:
        req = next(stream)
        a = time.perf_counter()
        try:
            out = system.run(req)
            if not System.finite(out):
                out = None
        except Exception as e:                # a failed request is counted
            log(f"request {len(results)} failed: {e!r}")
            out = None
        b = time.perf_counter()
        results.append({"req": req, "out": out, "s": b - a})
        if b - start >= seconds:
            break
    window = {"seconds": b - start,
              "done": sum(r["out"] is not None for r in results),
              "latency_s": [r["s"] for r in results],
              "requests": [r["req"] for r in results],
              "ok": [r["out"] is not None for r in results]}
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0

    prof = None
    if traced:
        counters = {}
        for m in per_layer:
            counters.update(getattr(spec.metric(m["name"]), "COUNTERS", {}))
        prof = trace.profile(system, [next(stream)
                                      for _ in range(int(cell["traced"]))],
                             counters)
    del system
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    return SimpleNamespace(workload=w, config=config, traffic=mix, op=op,
                           op_name=mix["op"], cell=cell, e2e=e2e,
                           per_layer=per_layer, data=data, results=results,
                           window=window, setup_s=setup_s, peak=peak,
                           profile=prof)


def judge(spec, run, seed, device, precision="exact"):
    """(sample, reference, its answers, compared numbers) of a measured
    run; ``precision`` is the reference's (``exact``, or ``tf32`` for the
    control)."""
    idx = check.sample(run.results, run.op, int(run.cell["sample"]), seed)
    ref = spec.reference(run.config["family"], run.op_name).make(
        run.config, run.data, device, precision)
    answers = [run.results[i]["out"] for i in idx]
    refs = ref.answers([run.results[i]["req"] for i in idx], answers)
    return idx, ref, refs, check.numbers(run.op, answers, refs, run.config,
                                         run.data)


def run_cell(spec, name, seed, seconds, traced, device, t0):
    """The result object of one run (``correct`` and the rest)."""
    run = measure(spec, name, seed, seconds, traced, device, t0)
    lat = np.asarray(run.window["latency_s"])
    log(f"set-up {run.setup_s:.3f} s; window {run.window['seconds']:.3f} s,"
        f" {run.window['done']} of {len(run.results)} requests done; "
        f"latency min {lat.min():.4f} median {np.median(lat):.4f} max "
        f"{lat.max():.4f} s")
    t_check = time.perf_counter()
    idx, ref, _, nums = judge(spec, run, seed, device)
    log(f"reference check of {len(idx)} answers "
        f"{time.perf_counter() - t_check:.3f} s")
    correct, checks = check.verdict(nums, run.cell["limits"], idx)

    metrics = {}
    if not traced:
        ctx = SimpleNamespace(window=run.window, setup_s=run.setup_s)
        entries, reader = run.e2e, spec.end_to_end
    else:
        ctx = SimpleNamespace(config=run.config, traffic=run.traffic,
                              workload=run.workload, window=run.window,
                              profile=run.profile, count=spec.count,
                              reference=ref, data=run.data)
        entries, reader = run.per_layer, spec.metric
    for m in entries:
        v = reader(m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": (torch.cuda.get_device_name(0) if device != "cpu"
                    else "cpu"),
           "count": int(run.workload["chips"]),
           "memory_peak_bytes": int(run.peak)}
    result = {"correct": correct, "attempted": len(run.results),
              "failed": len(run.results) - run.window["done"],
              "metrics": metrics, "device": dev}
    if run.profile is not None:
        dev["busy_s"] = run.profile["busy_ns"] * 1e-9
        dev["window_s"] = run.profile["window_ns"] * 1e-9
        result["breakdown"] = run.profile["breakdown"]
    result["checks"] = checks
    return result


def main(argv, t0):
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    spec = Spec()
    chips = int(spec.workload(a.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"this cell needs {chips} CUDA device(s); "
            f"torch.cuda.is_available() = {torch.cuda.is_available()}")
        return 3
    try:
        import fvgp_tpu_torch  # noqa: F401
    except ImportError as e:
        log(f"the program under test is not importable: {e!r}")
        return 5
    result = run_cell(spec, a.workload, a.seed, a.seconds, bool(a.trace),
                      "cuda", t0)
    loaded = sorted({m.split(".")[0] for m in list(sys.modules)}
                    & set(FORBIDDEN))
    if loaded:
        log(f"refused: the run loaded {loaded}")
        return 4
    log(f"correct {result['correct']}")
    for k, c in result["checks"].items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0
