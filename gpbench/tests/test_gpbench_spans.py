"""The program's spans and counters as the benchmark reads them: the span
reducer (``harness/spans.py``) on a synthetic event list, and the counter
readers (``cg_iters``, ``host_syncs.*``) in traced toy runs on the CPU,
with the program's counters module and without it."""

import sys
import time

import pytest
import torch
from gpbench_toy import toy_checkout, spec

from gpbench.harness import bench, program_counters, spans, trace

SEED = 2 ** 31 + 91
CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Ev:
    """A stand-in for one of the profiler's events."""

    def __init__(self, name, start, end, kind, corr=0, linked=0,
                 device=CPU):
        self._v = (name, start, end, kind, corr, linked, device)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def activity_type(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def device_type(self):
        return self._v[6]

    def is_user_annotation(self):
        return self._v[3] in ("user_annotation", "gpu_user_annotation")


def span(name, s, e, corr=0):
    return Ev(name, s, e, "user_annotation", corr)


def launch(s, corr):
    """A runtime launch on the host (any thread: the reducer goes by
    time)."""
    return Ev("cudaLaunchKernel", s, s + 1, "cuda_runtime", corr)


def kernel(name, s, e, corr, linked=0):
    return Ev(name, s, e, "kernel", corr, linked, CUDA)


def events():
    """Two requests.  Request 1 (0-100): structure 0-30 with no device
    work (idle), probes 30-40 launching a copy, mbcg 40-60 launching two
    kernels, backward 60-95 on the main thread holding mbcg_bwd 62-80 on a
    second thread (its kernel launched there at 65) and one kernel
    launched by the backward's own glue at 85.  Request 2 (100-150):
    to_host 110-120, its copy linked to an operator (no runtime event).
    The program's device-side annotation of mbcg never counts as work."""
    return [
        span(trace.SPAN, 0, 100), span(trace.SPAN, 100, 150),
        span("fvgp.sparse_lml.structure", 0, 30),
        span("fvgp.sparse_lml.probes", 30, 40),
        launch(31, 1), Ev("Memcpy HtoD", 33, 38, "gpu_memcpy", 1, 0, CUDA),
        span("fvgp.sparse_lml.mbcg", 40, 60),
        launch(41, 2), kernel("segment_mma_kernel", 42, 50, 2),
        launch(45, 3), kernel("reduce_kernel", 50, 55, 3),
        Ev("fvgp.sparse_lml.mbcg", 42, 55, "gpu_user_annotation", 0, 0,
           CUDA),
        span("fvgp.sparse_lml.backward", 60, 95),
        span("fvgp.sparse_lml.mbcg_bwd", 62, 80),
        launch(65, 4), kernel("tiles_vjp", 66, 79, 4),
        launch(85, 5), kernel("elementwise", 86, 90, 5),
        span("fvgp.to_host", 110, 120, corr=77),
        Ev("aten::copy_", 111, 119, "cpu_op", 78),
        Ev("Memcpy DtoH", 112, 118, "gpu_memcpy", 9, 78, CUDA),
    ]


def test_kernels_go_to_the_innermost_span_by_launch_time():
    red = spans.reduce(*spans.records(events()))
    r1, r2 = red["requests"]
    assert r1["fvgp.sparse_lml.probes"]["device_ns"] == 5
    assert r1["fvgp.sparse_lml.mbcg"]["device_ns"] == 8 + 5
    # the kernel launched on the second thread goes to the child, the
    # backward's glue kernel to the backward itself
    assert r1["fvgp.sparse_lml.mbcg_bwd"]["device_ns"] == 13
    assert r1["fvgp.sparse_lml.backward"]["device_ns"] == 4
    assert r1["fvgp.sparse_lml.structure"]["device_ns"] == 0
    # a copy with no runtime event: through its linked operator
    assert r2["fvgp.to_host"]["device_ns"] == 6


def test_self_time_and_idle_overlap():
    red = spans.reduce(*spans.records(events()))
    r1 = red["requests"][0]
    b = r1["fvgp.sparse_lml.backward"]
    assert (b["host_ns"], b["self_ns"]) == (35, 35 - 18)
    # busy in request 1: 33-38, 42-55, 66-79, 86-90
    assert r1["fvgp.sparse_lml.structure"]["idle_ns"] == 30
    assert r1["fvgp.sparse_lml.probes"]["idle_ns"] == 10 - 5
    assert b["idle_ns"] == 35 - 13 - 4
    assert r1["fvgp.sparse_lml.mbcg_bwd"]["idle_ns"] == 18 - 13
    # the window's idle: 150 less 5 + 13 + 13 + 4 + 6 busy; outside every
    # program span: 95-110 and 120-150
    assert red["window_ns"] == 150
    assert red["idle_ns"] == 150 - 41
    assert red["idle_named_ns"] == red["idle_ns"] - 15 - 30
    assert red["idle_gaps"][0] == ["fvgp.sparse_lml.structure", 33]
    assert red["idle_gaps"][1] == [spans.OUTSIDE, 32]


def test_spans_are_grouped_by_request():
    red = spans.reduce(*spans.records(events()))
    r1, r2 = red["requests"]
    assert "fvgp.to_host" not in r1 and set(r2) == {"fvgp.to_host"}
    assert r1["fvgp.sparse_lml.mbcg"]["count"] == 1
    mean = spans.totals(red, "fvgp.to_host")
    assert mean["host_ns"] == 10 / 2 and spans.totals(red, "none") is None
    lines = []
    spans.print_table(red, "synthetic", out=lines.append)
    assert any("fvgp.sparse_lml.backward" in line for line in lines)


def test_program_annotations_never_enter_kernels():
    """The device-side copy of a program span is no work, for the span
    reducer and for ``trace.py``'s device list alike (with and without
    the event's activity kind)."""
    class NoKind(Ev):
        activity_type = None

    class Prof:
        def __init__(self, evs):
            self.profiler = type("P", (), {"kineto_results": type(
                "K", (), {"events": staticmethod(lambda: evs)})})

    for evs in (events(), [NoKind(*e._v) for e in events()]):
        _, _, device = spans.records(evs)
        assert all(not d[0].startswith("fvgp.") for d in device)
        dev, host, marks = trace._events(Prof(evs))
        assert all(not d[0].startswith("fvgp.") for d in dev)
        assert {d[0] for d in dev} == {d[0] for d in device}
        assert len(marks) == 2


def test_idle_agrees_with_the_trace_reducer():
    """One reducer: the span reducer's window and idle time are those of
    ``trace.py``'s union of device intervals over the requests."""
    evs = events()
    red = spans.reduce(*spans.records(evs))
    device = [(e.name(), e.start_ns(), e.end_ns()) for e in evs
              if e.device_type() == CUDA and e.activity_type() in
              trace.DEVICE_ACTIVITIES]
    busy = trace._union(device, 0, 150)
    assert red["idle_ns"] == 150 - sum(e - s for s, e in busy)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    return toy_checkout(tmp_path_factory.mktemp("toy"))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _traced(root, name):
    return bench.run_cell(spec(root), name, SEED, 0.5, True, "cpu",
                          time.perf_counter())


def test_counter_metrics_in_traced_toy_runs(toy):
    """Per traced request: three host syncs in a dense step (the factor's
    info, the value, the gradient) and in a prediction (the mean's
    product and prior mean, the variance); in a gp2Scale step one per exit
    test of the mBCG loop plus three."""
    m = _traced(toy, "dense-train")["metrics"]
    assert m["host_syncs.dense"]["value"] == 3
    m = _traced(toy, "dense-predict")["metrics"]
    assert m["host_syncs.predict"]["value"] == 3
    m = _traced(toy, "gp2scale-train")["metrics"]
    it = m["cg_iters"]["value"]
    assert 0 < it <= 32 and it == int(it)
    assert m["host_syncs.gp2scale"]["value"] == it + (it < 32) + 3


def test_a_program_without_counters_reads_none(toy, monkeypatch):
    """An older program (no ``utils.trace``): no counters are named, the
    traced run still completes, and its line leaves the metrics out."""
    monkeypatch.setitem(sys.modules, program_counters.PROGRAM, None)
    assert program_counters.named("host_syncs") == {}
    r = _traced(toy, "dense-train")
    assert r["correct"] and "host_syncs.dense" not in r["metrics"]
    assert "dense_linalg_ms" in r["metrics"]
