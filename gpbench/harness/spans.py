"""The program's own spans in a profiler trace, reduced per request.

The port marks its phases with ``record_function`` ranges named
``fvgp.<area>.<phase>`` (``fvgp_tpu_torch/utils/trace.py``) while a
profiler records, and the benchmark marks each request with
``gpbench.request`` (``trace.SPAN``).  From the profiler's events this
module gives, for each request and each program span name:

* ``host_ns``: the spans' lengths on the host;
* ``self_ns``: that less the part their child spans cover (a child is a
  program span inside the span's interval, on any thread: the backward's
  phases run on autograd's thread inside the caller's span);
* ``device_ns``: the device time of the kernels, copies and fills whose
  launch lies inside the span and inside none of its children — each is
  put down to the innermost program span, by time on any thread, around
  its launch (the host runtime call of the same correlation id, else the
  host operator it is linked to);
* ``idle_ns``: the device's idle time inside the span's interval.

And for the whole traced window (first request's start to the last one's
end): the idle time, the part of it inside some program span, and the
longest idle gaps, each named by the innermost program span around its
middle.  Device intervals and the idle gaps are those of ``trace.py``:
kernels, copies and fills that are work, merged; the program's device-side
annotations are none of them.
"""

import torch

from . import trace

PREFIX = "fvgp."
OUTSIDE = "outside any program span"


def records(events):
    """(spans, launches, device) of profiler events (``prof.profiler.
    kineto_results.events()``):

    * spans: (name, start_ns, end_ns) of the host's ``fvgp.*`` and
      ``gpbench.request`` ranges;
    * launches: ({correlation id: start_ns} of the host's CUDA API calls,
      {correlation id: start_ns} of its operators and ranges) — two
      numberings, the device's work shares the first and links to the
      second;
    * device: (name, start_ns, end_ns, correlation id, linked correlation
      id) of the device's work, as ``trace._events`` picks it."""
    spans, runtime, ops, device = [], {}, {}, []
    for e in events:
        name, s, t = e.name(), int(e.start_ns()), int(e.end_ns())
        kind = getattr(e, "activity_type", None)
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            if name.startswith(PREFIX) or name == trace.SPAN:
                spans.append((name, s, t))
            api = (kind().startswith("cuda_") if kind
                   else name.startswith("cu"))
            (runtime if api else ops).setdefault(int(e.correlation_id()), s)
            continue
        note = getattr(e, "is_user_annotation", None)
        if (kind() in trace.DEVICE_ACTIVITIES if kind
                else not (note and note())) and trace._work(name) \
                and not name.startswith(PREFIX):
            device.append((name, s, t, int(e.correlation_id()),
                           int(e.linked_correlation_id())))
    return spans, (runtime, ops), device


def _innermost(spans, t):
    """The shortest of ``spans`` ((name, start, end)) holding time ``t``."""
    best = None
    for sp in spans:
        if sp[1] <= t <= sp[2] and (best is None
                                     or sp[2] - sp[1] < best[2] - best[1]):
            best = sp
    return best


def _overlap(intervals, lo, hi):
    """Length of ``intervals`` (disjoint (start, end)) inside [lo, hi]."""
    return sum(max(0, min(e, hi) - max(s, lo)) for s, e in intervals)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(spans, launches, device, top=10):
    """The per-request table and the window's idle attribution (see the
    module's docstring) of ``records``' output."""
    requests = sorted((s, e) for n, s, e in spans if n == trace.SPAN)
    if not requests:
        raise RuntimeError("the trace holds none of the benchmark's spans")
    program = [sp for sp in spans if sp[0] != trace.SPAN]
    lo, hi = requests[0][0], requests[-1][1]
    busy = trace._union([(n, s, e) for n, s, e, _, _ in device], lo, hi)
    gaps = [(s, e) for s, e in zip([lo] + [b[1] for b in busy],
                                   [b[0] for b in busy] + [hi]) if e > s]

    table = [{} for _ in requests]

    def row(i, name):
        return table[i].setdefault(name, {"count": 0, "host_ns": 0,
                                          "self_ns": 0, "device_ns": 0,
                                          "idle_ns": 0})

    def request_of(t):
        for i, (s, e) in enumerate(requests):
            if s <= t <= e:
                return i
        return None

    own = [[] for _ in requests]           # each request's program spans
    for sp in program:
        i = request_of(sp[1])
        if i is not None:
            own[i].append(sp)
    for i, mine in enumerate(own):
        for name, s, e in mine:
            r = row(i, name)
            children = _merge([(cs, ce) for _, cs, ce in mine
                               if s <= cs and ce <= e and ce - cs < e - s])
            r["count"] += 1
            r["host_ns"] += e - s
            r["self_ns"] += (e - s) - _overlap(children, s, e)
            r["idle_ns"] += _overlap(gaps, s, e)

    runtime, ops = launches
    for name, s, e, corr, linked in device:
        t = runtime.get(corr, ops.get(linked))
        if t is None or not lo <= s < hi:
            continue
        i = request_of(t)
        if i is None:
            continue
        inner = _innermost(own[i], t)
        row(i, inner[0] if inner else OUTSIDE)["device_ns"] += \
            min(e, hi) - s

    named = _merge([(s, e) for _, s, e in program])
    idle_ns = sum(e - s for s, e in gaps)
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    return {
        "window_ns": hi - lo,
        "idle_ns": idle_ns,
        "idle_named_ns": sum(_overlap(named, s, e) for s, e in gaps),
        "requests": table,
        "idle_gaps": [[(_innermost(program, (s + e) // 2) or (OUTSIDE,))[0],
                       e - s] for s, e in longest],
    }


def totals(reduced, name):
    """Per-request means of span ``name``'s row: {key: ns}, or ``None``
    where no request holds the span."""
    rows = [r[name] for r in reduced["requests"] if name in r]
    if not rows:
        return None
    n = len(reduced["requests"])
    return {k: sum(r[k] for r in rows) / n for k in rows[0]}


def print_table(reduced, label, out=print):
    """The window's idle attribution and the per-request mean of every
    span, in ms, longest host time first."""
    n = len(reduced["requests"])
    w, idle = reduced["window_ns"], reduced["idle_ns"]
    named = reduced["idle_named_ns"]
    out(f"{label}: {n} requests, window {w / 1e6:.3f} ms, device idle "
        f"{idle / 1e6:.3f} ms ({100 * idle / max(w, 1):.1f}%), inside "
        f"program spans {named / 1e6:.3f} ms "
        f"({100 * named / max(idle, 1):.1f}% of idle)")
    names = sorted({k for r in reduced["requests"] for k in r},
                   key=lambda k: -(totals(reduced, k)["host_ns"]))
    out(f"  {'span (mean per request)':<34}{'count':>7}{'host ms':>11}"
        f"{'self ms':>11}{'device ms':>11}{'idle ms':>11}")
    for k in names:
        t = totals(reduced, k)
        out(f"  {k:<34}{t['count']:>7.2f}{t['host_ns'] / 1e6:>11.3f}"
            f"{t['self_ns'] / 1e6:>11.3f}{t['device_ns'] / 1e6:>11.3f}"
            f"{t['idle_ns'] / 1e6:>11.3f}")
    for label_, ns in reduced["idle_gaps"]:
        out(f"  idle gap {ns / 1e6:9.3f} ms  in {label_}")
