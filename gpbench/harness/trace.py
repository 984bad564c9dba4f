"""The traced sub-window: a few requests under ``torch.profiler`` (host and
device activity), reduced to what the per-layer metrics read.

* device intervals: every kernel, copy and fill on the card, by name;
* the window: from the start of the first request's host span to the end
  of the last one's (the benchmark's own spans, ``gpbench.request``);
* busy: the union of the device intervals inside the window, so kernels
  that overlap count once;
* idle gaps: the stretches of the window with nothing on the device, each
  named by the innermost host operation that spans its middle;
* per request: the program counters the cell's metrics name, read before
  and after it.
"""

import importlib

import torch

SPAN = "gpbench.request"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
# a kernel's name in the breakdown: C++ template arguments cut after this
NAME_CHARS = 160


def read_counters(counters):
    """{name: launches} of ``counters`` ({name: (module, attribute)})."""
    out = {}
    for name, (mod, attr) in counters.items():
        out[name] = int(getattr(getattr(importlib.import_module(mod), attr),
                                "launches"))
    return out


def _events(prof):
    """(device, host, spans): lists of (name, start_ns, end_ns)."""
    device, host, spans = [], [], []
    for e in prof.profiler.kineto_results.events():
        item = (e.name(), int(e.start_ns()), int(e.end_ns()))
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            (spans if e.name() == SPAN else host).append(item)
            continue
        # the kind of activity where the event says it (newer PyTorch);
        # else every device event that is not an annotation
        kind = getattr(e, "activity_type", None)
        note = getattr(e, "is_user_annotation", None)
        if (kind() in DEVICE_ACTIVITIES if kind else not (note and note())) \
                and _work(e.name()):
            device.append(item)
    return device, host, spans


def _work(name):
    """A device event that is work: not the benchmark's span, not a
    synchronisation marker (which lasts while the device waits)."""
    return name != SPAN and "Sync" not in name


def _union(intervals, lo, hi):
    """Merged (start, end) intervals clipped to [lo, hi]."""
    merged = []
    for s, e in sorted((max(s, lo), min(e, hi)) for _, s, e in intervals
                       if e > lo and s < hi):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _label(host, t):
    """The innermost host operation spanning time ``t``."""
    best = None
    for name, s, e in host:
        if s <= t <= e and (best is None or e - s < best[1]):
            best = (name, e - s)
    return best[0] if best else "host: no operation recorded"


def profile(system, requests, counters):
    """Run ``requests`` under the profiler; returns the reduced trace."""
    from torch.profiler import ProfilerActivity, record_function
    acts = [ProfilerActivity.CPU]
    if system.device != "cpu":
        acts.append(ProfilerActivity.CUDA)
    per_request = []
    system.sync()
    with torch.profiler.profile(activities=acts) as prof:
        for req in requests:
            before = read_counters(counters)
            with record_function(SPAN):
                system.run(req)
            after = read_counters(counters)
            per_request.append({k: after[k] - before[k] for k in after})
    device, host, spans = _events(prof)
    if not spans:
        raise RuntimeError("the trace holds none of the benchmark's spans")
    lo, hi = min(s for _, s, _ in spans), max(e for _, _, e in spans)
    busy = _union(device, lo, hi)
    busy_ns = sum(e - s for s, e in busy)
    gaps = [(s, e) for s, e in zip([lo] + [b[1] for b in busy],
                                   [b[0] for b in busy] + [hi]) if e > s]
    gaps.sort(key=lambda g: g[0] - g[1])
    by_name = {}
    for name, s, e in device:
        if lo <= s < hi:
            by_name[name] = by_name.get(name, 0) + (min(e, hi) - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_ns": hi - lo,
        "busy_ns": busy_ns,
        "kernels": [(n, s, e) for n, s, e in device if lo <= s < hi],
        "ns_by_name": by_name,
        "requests": list(requests),
        "counters": per_request,
        "breakdown": {
            "device_ops": [[n[:NAME_CHARS], ns * 1e-9] for n, ns in top],
            "idle_gaps": [[_label(host, (s + e) // 2)[:NAME_CHARS],
                           (e - s) * 1e-9]
                          for s, e in gaps[:10]],
        },
    }
