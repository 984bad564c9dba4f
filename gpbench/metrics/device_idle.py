"""device_idle.<variant> (%): 1 − (the union of the device's kernel, copy
and fill intervals) / (the traced sub-window's length), over the traced
requests under ``torch.profiler``.  Each variant moves the end-to-end
metric of its own cells."""


def read(ctx):
    p = ctx.profile
    if not p["window_ns"]:
        return None
    return 100.0 * (1.0 - p["busy_ns"] / p["window_ns"])
