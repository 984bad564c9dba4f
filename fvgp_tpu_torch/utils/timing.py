"""Cumulative timing profiler (counterpart of ``fvgp_tpu/utils/timing.py``).

The ``log_time`` context manager keeps per-label cumulative totals and an
optional printer.  PyTorch returns before the card finishes, so a caller
that wants exact device timings brackets the block with
``torch.cuda.synchronize()``.  Each block is also a span of
``utils.trace`` under its label.
"""

import contextlib
import time
from collections import defaultdict

from .trace import span

_TOTALS = defaultdict(float)
_COUNTS = defaultdict(int)
_START = time.time()

ENABLED = False


def enable():
    global ENABLED
    ENABLED = True


def disable():
    global ENABLED
    ENABLED = False


@contextlib.contextmanager
def log_time(label):
    """Time a block; cumulative totals and %-of-runtime are tracked per
    label."""
    start = time.time()
    try:
        with span(label):
            yield
    finally:
        elapsed = time.time() - start
        _TOTALS[label] += elapsed
        _COUNTS[label] += 1
        if ENABLED:
            runtime = time.time() - _START
            frac = 100.0 * _TOTALS[label] / max(runtime, 1e-12)
            print(f"[fvgp_tpu_torch timing] {label}: {elapsed:.6f}s "
                  f"(total {_TOTALS[label]:.6f}s, {frac:.1f}% of runtime, "
                  f"n={_COUNTS[label]})")


def timing_report():
    """Dict of cumulative totals per label."""
    return {k: {"total_s": v, "count": _COUNTS[k]} for k, v in _TOTALS.items()}
