"""The program's own counters (``fvgp_tpu_torch.utils.trace.counters()``),
read the way the traced sub-window reads a kernel's launch counter: a
metric's ``COUNTERS`` maps a key to (this module, an attribute of it), and
``trace.read_counters`` takes that attribute's ``launches`` before and
after each traced request.

A program without the counters module (one older than its spans and
counters) gives a metric no ``COUNTERS`` here, so its reader finds nothing
and returns ``None``."""

import importlib

PROGRAM = "fvgp_tpu_torch.utils.trace"


def _program():
    try:
        return importlib.import_module(PROGRAM)
    except ImportError:
        return None


class ProgramCounter:
    """One program counter; ``launches`` is its current value."""

    def __init__(self, name):
        self.name = name

    @property
    def launches(self):
        return _program().counters().get(self.name, 0)


# the counters the metrics read
mbcg_iterations = ProgramCounter("mbcg_iterations")
host_syncs = ProgramCounter("host_syncs")


def named(*names):
    """A metric's ``COUNTERS`` for the program counters ``names``: empty
    where the program has no counters module."""
    if _program() is None:
        return {}
    return {n: (__name__, n) for n in names}


def per_request(ctx, name):
    """The mean of counter ``name`` over the traced requests, or ``None``
    where it was not read."""
    counts = [c[name] for c in ctx.profile["counters"] if name in c]
    if not counts or len(counts) != len(ctx.profile["requests"]):
        return None
    return sum(counts) / len(counts)
