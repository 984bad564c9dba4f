"""Debug logging (parity target: the reference's loguru timeline,
fvgp/__init__.py:22 — disabled at import, user-enabled).

stdlib logging instead of loguru (not in the image): the
``fvgp_tpu_torch`` logger starts silenced; ``enable()`` attaches a stderr handler at DEBUG.
Hot paths log phase timings the way the reference does (LML phases,
solver timings, assembly sparsity reports) — grep-friendly one-liners.
A phase timer is also a span of ``utils.trace``, under its label.
"""

import logging
import sys
import time

from .trace import span

logger = logging.getLogger("fvgp_tpu_torch")
logger.addHandler(logging.NullHandler())
logger.setLevel(logging.WARNING)

_handler = None


def enable(level=logging.DEBUG):
    """Turn on the debug stream (the reference's ``logger.enable('fvgp')``)."""
    global _handler
    if _handler is None:
        _handler = logging.StreamHandler(sys.stderr)
        _handler.setFormatter(logging.Formatter(
            "[fvgp_tpu_torch %(asctime)s] %(message)s", datefmt="%H:%M:%S"))
        logger.addHandler(_handler)
    logger.setLevel(level)


def disable():
    """Silence the debug stream (the import-time default)."""
    global _handler
    if _handler is not None:
        logger.removeHandler(_handler)
        _handler = None
    logger.setLevel(logging.WARNING)


class phase_timer:
    """``with phase_timer('fvgp.kv.factor'):`` — a span named ``label``
    (``utils.trace.span``) that debug-logs the elapsed wall time of the
    phase (the reference's per-phase timers,
    gp_marginal_likelihood.py:157-169)."""

    def __init__(self, label):
        self.label = label
        self._span = span(label)

    def __enter__(self):
        self._span.__enter__()
        self.start = time.time()
        return self

    def __exit__(self, *exc):
        logger.debug("%s: %.4fs", self.label, time.time() - self.start)
        return self._span.__exit__(*exc)
