"""The port's spans and counters: its one tracing system.

A span names a phase of the program in the profiler's own trace.
``with span("fvgp.sparse_lml.mbcg"):`` opens a
``torch.profiler.record_function`` range while a profiler is recording, so
the phase lies in the same trace, on the same clock, as the card's
kernels, copies and fills: a stretch in which the card idles can be put
down to the innermost span around it.  With no profiler recording a span
costs one check.  Spans are named ``fvgp.<area>.<phase>`` and each marks a
phase, never a whole public call.  ``utils.logging.phase_timer`` and
``utils.timing.log_time`` are spans that also keep their debug line or
their cumulative totals.

The spans, by area:

* ``fvgp.sparse_lml``: ``structure`` (support geometry, the candidate and
  liveness caches, the schedule's check), ``candidates``,
  ``padded_inputs`` and ``liveness`` inside it on a cache miss,
  ``schedule`` inside it where the structure moved (the padded schedule
  built and uploaded), ``probes``
  (the Rademacher draw on the host and its copy to the device),
  ``assemble``, ``precond``, ``mbcg``, and ``backward`` (the gradient)
  with ``mbcg_bwd`` and ``assemble_bwd`` inside it (on autograd's thread
  on the card);
* ``fvgp.committed``: ``structure``, ``assemble``, ``solve`` (the gp2Scale
  committed-state solver);
* ``fvgp.dense_lml``: ``forward``, ``backward``;
* ``fvgp.posterior``: ``inputs``, ``cross_cov``, ``prior``, ``solve``,
  and ``cross_sweep`` (the gp2Scale mean's fused k(X, x*)ᵀ·v sweep, inside
  ``cross_cov``);
* ``fvgp.kv.factor``, ``fvgp.data.morton``, ``fvgp.ggmp.components``;
* ``fvgp.to_host``: ``config.to_numpy``'s wait, copy and widening.

A counter is a process-wide integer, always on: ``count(name, n)`` adds,
``counters()`` copies them all, ``reset()`` clears them.  The port's:

* ``mbcg_iterations``: trips of the mBCG solve's CG loop
  (``ops/sparse_lml._pcg_coeffs``);
* ``cg_iterations``: trips of the fixed CG (``ops/sparse_lml._cg_fixed``);
* ``cg_columns``: the columns its trips multiplied, summed over the trips
  (fewer than trips × width once it drops converged columns);
* ``probe_draws_native`` / ``probe_draws_fallback``: Rademacher probe
  draws (``ops/slq.rademacher_probes``, one a call) made by the native
  library's MT19937 or by ``torch.randint`` (the same bits either way);
* ``k2_wgmma_launches``: float32 K2 launches on its wgmma body
  (``ops/hopper_kernels.row_chunk_sums``; beside the launch count
  ``row_chunk_sums.launches``, which counts every K2 launch);
* ``host_syncs``: reads of a tensor's value on the host
  (``config.to_numpy``, ``config.to_float`` and the CG exit tests).
  On the card each one waits until the card has computed the value; the
  CPU counts the same points, so a call's count is the same on both;
* ``mbcg_floor_exits``: mBCG solves that stopped at the exit floor
  before the trip cap (``ops/sparse_lml._pcg_coeffs``);
* ``structure_passes``: cold candidate passes of the gp2Scale training
  structure, one each time the lengthscales leave the drift band of the
  cached candidates (``parallel/tile_structure.TileStructure.training``);
* ``schedule_rebuilds``: new padded schedules that the gp2Scale LML
  builds and uploads where the filtered structure moved
  (``GPMarginalLikelihood._sparse_structure``).
"""

import threading

from torch.autograd import _profiler_enabled
from torch.profiler import record_function

_COUNTS = {}
_LOCK = threading.Lock()


class span:
    """``with span(name):`` — a ``record_function`` range while a profiler
    is recording, else nothing."""

    __slots__ = ("name", "_range")

    def __init__(self, name):
        self.name = name
        self._range = None

    def __enter__(self):
        if _profiler_enabled():
            self._range = record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        return False


def count(name, n=1):
    """Add ``n`` to the counter ``name``."""
    with _LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + int(n)


def counters():
    """A copy of every counter, ``{name: int}``."""
    with _LOCK:
        return dict(_COUNTS)


def reset():
    """Clear every counter."""
    with _LOCK:
        _COUNTS.clear()
