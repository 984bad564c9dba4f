"""The gp2Scale structure's program counter ``structure_passes``
(``fvgp_tpu_torch.utils.trace.counters()``): cold candidate passes of the
training structure, one each time the lengthscales leave the drift band of
the cached candidates (``parallel/tile_structure.TileStructure.training``).
A metric's ``COUNTERS`` maps a key to (this module, an attribute of it), as
``program_counters.py`` does for its own.

Every gp2Scale training run makes such a pass in its set-up, so a program
that has never counted one by the time the traced steps are read does not
keep the counter (it is older than it): :func:`kept` tells the reader to
give nothing rather than a count of 0."""

from .program_counters import ProgramCounter, _program, named as _named

structure_passes = ProgramCounter("structure_passes")


def named(*names):
    """A metric's ``COUNTERS`` for ``names``: empty where the program has
    no counters module."""
    return {n: (__name__, n) for n in _named(*names)}


def kept(name):
    """Whether the program has counted ``name`` in this process."""
    program = _program()
    return program is not None and name in program.counters()
