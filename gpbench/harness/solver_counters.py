"""The committed posterior solver's program counters
(``fvgp_tpu_torch.utils.trace.counters()``), read as
``program_counters.py`` reads its own: a metric's ``COUNTERS`` maps a key
to (this module, an attribute of it).

* ``cg_iterations``: trips of the fixed CG (``ops/sparse_lml._cg_fixed``);
* ``cg_columns``: the columns those trips multiplied, summed over them.

A program without either counter reads 0 for it; one without the counters
module gives a metric no ``COUNTERS`` here."""

from .program_counters import ProgramCounter, _program

cg_iterations = ProgramCounter("cg_iterations")
cg_columns = ProgramCounter("cg_columns")


def named(*names):
    """A metric's ``COUNTERS`` for ``names``: empty where the program has
    no counters module."""
    if _program() is None:
        return {}
    return {n: (__name__, n) for n in names}
