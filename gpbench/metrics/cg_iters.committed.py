"""cg_iters.committed (iterations per request): trips of the committed
posterior solve's CG loop per traced request, the program's counter
``cg_iterations`` (``ops/sparse_lml._cg_fixed``; a trip is one product of
the operator with the columns still converging, on K2 in float32).
``None`` where the counter did not move in any traced request, or the
program has no counters."""

from gpbench.harness import program_counters, solver_counters

COUNTERS = solver_counters.named("cg_iterations")


def read(ctx):
    return program_counters.per_request(ctx, "cg_iterations") or None
