"""structure_passes.<variant> (passes per step): cold candidate passes of
the gp2Scale training structure per traced step, the program's counter
``structure_passes`` (``parallel/tile_structure.TileStructure.training``:
one each time the step's lengthscales leave the drift band of the cached
candidates, which also runs liveness and rebuilds the schedule).  ``None``
on a program that does not keep the counter."""

from gpbench.harness import program_counters, structure_counters

COUNTERS = structure_counters.named("structure_passes")


def read(ctx):
    if not structure_counters.kept("structure_passes"):
        return None
    return program_counters.per_request(ctx, "structure_passes")
