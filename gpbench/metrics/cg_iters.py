"""cg_iters (iterations per step): trips of the mBCG solve's CG loop per
traced step, the program's counter ``mbcg_iterations`` (one trip is one
K1 launch on the step's 17 columns, ``hopper_kernels.chunked_spmm``)."""

from gpbench.harness import program_counters

COUNTERS = program_counters.named("mbcg_iterations")


def read(ctx):
    return program_counters.per_request(ctx, "mbcg_iterations")
