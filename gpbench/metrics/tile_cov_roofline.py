"""tile_cov_roofline (%): K5's bound over K5's device time in the traced
steps.

K5's device time: every kernel whose name holds ``tile_cov`` (the forward
``tile_cov_kernel`` and the VJP ``tile_cov_vjp_kernel``).  A program without
K5 launches none, and the reader gives nothing.  The bound: per traced
step, the forward's write and the VJP's read of the live tiles of the
benchmark's own structure at that step's hyperparameters, in the solver's
dtype (``counts/tile_cov.py``).  It names no program counter: a program
without K5 has none to read."""

KERNEL = "tile_cov"


def read(ctx):
    p = ctx.profile
    t = sum(e - s for n, s, e in p["kernels"] if KERNEL in n) * 1e-9
    if t <= 0:
        return None
    args = ctx.config["gp"]["args"]
    B = int(args["gp2Scale_block_size"])
    dtype = args.get("gp2Scale_solver_dtype", "float32")
    tc = ctx.count("tile_cov")
    bound = sum(tc.bound_s(ctx.reference.live_tiles(r["h"]), B, dtype)
                for r in p["requests"])
    return 100.0 * bound / t
