"""k2_roofline (%): K2's bound over K2's device time in the traced
requests.

K2's float32 device time: every kernel whose name holds
``segment_mma_kernel``.  That body is also K1's and K4's, so the reader
gives nothing unless the traced requests launched K2 and neither K1 nor
K4 (their launch counters ``hopper_kernels.<kernel>.launches``).  The
bound (``counts/k2.py``): per traced request, the committed CG's trips
(the program's counter ``cg_iterations``) each stream the live tiles of
the benchmark's own structure at h₀, and the columns those trips
multiplied (``cg_columns``) each cost a product with the tiles and a read
and write of a column.  ``None`` on a program without those counters."""

from gpbench.harness import solver_counters

KERNEL = "segment_mma_kernel"
_HK = "fvgp_tpu_torch.ops.hopper_kernels"
COUNTERS = {"k1": (_HK, "chunked_spmm"), "k2": (_HK, "row_chunk_sums"),
            "k4": (_HK, "block_spmv"),
            **solver_counters.named("cg_iterations", "cg_columns")}


def read(ctx):
    p = ctx.profile
    c = p["counters"]
    if not c or any(r["k1"] or r["k4"] for r in c) \
            or not all(r["k2"] and r.get("cg_iterations")
                       and r.get("cg_columns") for r in c):
        return None
    t = sum(e - s for n, s, e in p["kernels"] if KERNEL in n) * 1e-9
    if t <= 0:
        return None
    args = ctx.config["gp"]["args"]
    B = int(args["gp2Scale_block_size"])
    nb = -(-int(ctx.config["data"]["n"]) // B)
    dtype = args.get("gp2Scale_posterior_solver_dtype",
                     args.get("gp2Scale_solver_dtype", "float32"))
    tiles = ctx.reference.live_tiles(ctx.config["gp"]["init_hyperparameters"])
    k2 = ctx.count("k2")
    bound = sum(k2.bound_s(tiles, nb, B, r["cg_iterations"], r["cg_columns"],
                           dtype) for r in c)
    return 100.0 * bound / t
