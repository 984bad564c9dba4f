"""k1_roofline (%): K1's bound over K1's device time in the traced steps.

K1's device time: every kernel whose name holds ``segment_mma_kernel``.
That body is also K4's and float32 K2's, so the reader gives nothing when
either of their launch counters moved in the traced steps.  The bound: per
traced step, the step's K1 launches (the program's counter
``hopper_kernels.chunked_spmm.launches``) times one launch's bound
(``counts/k1.py``) at the live tiles of the benchmark's own structure at
that step's hyperparameters, k = 1 + probes columns, the solver's dtype."""

KERNEL = "segment_mma_kernel"
_HK = "fvgp_tpu_torch.ops.hopper_kernels"
COUNTERS = {"k1": (_HK, "chunked_spmm"), "k2": (_HK, "row_chunk_sums"),
            "k4": (_HK, "block_spmv")}


def read(ctx):
    p = ctx.profile
    if any(c["k2"] or c["k4"] for c in p["counters"]):
        return None
    t = sum(e - s for n, s, e in p["kernels"] if KERNEL in n) * 1e-9
    if t <= 0:
        return None
    args = ctx.config["gp"]["args"]
    B = int(args["gp2Scale_block_size"])
    nb = -(-int(ctx.config["data"]["n"]) // B)
    k = 1 + int(args["random_logdet_fixed_probes"])
    dtype = args.get("gp2Scale_solver_dtype", "float32")
    k1 = ctx.count("k1")
    bound = sum(c["k1"] * k1.bound_s(ctx.reference.live_tiles(r["h"]), nb,
                                     B, k, dtype)
                for r, c in zip(p["requests"], p["counters"]) if c["k1"])
    return 100.0 * bound / t
