"""assembly_ms (ms per step): device time in every kernel that is neither
K1 (``segment_mma_kernel``) nor a cuSOLVER / cuBLAS routine (the patterns
of ``dense_linalg_ms``), nor a copy or fill, over the traced steps, per
step: the tile assembly and its backward recompute, as seen from outside
the program."""

from gpbench.metrics.dense_linalg_ms import is_library

K1 = "segment_mma_kernel"
COPIES = ("memcpy", "memset")


def is_assembly(name):
    low = name.lower()
    return K1 not in name and not is_library(name) \
        and not any(p in low for p in COPIES)


def read(ctx):
    p = ctx.profile
    ns = sum(e - s for n, s, e in p["kernels"] if is_assembly(n))
    return ns * 1e-6 / len(p["requests"])
