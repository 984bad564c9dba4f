"""dense_linalg_ms (ms per step): device time in cuSOLVER and cuBLAS
kernels (factorizations, triangular solves, matrix products) over the
traced steps, per step.  A kernel is theirs when its name holds one of
``PATTERNS`` (case-insensitive); ``assembly_ms`` leaves the same kernels
out."""

PATTERNS = ("potrf", "potrs", "trsm", "trsv", "syrk", "herk", "gemm", "gemv",
            "cublas", "cusolver", "cutlass", "xmma", "nvjet", "getrf",
            "trtri", "lauum", "magma")


def is_library(name):
    low = name.lower()
    return any(p in low for p in PATTERNS)


def read(ctx):
    p = ctx.profile
    ns = sum(e - s for n, s, e in p["kernels"] if is_library(n))
    return ns * 1e-6 / len(p["requests"])
