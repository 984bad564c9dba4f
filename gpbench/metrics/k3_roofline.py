"""k3_roofline (%): K3's bound over K3's device time in the traced
requests.

K3's device time: every kernel whose name holds ``dense_cov_kernel``.
The bound: per traced request, the one cross-covariance k(X, x*) it needs,
N × n at the request's n (``counts/k3.py``, float32), whatever number of
launches the program makes (its counter
``hopper_kernels.dense_covariance.launches`` only decides whether the
request reached K3 at all)."""

KERNEL = "dense_cov_kernel"
COUNTERS = {"k3": ("fvgp_tpu_torch.ops.hopper_kernels", "dense_covariance")}


def read(ctx):
    p = ctx.profile
    t = sum(e - s for n, s, e in p["kernels"] if KERNEL in n) * 1e-9
    if t <= 0:
        return None
    N, D = int(ctx.config["data"]["n"]), int(ctx.config["data"]["dim"])
    k3 = ctx.count("k3")
    bound = sum(k3.bound_s(N, len(r["xq"]), D)
                for r, c in zip(p["requests"], p["counters"]) if c["k3"])
    return 100.0 * bound / t
