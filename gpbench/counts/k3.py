"""K3 (``dense_covariance``): K = σ²·poly(‖(x1 − x2)/ℓ‖) of an n1×n2
block, D input dimensions.

Bytes: both point sets and the hyperparameters read once, the output
written once.  Operations: 3D + 7 per element (differences, scaling,
squares and sums, the square root, the polynomial and the exponential,
the variance), against the plain (non-tensor-core) peak of the dtype."""

from . import peaks

ITEM = {"float32": 4, "float64": 8}


def bound_s(n1, n2, D, dtype="float32"):
    s = ITEM[dtype]
    n_bytes = (n1 + n2) * D * s + (1 + D) * s + n1 * n2 * s
    return peaks.bound_s(n_bytes, n1 * n2 * (3 * D + 7), dtype)
