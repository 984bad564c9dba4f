"""Operations of one exact dense LML + gradient at N points, D input
dimensions, D + 1 hyperparameters:

* the covariance: per element the Matérn-3/2 value, 4D + 6 (per dimension
  a difference, a scaling, a square and a sum; the square root, √3·d,
  1 + a, the exponential, the product and the variance);
* its derivatives: per element and hyperparameter 2, and the weighted sum
  with the gradient's weights, 2 more;
* the Cholesky factor, N³/3; the inverse the gradient's trace term needs,
  2N³/3 (L⁻¹, then L⁻ᵀL⁻¹); the solve for (y − m), 2N².
"""


def ops(N, D):
    H = D + 1
    return N ** 3 / 3 + 2 * N ** 3 / 3 + 2 * N * N \
        + N * N * ((4 * D + 6) + H * 4)


def step_ops(config, reference):
    """``ops`` at the configuration's N and D."""
    return ops(int(config["data"]["n"]), int(config["data"]["dim"]))
