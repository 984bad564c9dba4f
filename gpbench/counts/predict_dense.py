"""Operations of one dense posterior request at n points against N
committed points, D input dimensions: the cross-covariance once (4D + 6
per element, as in ``lml_grad_dense``), the mean's product with the
committed weights (2Nn), the variance's triangular solve against the
committed factor (N²n) and its column sums of squares (2Nn)."""


def ops(N, n, D):
    return N * n * (4 * D + 6) + 2 * N * n + N * N * n + 2 * N * n


def request_ops(config, req):
    """``ops`` of one request at the configuration's N and D."""
    return ops(int(config["data"]["n"]), len(req["xq"]),
               int(config["data"]["dim"]))
