"""Operations of one exact gp2Scale posterior request at n points against
N committed points in nb blocks of B, D input dimensions, ``tiles`` live
B×B tiles of K:

* the mean: the N × n Wendland values (per element as in
  ``lml_grad_gp2scale.element_ops``) and their product with the committed
  weights, 2Nn;
* the variance: the N × n values again, ``ITERS`` PCG iterations at n
  columns, each one product with the tiles (2·tiles·B²·n) and one
  block-Jacobi application (2·nb·B²·n), and the diagonal of k*ᵀ(K+V)⁻¹k*,
  2Nn.

This counts what the posterior needs, not what the program runs: the
iterations are fixed, so a program that needs fewer trips reads as a
faster request, not as less work."""

from .lml_grad_gp2scale import element_ops

# PCG trips of the plain reference (``reference/gp2scale_predict.py``) on
# the 500 points of the first window request of seed 0 of
# gp2scale-wendland-1m-posterior, block-Jacobi, in float64 to float32's
# exit floor (a squared relative residual of 1e-8): 20, run on an H100
ITERS = 20


def ops(N, n, D, tiles, nb, B, iters=ITERS):
    values = N * n * element_ops(D)
    solve = iters * 2 * B * B * n * (tiles + nb)
    return 2 * values + 2 * N * n + solve + 2 * N * n


def request_ops(config, req, reference):
    """``ops`` of one request at the configuration's shapes and the tiles
    live at h₀ in the reference's own structure."""
    args = config["gp"]["args"]
    B = int(args["gp2Scale_block_size"])
    N = int(config["data"]["n"])
    tiles = reference.live_tiles(config["gp"]["init_hyperparameters"])
    return ops(N, len(req["xq"]), int(config["data"]["dim"]), tiles,
               -(-N // B), B)
