"""Operations of one exact-structure gp2Scale LML + gradient evaluation
(the mBCG estimator) at ``tiles`` live B×B tiles of nb blocks, D input
dimensions, P probes and ``iters`` CG iterations.

This counts what the estimator needs, from the shapes, not what the
program chooses to run:

* assembly: per tile element the Wendland value — per dimension a
  difference, a scaling and a square (3D), D − 1 sums, a square root, and
  14 for the clamp, (1 − d)⁸, the cubic and the variance;
* backward: per element the value again, the polynomial's derivative (12),
  the chain to each of the D lengthscales (2D) and the variance (1), and
  the cotangent's product and sum for each of the D + 1 hyperparameters;
* solve: per iteration one product with the tiles, 2·tiles·B²·(1 + P), and
  one block-Jacobi application, 2·nb·B²·(1 + P); the backward's tile
  cotangents once more, 2·tiles·B²·(1 + P);
* preconditioner: per block its kernel values, a Cholesky factor (B³/3)
  and the inverse (B³).
"""


def element_ops(D):
    return 3 * D + (D - 1) + 1 + 14


def ops(tiles, nb, B, D, probes, iters):
    elems = tiles * B * B
    fwd = element_ops(D)
    bwd = fwd + 12 + 2 * D + 1 + 2 * (D + 1)
    k = 1 + probes
    solve = iters * (2 * elems * k + 2 * nb * B * B * k) + 2 * elems * k
    precond = nb * (B * B * fwd + B ** 3 / 3 + B ** 3)
    return elems * (fwd + bwd) + solve + precond


def step_ops(config, reference):
    """``ops`` at the configuration's shapes, the tiles live at h₀ in the
    reference's own structure and the configured CG cap as iterations."""
    args = config["gp"]["args"]
    B = int(args["gp2Scale_block_size"])
    nb = -(-int(config["data"]["n"]) // B)
    tiles = reference.live_tiles(config["gp"]["init_hyperparameters"])
    return ops(tiles, nb, B, int(config["data"]["dim"]),
               int(args["random_logdet_fixed_probes"]),
               int(args["sparse_cg_maxiter"]))
