"""BASELINE config 5 — gp2Scale: a compactly supported Wendland
covariance as Morton-ordered block-sparse tiles, trained over the traced
sparse LML (the fused mBCG solver: one preconditioned CG gives the solve
and the log-determinant, with a gradient).  Because the sparse LML is
differentiable, gradient-based training (``method="local"`` / ``"adam"``)
works at scale.  The K1 kernel runs every SpMM of the training and of the
stored-K CG; on one device the committed posterior solve runs on K2.  The
size follows the device: 20,000 points on the card, 5,000 on the CPU."""

import numpy as np

from .. import GP, config
from ._cli import host, run, world_mesh

INIT = np.array([1.0, 2.0, 2.0, 2.0])
BOUNDS = np.array([[0.5, 2.0], [1.5, 4.0], [1.5, 4.0], [1.5, 4.0]])
ARGS = {"gp2Scale_block_size": 256}


def default_size(device):
    return 20_000 if config.resolve_device(device).type != "cpu" else 5_000


def data(n, neighbors=40, support=2.0):
    """Points, targets and the 5 prediction points (drawn from the same
    generator after the data, as the reference example draws them)."""
    rng = np.random.default_rng(3)
    # size the domain so each point has ~`neighbors` others inside the
    # kernel support — the regime compactly-supported covariance is for
    span = (n * 4.19 * support ** 3 / neighbors) ** (1.0 / 3.0)
    x = rng.uniform(0, span, (n, 3))
    y = np.sin(0.2 * x[:, 0]) + 0.05 * rng.standard_normal(n)
    return x, y, rng.uniform(0, span, (5, 3))


def model(n, device="cuda", args=None):
    x, y, _ = data(n)
    return GP(x, y, init_hyperparameters=INIT, gp2Scale=True,
              linalg_mode="sparseCGpre", compute_device=device,
              args={**ARGS, **(args or {})})


def numbers(gp, xp):
    return host({"lml": gp.log_likelihood(),
                 "mean": gp.posterior_mean(xp)["m(x)"],
                 "var": gp.posterior_covariance(
                     xp, variance_only=True)["v(x)"]})


def first(device="cuda", args=None, n=None):
    n = default_size(device) if n is None else n
    gp = model(n, device, args)
    gp.K                                  # the example's stored K
    return numbers(gp, data(n)[2])


def main(device="cuda", n=None, max_iter=40):
    n = default_size(device) if n is None else n
    xp = data(n)[2]
    with world_mesh(device) as mesh:
        gp = model(n, device)
        K = gp.K
        print(f"covariance: {K.tiles.shape[0]} tiles of "
              f"{K.block_size}x{K.block_size}, fill {K.sparsity():.4f}, "
              f"tiles on {K.tiles.device}, mesh of {mesh.size} rank(s)")
        start = numbers(gp, xp)
        print("LML:", start["lml"])
        # gradient-based training on the differentiable sparse LML
        gp.train(method="local", max_iter=max_iter,
                 hyperparameter_bounds=BOUNDS)
        end = numbers(gp, xp)
        print("trained hps:", gp.hyperparameters, " LML:", end["lml"])
        print("posterior mean:", np.round(end["mean"], 4))
        print("truth:        ", np.round(np.sin(0.2 * xp[:, 0]), 4))
    return {"first": start, **end, "hyperparameters": gp.hyperparameters,
            "n": n, "tiles": int(K.tiles.shape[0]), "fill": K.sparsity()}


if __name__ == "__main__":
    run(main, __doc__)
