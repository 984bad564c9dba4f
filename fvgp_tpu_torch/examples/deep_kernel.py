"""BASELINE config 4 — deep-kernel GP: an MLP warps the inputs of a
stationary kernel; the flattened weights ride in the hyperparameter vector
and train by multi-start (``method='hgdl'``), every gradient by autograd
through the marginal likelihood (the plain kernel formula, never K3)."""

import numpy as np

from .. import GP
from ..models.deep_kernel_network import WarpNet, make_deep_kernel
from ._cli import host, run


def data():
    """Points, targets, the first hyperparameters (the weights' draw comes
    from the data's generator, as in the reference example) and the
    prediction points."""
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 2, (80, 2))
    y = np.sin(4 * x[:, 0] * x[:, 1])          # multiplicative structure
    net = WarpNet(2, 4, 4, 2)
    init = np.concatenate([0.3 * rng.standard_normal(net.number_of_hps),
                           [1.0, 1.0]])
    xp = rng.uniform(0, 2, (10, 2))
    return x, y, init, xp


def model(device="cuda", args=None):
    x, y, init, _ = data()
    net = WarpNet(2, 4, 4, 2)
    return GP(x, y, init_hyperparameters=init,
              kernel_function=make_deep_kernel(net), compute_device=device,
              args=args)


def numbers(gp):
    xp = data()[3]
    return host({"lml": gp.log_likelihood(),
                 "mean": gp.posterior_mean(xp)["m(x)"],
                 "var": gp.posterior_covariance(
                     xp, variance_only=True)["v(x)"]})


def first(device="cuda", args=None):
    return numbers(model(device, args))


def main(device="cuda", pop_size=8, max_iter=100):
    gp = model(device)
    n_w = len(gp.hyperparameters) - 2
    print("hyperparameters (MLP weights + kernel):", n_w + 2,
          "| traceable:", gp.prior.kernel_traceable)
    start = numbers(gp)
    print("initial LML:", start["lml"])
    bounds = np.vstack([np.tile([-3.0, 3.0], (n_w, 1)),
                        [[0.01, 10.0], [0.1, 10.0]]])
    gp.train(method="hgdl", hyperparameter_bounds=bounds, pop_size=pop_size,
             max_iter=max_iter)
    end = numbers(gp)
    print("trained LML:", end["lml"])
    xp = data()[3]
    rmse = float(np.sqrt(np.mean(
        (end["mean"] - np.sin(4 * xp[:, 0] * xp[:, 1])) ** 2)))
    print("pred vs truth RMSE:", rmse)
    return {"first": start, **end, "rmse": rmse,
            "hyperparameters": gp.hyperparameters}


if __name__ == "__main__":
    run(main, __doc__)
