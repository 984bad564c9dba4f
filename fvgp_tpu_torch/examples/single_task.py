"""BASELINE config 1 — 1-D single-task GP, N~100, Matérn kernel + noise,
MAP training (the reference's SingleTaskTest.ipynb workflow), on the
port."""

import numpy as np

from .. import GP
from ._cli import host, run

INIT = np.array([1.0, 1.0])


def data():
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 10, (100, 1))
    y = np.sin(x[:, 0]) * np.exp(-0.1 * x[:, 0]) \
        + 0.03 * rng.standard_normal(100)
    return x, y


def model(device="cuda", args=None):
    x, y = data()
    return GP(x, y, init_hyperparameters=INIT, compute_device=device,
              args=args)


def numbers(gp):
    """LML, and the posterior mean and variance on the prediction grid."""
    x_pred = gp.make_1d_x_pred([0, 10], res=200)
    return host({"lml": gp.log_likelihood(),
                 "mean": gp.posterior_mean(x_pred)["m(x)"],
                 "var": gp.posterior_covariance(x_pred)["v(x)"]})


def first(device="cuda", args=None):
    """The numbers at the first hyperparameters (no training)."""
    return numbers(model(device, args))


def main(device="cuda", max_iter=200):
    gp = model(device)
    start = numbers(gp)
    print("initial LML:", start["lml"])
    gp.train(method="local", max_iter=max_iter)
    end = numbers(gp)
    print("trained hps:", gp.hyperparameters, "LML:", end["lml"])
    x_pred = gp.make_1d_x_pred([0, 10], res=200)
    truth = np.sin(x_pred[:, 0]) * np.exp(-0.1 * x_pred[:, 0])
    out = {"first": start, **end, "hyperparameters": gp.hyperparameters,
           "rmse": gp.rmse(x_pred, truth), "r2": gp.r2(x_pred, truth),
           "picp": gp.picp(x_pred, truth), "crps": gp.crps(x_pred, truth)}
    for key in ("rmse", "r2", "picp", "crps"):
        print(f"{key}:", out[key])
    return out


if __name__ == "__main__":
    run(main, __doc__)
