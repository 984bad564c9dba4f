"""BASELINE config 2 — multi-task fvGP with a task-aware kernel (the
reference's MultiTaskTest.ipynb workflow, synthetic climate-like data), on
the port.  The task kernel is a user kernel on torch tensors on the
model's device: it takes the plain path, not K3."""

import numpy as np
import torch

from .. import fvGP
from ..kernels import get_anisotropic_distance_matrix, matern_kernel_diff1
from ._cli import host, run

INIT = np.array([1.0, 1.0, 1.0, 1.0])
TASKS = np.arange(3.0)


def mt_kernel(x1, x2, hps):
    """Task-aware kernel over the augmented index set: a spatial Matérn
    times an exponential task-similarity factor — the shape of the
    reference's mt_climate_kernel."""
    d_space = get_anisotropic_distance_matrix(x1[:, :-1], x2[:, :-1],
                                              hps[1:-1])
    d_task = torch.abs(x1[:, -1][:, None] - x2[:, -1][None, :])
    return hps[0] * matern_kernel_diff1(d_space, 1.0) \
        * torch.exp(-d_task / hps[-1])


def data():
    rng = np.random.default_rng(1)
    # "stations" with three correlated measurement channels; one channel
    # has gaps (NaN)
    x = rng.uniform(0, 5, (60, 2))
    base = np.sin(x[:, 0]) + 0.3 * np.cos(2 * x[:, 1])
    y = np.stack([base, 0.8 * base + 0.1, base ** 2], axis=1)
    y += 0.02 * rng.standard_normal(y.shape)
    y[rng.choice(60, 10, replace=False), 2] = np.nan        # missing task
    return x, y


def model(device="cuda", args=None):
    x, y = data()
    return fvGP(x, y, init_hyperparameters=INIT, kernel_function=mt_kernel,
                compute_device=device, args=args)


def numbers(f):
    """LML, the posterior mean at 5 stations and the covariance at 3, every
    task."""
    x, _ = data()
    cov = f.posterior_covariance(x[:3], x_out=TASKS)
    return host({"lml": f.log_likelihood(),
                 "mean": f.posterior_mean(x[:5], x_out=TASKS)["m(x)"],
                 "S": cov["S"], "var": cov["v(x)"]})


def first(device="cuda", args=None):
    return numbers(model(device, args))


def main(device="cuda", max_iter=100):
    f = model(device)
    print("points in the augmented index set:", f.data.point_number)
    start = numbers(f)
    bounds = np.array([[0.01, 10.0], [0.1, 10.0], [0.1, 10.0], [0.1, 10.0]])
    f.train(method="local", hyperparameter_bounds=bounds, max_iter=max_iter)
    end = numbers(f)
    print("trained hps:", f.hyperparameters, "LML:", end["lml"])
    print("posterior mean (5 points x 3 tasks):\n",
          np.round(end["mean"], 3))
    print("S shape (task-major):", end["S"].shape)
    return {"first": start, **end, "hyperparameters": f.hyperparameters}


if __name__ == "__main__":
    run(main, __doc__)
