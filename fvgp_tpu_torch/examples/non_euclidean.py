"""BASELINE config 3 — GP on a non-Euclidean input space (arbitrary Python
objects as points; the reference's NonEuclideanInputSpaces.ipynb
workflow), on the port.  The kernel is a numpy host callable over strings,
so the run is host-bound on any device: it prints its seconds."""

import time

import numpy as np

from .. import GP
from ._cli import host, run

SEQUENCES = ["AGCT", "AGCC", "AGTT", "TGCA", "TGCC", "CCCC", "GGGG",
             "ACGT", "AAAA", "TTTT"]
UNSEEN = ["AGGT", "TTTA"]
INIT = np.array([1.0, 2.0])


def hamming_kernel(x1, x2, hps):
    """Gram matrix over equal-length strings from Hamming distance."""
    K = np.empty((len(x1), len(x2)))
    for i, a in enumerate(x1):
        for j, b in enumerate(x2):
            d = sum(c1 != c2 for c1, c2 in zip(a, b))
            K[i, j] = np.exp(-d / hps[1])
    return hps[0] * K


def data():
    y = np.array([sum(c == "A" for c in s) + 0.5 * sum(c == "G" for c in s)
                  for s in SEQUENCES], dtype=float)
    return SEQUENCES, y


def model(device="cuda", args=None):
    x, y = data()
    return GP(x, y, init_hyperparameters=INIT, kernel_function=hamming_kernel,
              compute_device=device, args=args)


def numbers(gp):
    return host({"lml": gp.log_likelihood(),
                 "mean": gp.posterior_mean(UNSEEN)["m(x)"],
                 "var": gp.posterior_covariance(UNSEEN)["v(x)"]})


def first(device="cuda", args=None):
    return numbers(model(device, args))


def main(device="cuda", max_iter=400):
    t0 = time.perf_counter()
    gp = model(device)
    start = numbers(gp)
    print("Euclidean:", gp.data.Euclidean, "| LML:", start["lml"])
    gp.train(method="mcmc", max_iter=max_iter,
             hyperparameter_bounds=np.array([[0.1, 20.0], [0.5, 20.0]]))
    end = numbers(gp)
    print("predictions for unseen sequences:", np.round(end["mean"], 3))
    print("variances:", np.round(end["var"], 3))
    seconds = time.perf_counter() - t0
    print(f"seconds: {seconds:.3f}")
    return {"first": start, **end, "hyperparameters": gp.hyperparameters,
            "seconds": seconds}


if __name__ == "__main__":
    run(main, __doc__)
