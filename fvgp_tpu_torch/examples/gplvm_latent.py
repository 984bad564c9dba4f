"""GPLVM — learn a 1-D latent embedding of a curve observed in 5-D, then
use the full posterior suite at new latent coordinates, on the port.

Joint Adam training (latents + kernel hyperparameters + noise in one
autograd step), the L-BFGS-B and MCMC training dispatch, and posterior
mean / variance / entropy at query latents (the posteriors run the
default kernel's covariances, on K3 on the card)."""

import numpy as np

from .. import GPLVM
from ._cli import host, run

BOUNDS = np.array([[1e-2, 1e2], [1e-2, 1e2], [1e-5, 1.0]])


def data():
    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(0, np.pi, 80))           # hidden 1-D parameter
    Y = np.stack([np.sin(t), np.cos(t), np.sin(2 * t), np.cos(2 * t),
                  0.3 * t], axis=1)
    Y += 0.01 * rng.standard_normal(Y.shape)
    return t, Y


def model(device="cuda", args=None):
    return GPLVM(data()[1], latent_dim=1, compute_device=device, args=args)


def queries(m):
    z = m.latent_coordinates[:, 0]
    return np.linspace(z.min(), z.max(), 9).reshape(-1, 1)


def numbers(m, zq=None):
    """LML, and the decoded mean and variance at 9 query latents spanning
    the current embedding (or at ``zq``)."""
    zq = queries(m) if zq is None else zq
    return host({"lml": m.log_likelihood(),
                 "mean": m.posterior_mean(zq)["m(x)"],
                 "var": m.posterior_covariance(
                     zq, variance_only=True)["v(x)"]})


def first(device="cuda", args=None):
    return numbers(model(device, args))


def main(device="cuda", adam_iter=600, local_iter=100, mcmc_iter=400):
    t, Y = data()
    m = model(device)
    start = numbers(m)
    print("initial LML:", start["lml"])
    # 1) joint Adam over (latents, kernel hps, noise)
    m.train(max_iter=adam_iter)
    print("after adam:  LML:", m.log_likelihood())
    # 2) polish jointly with L-BFGS-B under a hyperparameter box
    m.train(method="local", hyperparameter_bounds=BOUNDS, max_iter=local_iter)
    print("after local: LML:", m.log_likelihood(),
          " theta:", m.get_hyperparameters())
    # 3) sample the hyperparameters by MCMC at the learned latents
    m.train(method="mcmc", hyperparameter_bounds=BOUNDS, max_iter=mcmc_iter)
    print("after mcmc:  LML:", m.log_likelihood(),
          " MAP:", m.mcmc_info["MAP"])
    # the learned latent must order the points along the hidden curve
    z = m.latent_coordinates[:, 0]
    corr = abs(np.corrcoef(np.argsort(np.argsort(z)), np.arange(len(t)))[0, 1])
    print("latent/parameter rank correlation:", round(corr, 3))
    end = numbers(m)
    print("decoded shape:", end["mean"].shape, " max posterior sd:",
          float(np.sqrt(end["var"].max())))
    entropy = m.gp_entropy(queries(m))
    print("joint-prior entropy at queries:", round(entropy, 2))
    rec = m.reconstruct()
    rel = np.linalg.norm(rec - Y) / np.linalg.norm(Y - Y.mean(axis=0))
    print("reconstruction relative error:", round(rel, 4))
    return {"first": start, **end, "rank_correlation": corr,
            "entropy": entropy, "reconstruction_error": rel}


if __name__ == "__main__":
    run(main, __doc__)
