"""GPm — multi-output GP regression on a learned linear manifold, on the
port.

A 6-D input whose outputs really depend on one latent direction: GPm
learns the embedding jointly with the kernel hyperparameters by Adam on
the trace-form marginal likelihood (autograd), then predicts all outputs
with one shared solve (the default kernel's covariances, on K3 on the
card)."""

import numpy as np

from .. import GPm, config
from ._cli import host, run

W_TRUE = np.array([1.0, -0.5, 0.25, 0.0, 0.0, 0.0])


def data():
    """Training points and outputs, and the test set (drawn from the same
    generator after the training data, as the reference example draws
    it)."""
    rng = np.random.default_rng(3)
    n, d = 150, 6
    x = rng.uniform(-2, 2, (n, d))
    t = x @ W_TRUE
    y = np.stack([np.sin(t), np.cos(t), 0.5 * t], axis=1)
    y += 0.02 * rng.standard_normal(y.shape)
    x_test = rng.uniform(-2, 2, (20, d))
    tt = x_test @ W_TRUE
    y_test = np.stack([np.sin(tt), np.cos(tt), 0.5 * tt], axis=1)
    return x, y, x_test, y_test


def model(device="cuda", args=None):
    x, y, _, _ = data()
    return GPm(x, y, manifold_dim=1, compute_device=device, args=args)


def numbers(m):
    x_test = data()[2]
    return host({"lml": m.log_likelihood(),
                 "mean": m.posterior_mean(x_test),
                 "var": m.posterior_variance(x_test)})


def first(device="cuda", args=None):
    return numbers(model(device, args))


def main(device="cuda", max_iter=400):
    m = model(device)
    start = numbers(m)
    print("initial LML:", round(float(start["lml"]), 2))
    m.train(max_iter=max_iter, learning_rate=5e-2)
    end = numbers(m)
    print("trained LML:", round(float(end["lml"]), 2))
    w_learned = config.to_numpy(m.W)[:, 0]      # a tensor on the device
    cos = abs(W_TRUE @ w_learned) / (np.linalg.norm(W_TRUE)
                                     * np.linalg.norm(w_learned))
    print("alignment with the generating direction:", round(float(cos), 4))
    y_test = data()[3]
    rmse = float(np.sqrt(np.mean((end["mean"] - y_test) ** 2)))
    print("test RMSE:", round(rmse, 4),
          "| mean posterior sd:", round(float(np.sqrt(end["var"].mean())), 4))
    return {"first": start, **end, "alignment": float(cos), "rmse": rmse}


if __name__ == "__main__":
    run(main, __doc__)
