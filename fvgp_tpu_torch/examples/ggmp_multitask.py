"""GGMP-on-fvGP — multi-task distributional regression, on the port.

Every station observes one probability density per output channel; the
mixture components are multi-task ``fvGP`` models over the task-augmented
index set (the default kernel, on K3 on the card), trained per component
and re-weighted by EM against the observed densities."""

import numpy as np

from ..models.ggmp import GGMP, gaussian_pdf, hyperparameters
from ._cli import host, run

K = 2
X_PRED = np.array([[2.5], [5.0], [7.5]])
DOMAIN = np.linspace(-6, 6, 200)


def data():
    n, n_tasks = 14, 2
    x = np.linspace(0, 10, n).reshape(-1, 1)
    # per-station, per-task bimodal PDFs whose centers drift with x
    y_data = []
    for xi in x[:, 0]:
        tasks = []
        for t in range(n_tasks):
            c = np.sin(xi) if t == 0 else np.cos(xi)
            tasks.append((DOMAIN,
                          0.5 * gaussian_pdf(DOMAIN, c - 0.6, 0.15)
                          + 0.5 * gaussian_pdf(DOMAIN, c + 0.6, 0.15)))
        y_data.append(tasks)
    return x, y_data


def model(device="cuda", args=None):
    """The mixture at its first hyperparameters: K multi-task fvGP
    components, default Matérn over the (D+1)-dim augmented index set ->
    D+2 hyperparameters each."""
    x, y_data = data()
    hps = [np.ones(3) for _ in range(K)]
    bounds = [np.tile([0.01, 10.0], (3, 1)) for _ in range(K)]
    hobj = hyperparameters(np.full(K, 1 / K), np.tile([0.0, 1.0], (K, 1)),
                           hps, bounds)
    kwargs = {"compute_device": device}
    if args:
        kwargs["args"] = dict(args)
    g = GGMP(x, y_data, hps_obj=hobj, likelihood_terms=K,
             gp_init_kwargs=kwargs)
    g.initLikelihoods()
    g.initGPs()
    return g


def numbers(g):
    """The components' summed LML (what ``train`` maximizes per
    component), and the mixture's posterior at three points."""
    return host({"lml": sum(gp.log_likelihood() for gp in g.gps),
                 "mean": g.posterior_mean(X_PRED),          # (3, n_tasks)
                 "var": g.posterior_variance(X_PRED),       # (3, n_tasks)
                 "pdf": g.posterior_pdf(X_PRED, DOMAIN)})


def first(device="cuda", args=None):
    return numbers(model(device, args))


def main(device="cuda", max_iter=60):
    g = model(device)
    start = numbers(g)
    g.train(method="local", max_iter=max_iter, weight_method="density")
    end = numbers(g)
    w = np.array([lk.weight for lk in g.likelihoods])
    print("mixture weights:", np.round(w, 3))
    for i, xi in enumerate(X_PRED[:, 0]):
        mass = end["pdf"][i].sum(axis=-1) * (DOMAIN[1] - DOMAIN[0])
        print(f"x={xi:4.1f}  mean per task {np.round(end['mean'][i], 3)}  "
              f"var per task {np.round(end['var'][i], 3)}  "
              f"pdf mass {np.round(mass, 3)}")
    return {"first": start, **end, "weights": w}


if __name__ == "__main__":
    run(main, __doc__)
