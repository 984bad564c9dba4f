"""lml_grad: one training step, the log marginal likelihood and its
gradient at hyperparameters h, through the call ``train(method="local")``
makes: ``model.marginal_likelihood.log_likelihood_value_and_gradient(h)``.

Mix parameters: ``walk_half_width`` w and ``warmup``.  Each request is
h = h₀ · exp(u), u uniform on [−w, w] per hyperparameter, drawn from the
seed; set-up evaluates h₀ first, then ``warmup`` such steps.

Compared numbers, per answer: ``lml_rel`` = |L − L_ref| / |L_ref| and
``grad_rel`` = max_k |g_k − g_ref,k| / max_k |g_ref,k|.
"""

import numpy as np

NUMBERS = ("lml_rel", "grad_rel")


def _h0(config):
    return np.asarray(config["gp"]["init_hyperparameters"], float)


def _walk(mix, h0, r):
    w = float(mix["walk_half_width"])
    return {"h": h0 * np.exp(r.uniform(-w, w, h0.shape))}


def warmup(mix, config, r):
    # the first evaluation at h0 builds the structure every later one reuses
    h0 = _h0(config)
    return [{"h": h0.copy()}] + [_walk(mix, h0, r)
                                 for _ in range(int(mix["warmup"]))]


def requests(mix, config, r):
    h0 = _h0(config)
    while True:
        yield _walk(mix, h0, r)


def call(model, req, index):
    """The answer on the host; ``index`` counts the model's earlier
    evaluations (the gp2Scale estimator draws its probes by it)."""
    val, grad = model.marginal_likelihood \
        .log_likelihood_value_and_gradient(req["h"])
    return {"value": float(val), "grad": np.asarray(grad, np.float64),
            "index": index}


def pick(results, k, r):
    """Positions in ``results`` (the completed ones) that the check
    compares: ``k`` drawn from ``r``."""
    return list(r.choice(len(results), size=min(k, len(results)),
                         replace=False))


def numbers(answer, ref, config, data):
    g, rg = np.asarray(answer["grad"]), np.asarray(ref["grad"])
    if g.shape != rg.shape:
        return dict.fromkeys(NUMBERS, float("inf"))
    return {"lml_rel": abs(answer["value"] - ref["value"]) / abs(ref["value"]),
            "grad_rel": np.max(np.abs(g - rg)) / np.max(np.abs(rg))}
