"""predict: one acquisition step of an experiment loop, the posterior mean
then the variance at n points: ``model.posterior_mean(xq)["m(x)"]`` and
``model.posterior_covariance(xq, variance_only=True)["v(x)"]``.

Mix parameters: ``sizes`` {``min``, ``max``, ``count``} and
``warmup_cycles``.  The n cycle through ``count`` sizes spaced evenly in
log between ``min`` and ``max``, each cycle in an order drawn from the
seed, so every seed asks for the same work; the points are uniform on the
data's box.  Set-up runs ``warmup_cycles`` such cycles.

Compared numbers, per answer: ``mean_rel`` = max |m − m_ref| /
max |m_ref − mean(y)| and ``var_rel`` = max |v − v_ref| / h₀ (the signal
variance).  The check's sample always holds the largest request.
"""

import numpy as np

NUMBERS = ("mean_rel", "var_rel")


def sizes(mix):
    s = mix["sizes"]
    return np.unique(np.rint(np.geomspace(s["min"], s["max"],
                                          s["count"])).astype(int))


def _points(config, r, n):
    lo, hi = config["data"]["box"]
    return {"xq": r.uniform(lo, hi, (n, config["data"]["dim"]))}


def warmup(mix, config, r):
    return [_points(config, r, int(n))
            for _ in range(int(mix["warmup_cycles"]))
            for n in r.permutation(sizes(mix))]


def requests(mix, config, r):
    every = sizes(mix)
    while True:
        for n in r.permutation(every):
            yield _points(config, r, int(n))


def call(model, req, index):
    xq = req["xq"]
    mean = model.posterior_mean(xq)["m(x)"]
    var = model.posterior_covariance(xq, variance_only=True)["v(x)"]
    return {"mean": np.asarray(mean, np.float64).reshape(-1),
            "var": np.asarray(var, np.float64).reshape(-1)}


def pick(results, k, r):
    """``k`` positions drawn from ``r``, the largest request among them."""
    pick = list(r.choice(len(results), size=min(k, len(results)),
                         replace=False))
    largest = max(range(len(results)),
                  key=lambda i: len(results[i]["req"]["xq"]))
    if largest not in pick:
        pick[-1] = largest
    return pick


def numbers(answer, ref, config, data):
    if any(np.shape(answer[k]) != np.shape(ref[k]) for k in ("mean", "var")):
        return dict.fromkeys(NUMBERS, float("inf"))
    m = float(np.mean(data["y"]))
    h0 = float(config["gp"]["init_hyperparameters"][0])
    return {"mean_rel": np.max(np.abs(answer["mean"] - ref["mean"]))
            / np.max(np.abs(ref["mean"] - m)),
            "var_rel": np.max(np.abs(answer["var"] - ref["var"])) / h0}
