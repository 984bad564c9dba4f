"""Points uniform on a box, values a sum of terms plus Gaussian noise.

Parameters: {"n", "dim", "box": [lo, hi], "y": {"terms": [...],
"noise_sd"}, "noise_variance"}.  A term is {"sin": {"dim", "freq", "amp"}}
(amp · sin(freq · x_dim)) or {"linear": {"dim", "coef"}} (coef · x_dim)."""

import numpy as np


def make(p, r):
    n, d = int(p["n"]), int(p["dim"])
    lo, hi = p["box"]
    x = r.uniform(lo, hi, (n, d))
    y = np.zeros(n)
    for term in p["y"]["terms"]:
        (kind, t), = term.items()
        if kind == "sin":
            y += t["amp"] * np.sin(t["freq"] * x[:, t["dim"]])
        elif kind == "linear":
            y += t["coef"] * x[:, t["dim"]]
        else:
            raise ValueError(f"unknown term {kind!r}")
    y += p["y"]["noise_sd"] * r.standard_normal(n)
    return {"x": x, "y": y, "noise": np.full(n, p["noise_variance"])}
