"""lml_grad_far: one training step far from the last, the log marginal
likelihood and its gradient at hyperparameters h through the call of
``lml_grad`` (``ops/lml_grad.py``: its ``call``, ``pick`` and compared
numbers), each step outside the structure's drift band around the one
before it.

Mix parameters: ``variance_half_width`` w, ``lengthscale_log_steps`` s
(one per lengthscale, distinct) and ``warmup``.  Each request is
h = h₀ · exp(u): u₀ (the signal variance) uniform on [−w, w], and the
lengthscales' log-steps a permutation of s, drawn from the seed and never
the same permutation twice in a row.  With s = (+0.1, 0, −0.1) two
permutations differ in at least two lengthscales by a factor e^0.1 or
more, outside a 5% band, while the support's volume, the product of the
lengthscales, stays h₀'s: every step does the same cold structure work.

Set-up evaluates h₀, then ``warmup`` such steps, the last of them at the
first permutation (in ``itertools.permutations`` order), where the
window's chain starts: the first timed step leaves the band too.
"""

import itertools

import numpy as np

from gpbench.ops.lml_grad import NUMBERS, call, numbers, pick  # noqa: F401


def _h0(config):
    return np.asarray(config["gp"]["init_hyperparameters"], float)


def permutations(mix):
    """Every order of the mix's lengthscale log-steps, as rows."""
    s = [float(v) for v in mix["lengthscale_log_steps"]]
    return np.array(list(itertools.permutations(s)))


def _next(k, n, r):
    """A permutation index drawn from ``r``, never ``k``."""
    return (k + 1 + int(r.integers(n - 1))) % n


def _step(mix, h0, perms, k, r):
    w = float(mix["variance_half_width"])
    u = np.concatenate([[r.uniform(-w, w)], perms[k]])
    return {"h": h0 * np.exp(u)}


def warmup(mix, config, r):
    # h0 builds the first structure; the warm-up chain is drawn backwards
    # from the window's starting permutation 0
    h0, perms = _h0(config), permutations(mix)
    ks = [0]
    for _ in range(int(mix["warmup"]) - 1):
        ks.insert(0, _next(ks[0], len(perms), r))
    return [{"h": h0.copy()}] + [_step(mix, h0, perms, k, r) for k in ks]


def requests(mix, config, r):
    h0, perms = _h0(config), permutations(mix)
    k = 0
    while True:
        k = _next(k, len(perms), r)
        yield _step(mix, h0, perms, k, r)
