"""The comparison that decides ``correct``: a sample of the window's own
answers, drawn from the seed, against the plain reference of the
configuration's family for the cell's request kind
(``reference/<family>_<op>.py``), each compared number (named by the
request kind, ``ops/<op>.py``) the worst over the sample and held to the
cell's limit."""

import numpy as np

from .inputs import rng


def sample(results, op, k, seed):
    """Indices of the completed answers the check compares: ``k`` drawn
    from the seed by the request kind's rule."""
    done = [i for i, r in enumerate(results) if r["out"] is not None]
    if not done:
        return []
    pos = op.pick([results[i] for i in done], k, rng(seed, 3))
    return sorted(int(done[p]) for p in pos)


def numbers(op, answers, refs, config, data):
    """The worst of each compared number over ``answers`` against
    ``refs``; a number that is not finite reads as infinite."""
    worst = {}
    for a, ref in zip(answers, refs):
        for name, v in op.numbers(a, ref, config, data).items():
            v = float(v) if np.isfinite(v) else float("inf")
            worst[name] = max(worst.get(name, 0.0), v)
    return worst


def verdict(nums, limits, compared):
    """(correct, checks): correct when answers were compared, every limit
    has its number and none is over its limit."""
    checks = {k: {"value": nums.get(k), "limit": limits.get(k)}
              for k in sorted(set(nums) | set(limits))}
    correct = bool(compared) and set(nums) == set(limits) and all(
        c["value"] <= c["limit"] for c in checks.values())
    return correct, checks
