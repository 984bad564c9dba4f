"""The benchmark's inputs, all drawn from ``--seed``: a configuration's
data (by the maker its file names, ``data/<maker>.py``) and a traffic
mix's requests (by the request kind its file names, ``ops/<op>.py``).  The
same seed gives the same inputs; the sizes do not depend on the seed, so
two seeds ask for the same work."""

import numpy as np


def rng(seed, stream):
    """Independent streams of one run: 0 data, 1 traffic, 2 warm-up,
    3 the sample that the check compares."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def make_data(spec, config, seed):
    """The configuration's data: ``{"x", "y", "noise"}``."""
    return spec.data(config["data"]["maker"]).make(config["data"],
                                                   rng(seed, 0))


class Traffic:
    """Requests of one mix: ``warmup()`` gives those set-up runs, the
    iterator those of the window, without end."""

    def __init__(self, mix, config, seed, op):
        self.mix, self.config, self.seed, self.op = mix, config, seed, op

    def warmup(self):
        return list(self.op.warmup(self.mix, self.config, rng(self.seed, 2)))

    def __iter__(self):
        return iter(self.op.requests(self.mix, self.config,
                                     rng(self.seed, 1)))
