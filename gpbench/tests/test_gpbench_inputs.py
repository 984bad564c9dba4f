"""Each traffic mix and each configuration's data: identical for one seed,
different for two, and the same sizes for every seed."""

import itertools
import json

import numpy as np
import pytest
from gpbench_toy import REPO

from gpbench.harness.inputs import Traffic, make_data
from gpbench.harness.spec import Spec

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
SPEC = Spec(REPO)
CELLS = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]


def _load(kind, name):
    return json.loads((REPO / "gpbench" / kind / f"{name}.json").read_text())


def _traffic(traffic, config, seed):
    return Traffic(traffic, config, seed, SPEC.op(traffic["op"]))


def _draw(config, traffic, seed, k=40):
    t = _traffic(traffic, config, seed)
    reqs = t.warmup() + list(itertools.islice(iter(t), k))
    return [np.concatenate([np.ravel(v) for _, v in sorted(r.items())])
            for r in reqs]


def _same(a, b):
    return len(a) == len(b) and all(
        x.shape == y.shape and np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("config,traffic", CELLS)
def test_traffic_repeats_for_a_seed_and_differs_between_seeds(config,
                                                               traffic):
    cfg, tr = _load("configs", config), _load("traffic", traffic)
    big = 2 ** 31 + 12345
    assert _same(_draw(cfg, tr, big), _draw(cfg, tr, big))
    assert not _same(_draw(cfg, tr, big), _draw(cfg, tr, 7))


@pytest.mark.parametrize("config,traffic", CELLS)
def test_every_seed_asks_for_the_same_sizes(config, traffic):
    cfg, tr = _load("configs", config), _load("traffic", traffic)
    if tr["op"] != "predict":
        return
    every = SPEC.op("predict").sizes(tr)
    for seed in (1, 99, 2 ** 31 + 5):
        reqs = list(itertools.islice(iter(_traffic(tr, cfg, seed)),
                                     3 * len(every)))
        sizes = sorted(len(r["xq"]) for r in reqs)
        assert sizes == sorted(list(every) * 3)


def test_walk_stays_in_its_band():
    cfg = _load("configs", "gp2scale-wendland-1m")
    tr = _load("traffic", "lml-walk")
    t = _traffic(tr, cfg, 3)
    h0 = np.asarray(cfg["gp"]["init_hyperparameters"])
    warm = t.warmup()
    assert np.array_equal(warm[0]["h"], h0)
    for r in itertools.islice(iter(t), 200):
        u = np.log(r["h"] / h0)
        assert np.all(np.abs(u) <= tr["walk_half_width"])


@pytest.mark.parametrize("name", ["gp2scale-wendland-1m", "dense-matern-10k"])
def test_data_repeats_for_a_seed(name):
    cfg = _load("configs", name)
    cfg["data"]["n"] = 500
    a, b, c = (make_data(SPEC, cfg, s) for s in (2 ** 31 + 1, 2 ** 31 + 1,
                                                 4))
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["x"], c["x"])
    lo, hi = cfg["data"]["box"]
    assert a["x"].min() >= lo and a["x"].max() <= hi
