"""The port's disk cache of the gp2Scale structure pass
(``utils/structure_cache``): a second cold model on the same data and a
cache directory finds its candidate tile pairs, liveness and committed
structure on disk and runs with the structure producers made to raise —
for the marginal likelihood and for a posterior-only model — and a
posterior after training reuses the training pass's structure."""

import os
import warnings

import numpy as np
import pytest
import torch

import fvgp_tpu_torch.native as native
import fvgp_tpu_torch.parallel.ordering as ordering
import fvgp_tpu_torch.parallel.sharded_cov as shc
from fvgp_tpu_torch import GP

N, D, B = 1200, 3, 64
HPS = np.array([1.0, 2.0, 2.0, 2.0])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (the suite's parallel
    workers would oversubscribe the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _gp(cache):
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 16, (N, D))
    y = np.sin(x[:, 0]) + 0.05 * rng.standard_normal(N)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return GP(x, y, init_hyperparameters=HPS,
                  noise_variances=np.full(N, 1e-2), gp2Scale=True,
                  compute_device="cpu", linalg_mode="sparseCGpre",
                  args={"gp2Scale_block_size": B,
                        "gp2Scale_structure_cache_dir": cache})


def _call(gp, what):
    if what == "lml":
        return np.asarray(gp.marginal_likelihood
                          .log_likelihood_value_and_gradient(HPS)[1])
    xp = np.random.default_rng(7).uniform(0, 16, (9, D))
    return np.asarray(gp.posterior_mean(xp)["m(x)"])


def _kinds(path):
    return sorted({f.split("-")[0] for f in os.listdir(path)
                   if f.endswith(".npz")})


def _recomputing_raises(monkeypatch, morton=True):
    def boom(*a, **k):
        raise AssertionError("structure recomputed")
    monkeypatch.setattr(shc, "_candidate_pairs", boom)
    monkeypatch.setattr(native, "tile_live", boom)
    if morton:
        monkeypatch.setattr(ordering, "morton_order", boom)


@pytest.mark.parametrize("what,kinds", [
    ("lml", ["candidates", "liveness", "morton"]),
    ("posterior", ["morton", "tile_structure"])])
def test_a_cold_model_reads_its_structure_from_disk(tmp_path, monkeypatch,
                                                    what, kinds):
    first = _call(_gp(str(tmp_path)), what)
    assert _kinds(tmp_path) == kinds
    _recomputing_raises(monkeypatch)
    np.testing.assert_array_equal(_call(_gp(str(tmp_path)), what), first)


def test_the_posterior_reuses_the_training_structure(monkeypatch):
    reference = _call(_gp(False), "posterior")
    gp = _gp(False)
    _call(gp, "lml")
    _recomputing_raises(monkeypatch, morton=False)
    np.testing.assert_array_equal(_call(gp, "posterior"), reference)
