"""GGMP of the port against the JAX package (CPU, float64, the same seeded
densities): the copied numpy helpers give the same values on identical
input; the per-component posteriors, the batched path against the per-GP
path (in the port and in JAX), ``posterior_mean`` / ``posterior_variance``
/ ``posterior_pdf`` and the EM weights equal to 1e-8; ``local`` training
1e-6; the multi-task GGMP on ``fvGP`` components; the gp2Scale-component
skip of the batched path; component MCMC (serial at one numpy seed, and
the thread pool); pickling and ``ggmp_from_numpy_state``.  On a card
(``cuda``): the component posteriors in float32, per-GP and batched,
against the CPU in float64, with K3 launches on both paths."""

import pickle
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from fvgp_tpu_torch import ggmp as TG
from fvgp_tpu_torch.interop import ggmp_from_numpy_state

try:
    from fvgp_tpu.models import ggmp as JG
except ImportError:     # a card's machine without JAX runs the cuda cases
    JG = None

TOL = 1e-8
TRAINED = 1e-6
CPU = {"compute_device": "cpu"}

warnings.simplefilter("ignore")


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=tol, atol=tol)


def _same(got, ref):
    """Recursive equality of helper outputs (arrays to 1e-12)."""
    if isinstance(ref, dict):
        assert set(got) == set(ref)
        for key in ref:
            _same(got[key], ref[key])
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            _same(a, b)
    elif isinstance(ref, (str, bool, Path)) or ref is None:
        assert type(got) is type(ref) or isinstance(ref, Path)
        if not isinstance(ref, Path):
            assert got == ref
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(ref, np.float64),
                                   rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# the numpy helpers, on identical input
# ---------------------------------------------------------------------------

_DOM = np.linspace(-6, 6, 200)


def _mix(G, w=(0.7, 0.3)):
    return w[0] * G.gaussian_pdf(_DOM, -2, 0.3) \
        + w[1] * G.gaussian_pdf(_DOM, 2, 0.5)


def _samples(n=300, d=2, seed=0):
    rng = np.random.default_rng(seed)
    return np.vstack([rng.normal(0.0, 0.4, (n // 2, d)),
                      rng.normal(3.0, 0.6, (n - n // 2, d))])


def _em_terms(G):
    comp = np.stack([G.gaussian_pdf(_DOM, -2, 0.3),
                     G.gaussian_pdf(_DOM, 2, 0.3)])
    dx = np.abs(np.gradient(_DOM))
    mass = _mix(G) * dx
    return [(comp, mass / mass.sum()), (comp[::-1], mass / mass.sum())]


def _gmms(seed=4, n=12, K=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 2, (n, K)), rng.uniform(0.1, 1.0, (n, K)),
            rng.uniform(0, 10, (n, 2)))


def _series(n=4):
    rng = np.random.default_rng(0)
    return [np.concatenate([rng.normal(-1, 0.3, 150), rng.normal(2, 0.4, 150)])
            for _ in range(n)]


HELPERS = {
    "gaussian_pdf": lambda G, d: G.gaussian_pdf(_DOM, 0.3, 0.7),
    "normalize_density": lambda G, d: G._normalize_density(_DOM, _mix(G)),
    "normalize_zero_mass": lambda G, d: G._normalize_density(
        _DOM[:11], np.zeros(11)),
    "density_moments": lambda G, d: G._density_moments(_DOM, _mix(G)),
    "empirical_pdf": lambda G, d: G.empirical_pdf_from_samples(
        _samples(500, 1)[:, 0]),
    "fit_gmm_fixed_weights": lambda G, d: G.fit_gmm_fixed_weights(
        _DOM, _mix(G), 3),
    "w2_scalar": lambda G, d: G.gaussian_w2_squared(0.1, 1.3, -0.4, 0.7),
    "w2_multivariate": lambda G, d: G.gaussian_w2_squared(
        np.ones(2), np.array([[1.0, 0.2], [0.2, 0.5]]), np.zeros(2),
        np.array([[0.6, -0.1], [-0.1, 0.9]])),
    "hungarian": lambda G, d: G.align_gmm_components_hungarian(
        np.array([0.0, 5.0, 2.0]), np.ones(3), np.array([2.1, 5.1, 0.1]),
        np.ones(3)),
    "align_mst": lambda G, d: G.align_local_gmms(
        _gmms()[2], _gmms()[0], _gmms()[1], method="mst"),
    "align_sequence": lambda G, d: G.align_local_gmms(
        _gmms()[2], _gmms()[0], _gmms()[1], method="sequence"),
    "em_density": lambda G, d: G.optimize_weights_em_density(
        _em_terms(G), 2, max_iter=300),
    "em_samples": lambda G, d: G.optimize_weights_em_samples(
        [_samples(400, 1)[:, 0], _samples(200, 1, 1)[:, 0]],
        [np.array([0.0, 3.0])] * 2, [np.array([0.2, 0.3])] * 2, 2,
        max_iter=300),
    "density_distances": lambda G, d: (
        G.bhattacharyya_distance(_DOM, _mix(G), _mix(G, (0.4, 0.6))),
        G.kl_divergence(_DOM, _mix(G), _mix(G, (0.4, 0.6))),
        G.wasserstein_1d_density(_DOM, _mix(G), _mix(G, (0.4, 0.6))),
        G.wasserstein_1d(_DOM, _mix(G), _mix(G, (0.4, 0.6))),
        G.energy_distance(np.linspace(0, 1, 20)[None, :],
                          np.linspace(2, 3, 20)[None, :])),
    "station_gmms_cached": lambda G, d: G.fit_station_gmms_cached(
        [(_DOM, _mix(G, (w, 1 - w))) for w in (0.2, 0.5, 0.8)], 2,
        cache_dir=d),
    "station_gmms_fixed_weights_cached": lambda G, d:
        G.fit_station_gmms_fixed_weights_cached(
            _series(), np.arange(4), data_path=d, K=2, gmm_max_iter=60)[:2],
    "gmm_free_weights_diag": lambda G, d:
        G.fit_gmm_free_weights_multivariate(_samples(), 2, n_init=2),
    "gmm_free_weights_full": lambda G, d:
        G.fit_gmm_free_weights_multivariate(
            _samples(), 2, covariance_type="full", n_init=2),
    "gmm_free_weights_spherical_1d": lambda G, d:
        G.fit_gmm_free_weights_multivariate(
            _samples(d=1), 2, covariance_type="spherical", n_init=2),
    "local_gmms_multivariate": lambda G, d: G.fit_local_gmms_multivariate(
        [_samples(seed=s) for s in range(3)], 2, n_init=1),
    "em_multivariate": lambda G, d:
        G.optimize_weights_em_multivariate_samples(
            [_samples(seed=s) for s in range(2)],
            [np.array([[0.0, 0.0], [3.0, 3.0]])] * 2,
            [np.stack([0.2 * np.eye(2), 0.4 * np.eye(2)])] * 2, K=2),
    "loglik_multivariate": lambda G, d:
        G.loglik_multivariate_mixture_samples(
            _samples(), [0.4, 0.6], np.array([[0.0, 0.0], [3.0, 3.0]]),
            np.stack([0.2 * np.eye(2), 0.4 * np.eye(2)])),
    "sample_gmm": lambda G, d: G.sample_gmm_multivariate(
        [0.4, 0.6], np.array([[0.0, 0.0], [3.0, 3.0]]),
        np.stack([0.2 * np.eye(2), 0.4 * np.eye(2)]), 50, random_state=3),
    "sample_distances": lambda G, d: (
        G.energy_distance_multivariate(_samples(), _samples(seed=1) + 0.5),
        G.sliced_wasserstein_distance(_samples(), _samples(seed=1) + 0.5),
        G.mmd_rbf(_samples(), _samples(seed=1) + 0.5)),
    "containers": lambda G, d: (
        G.hyperparameters([0.5, 0.5], np.tile([0.0, 1.0], (2, 1)),
                          [np.ones(2), np.arange(3.0)],
                          [np.ones((2, 2)), np.ones((3, 2))]).vectorized_hps,
        G.NormalLikelihood(np.arange(3.0), np.ones(3), 0.5).unravel()),
}


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_numpy_helper_matches_jax(name, tmp_path):
    got = HELPERS[name](TG, tmp_path / "port")
    ref = HELPERS[name](JG, tmp_path / "jax")
    _same(got, ref)


def test_constant_mean_and_init_kwargs():
    x = torch.rand(5, 2, dtype=torch.float32)
    m = TG.constant_mean(x, torch.tensor([1.0, 2.0, 0.7], dtype=torch.float64))
    assert m.dtype == torch.float32 and m.device == x.device
    assert m.shape == (5,) and torch.allclose(m, torch.full((5,), 0.7))
    assert TG.build_gp_init_kwargs() == ({"compute_device": "cpu"}, None)
    kw, devs = TG.build_gp_init_kwargs(use_gpu=True, gpu_engine="cupy")
    assert kw == {"compute_device": "cuda", "args": {"GPU_engine": "cupy"}}
    assert devs is None


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _data(n=14):
    """Stations along a line; each observes a bimodal PDF whose modes drift
    with x."""
    x = np.linspace(0, 10, n).reshape(-1, 1)
    domain = np.linspace(-8, 12, 200)
    y = [(domain, 0.5 * TG.gaussian_pdf(domain, np.sin(xi), 0.3)
          + 0.5 * TG.gaussian_pdf(domain, 3.0 + 0.2 * xi, 0.5))
         for xi in x[:, 0]]
    return x, y


def _hps_obj(G, K):
    return G.hyperparameters(
        np.full(K, 1.0 / K), np.tile([0.0, 1.0], (K, 1)),
        [np.array([1.0, 2.0, 0.0]) for _ in range(K)],
        [np.array([[0.01, 10.0], [0.5, 10.0], [-10.0, 10.0]])
         for _ in range(K)])


def _mt_data(n=8, n_tasks=2):
    x = np.linspace(0, 10, n).reshape(-1, 1)
    domain = np.linspace(-6, 6, 160)
    y = []
    for xi in x[:, 0]:
        tasks = []
        for t in range(n_tasks):
            c = np.sin(xi) if t == 0 else np.cos(xi)
            tasks.append((domain, 0.5 * TG.gaussian_pdf(domain, c - 0.8, 0.25)
                          + 0.5 * TG.gaussian_pdf(domain, c + 0.8, 0.25)))
        y.append(tasks)
    return x, y


def _mt_hps_obj(G, K):
    return G.hyperparameters(
        np.full(K, 1.0 / K), np.tile([0.0, 1.0], (K, 1)),
        [np.ones(3) for _ in range(K)],
        [np.tile([0.01, 10.0], (3, 1)) for _ in range(K)])


def _build(G, data, hps_obj, K, parallel, **kw):
    x, y = data
    if G is TG:
        kw = {"gp_init_kwargs": {**CPU, **kw.pop("gp_init_kwargs", {})},
              **kw}
    g = G.GGMP(x, y, hps_obj=hps_obj(G, K), likelihood_terms=K,
               gp_eval_parallel=parallel, **kw)
    g.initLikelihoods()
    g.initGPs()
    return g


XP = np.linspace(-1, 11, 9).reshape(-1, 1)


@pytest.fixture(scope="module")
def models():
    """{(package, batched): GGMP} at K=3 on 14 stations, untrained."""
    return {(name, par): _build(G, _data(), _hps_obj, 3, par)
            for name, G in (("jax", JG), ("port", TG))
            for par in (False, True)}


def test_component_posteriors_batched_and_per_gp_match_jax(models):
    ref_m, ref_v = models[("jax", False)]._component_posteriors(XP)
    for key, g in models.items():
        m, v = g._component_posteriors(XP)
        assert m.shape == v.shape == (3, 9), key
        _close(m, ref_m)
        _close(v, ref_v)
        # the batched path really served the call
        assert getattr(g, "_batched_eval_count", 0) == int(key[1]), key
    tm = models[("port", True)]
    m, v = tm._component_posteriors(XP, need_var=False)
    assert v is None and tm._batched_eval_count == 2
    _close(m, ref_m)


@pytest.fixture(scope="module")
def trained():
    """{(package, batched): GGMP} after ``train("local", 5)`` with density
    EM, K=2 on 12 stations."""
    out = {}
    for name, G in (("jax", JG), ("port", TG)):
        for par in (False, True):
            g = _build(G, _data(12), _hps_obj, 2, par)
            g.train(method="local", max_iter=5, weight_max_iter=50)
            out[(name, par)] = g
    return out


def test_local_training_and_em_weights_match_jax(trained):
    ref = trained[("jax", False)]
    w_ref = [lk.weight for lk in ref.likelihoods]
    for key, g in trained.items():
        _close(g.hps_obj.vectorized_hps[2:], ref.hps_obj.vectorized_hps[2:],
               TRAINED)
        _close([lk.weight for lk in g.likelihoods], w_ref)
        _close(g.hps_obj.weights, w_ref)
    assert trained[("port", True)]._batched_eval_count >= 1


@pytest.mark.parametrize("fn", ["mean", "variance", "pdf"])
def test_mixture_posteriors_match_jax(trained, fn):
    calls = {"mean": lambda g: g.posterior_mean(XP),
             "variance": lambda g: g.posterior_variance(XP),
             "pdf": lambda g: g.posterior_pdf(XP[:4],
                                              np.linspace(-8, 12, 60))}
    ref = calls[fn](trained[("jax", False)])
    for key, g in trained.items():
        _close(calls[fn](g), ref)


def test_sample_weights_and_station_terms_match_jax(trained):
    rng = np.random.default_rng(6)
    samples = [rng.normal(np.sin(xi), 0.3, 40) for xi in _data(12)[0][:, 0]]
    out = {}
    for name in ("jax", "port"):
        g = trained[(name, True)]
        g.train(method="local", max_iter=1, weight_method="samples",
                y_samples=samples, weight_max_iter=30)
        terms, ll = (TG if name == "port" else JG) \
            .prepare_station_terms_density(g, g.hps_obj.hps)
        out[name] = ([lk.weight for lk in g.likelihoods],
                     g.hps_obj.vectorized_hps, terms, ll)
    _close(out["port"][0], out["jax"][0])
    _close(out["port"][1], out["jax"][1], TRAINED)
    for a, b in zip(out["port"][2], out["jax"][2]):
        for u, v in zip(a, b):
            _close(u, v)
    _close(out["port"][3], out["jax"][3])


def test_multitask_ggmp_on_fvgp_matches_jax():
    out = {}
    for name, G in (("jax", JG), ("port", TG)):
        for par in (False, True):
            g = _build(G, _mt_data(), _mt_hps_obj, 2, par)
            m, v = g._component_posteriors(XP[:5])
            assert m.shape == v.shape == (2, 5, 2)
            assert getattr(g, "_batched_eval_count", 0) == int(par)
            g.train(method="local", max_iter=3, weight_max_iter=30)
            out[(name, par)] = (m, v, g.posterior_mean(XP[:5]),
                                g.posterior_variance(XP[:5]),
                                g.posterior_pdf(XP[:3],
                                                np.linspace(-6, 6, 40)),
                                [lk.weight for lk in g.likelihoods])
    from fvgp_tpu_torch import fvGP
    assert all(isinstance(gp, fvGP) for gp in g.gps)
    ref = out[("jax", False)]
    for key, got in out.items():
        for a, b in zip(got, ref):
            _close(a, b, TRAINED if key != ("jax", False) else TOL)
    with pytest.raises(ValueError, match="single-task"):
        g.train(method="local", max_iter=1, weight_method="samples",
                y_samples=[np.zeros(3)] * 8)


def test_batched_path_skips_gp2scale_components():
    """gp2Scale components keep the per-GP path (the reference's rule),
    and the per-GP path agrees with JAX's."""
    kw = {"gp_init_kwargs": {"gp2Scale": True,
                             "args": {"gp2Scale_block_size": 8}}}
    g = _build(TG, _data(12), _hps_obj, 2, True, **kw)
    j = _build(JG, _data(12), _hps_obj, 2, True, **kw)
    m, v = g._component_posteriors(XP[:4])
    jm, jv = j._component_posteriors(XP[:4])
    assert getattr(g, "_batched_eval_count", 0) == 0
    assert getattr(j, "_batched_eval_count", 0) == 0
    _close(m, jm)
    _close(v, jv)


def test_batched_path_falls_back_on_mixed_kernels():
    def k1(x1, x2, hps):
        d = torch.sum((x1[:, None, :] - x2[None, :, :]) ** 2, dim=-1)
        return hps[0] * torch.exp(-0.5 * d / hps[1] ** 2)

    def k2(x1, x2, hps):
        d = torch.sqrt(torch.sum((x1[:, None, :] - x2[None, :, :]) ** 2,
                                 dim=-1) + 1e-12)
        return hps[0] * torch.exp(-d / hps[1])

    g = _build(TG, _data(10), _hps_obj, 2, True, gp_kernel_functions=[k1, k2])
    m, _ = g._component_posteriors(XP[:4])
    assert getattr(g, "_batched_eval_count", 0) == 0
    _close(m, np.stack([gp.posterior_mean(XP[:4])["m(x)"] for gp in g.gps]),
           1e-12)
    # one kernel shared by both components: the batched path serves it
    g = _build(TG, _data(10), _hps_obj, 2, True, gp_kernel_functions=[k1, k1])
    m2, v2 = g._component_posteriors(XP[:4])
    assert g._batched_eval_count == 1
    _close(m2, np.stack([gp.posterior_mean(XP[:4])["m(x)"] for gp in g.gps]))
    _close(v2, np.stack([gp.posterior_covariance(
        XP[:4], variance_only=True)["v(x)"] for gp in g.gps]))


def test_component_mcmc_matches_jax_and_runs_in_threads():
    out = []
    for G in (JG, TG):
        g = _build(G, _data(10), _hps_obj, 2, False)
        np.random.seed(3)
        out.append(G.train_component_gps_mcmc(g, g.hps_obj, n_updates_gp=30))
    for a, b in zip(*out):
        _close(a, b)
    g = _build(TG, _data(10), _hps_obj, 2, False)
    trained = TG.train_component_gps_mcmc(g, g.hps_obj, n_updates_gp=30,
                                          gp_parallel=True, gp_workers=2)
    assert len(trained) == 2
    for k, hk in enumerate(trained):
        b = np.asarray(g.hps_obj.hps_bounds[k])
        assert hk.shape == (3,) and np.all(np.isfinite(hk))
        assert np.all(hk >= b[:, 0]) and np.all(hk <= b[:, 1])
    assert torch.is_grad_enabled()


def test_init_order_and_validation():
    x, y = _data(5)
    g = TG.GGMP(x, y, hps_obj=_hps_obj(TG, 2), likelihood_terms=2,
                gp_init_kwargs=CPU)
    with pytest.raises(ValueError):
        g.initGPs()
    with pytest.raises(ValueError):
        g.posterior_mean(x)
    with pytest.raises(AssertionError):
        g.initLikelihoods(init_mean=[np.zeros(5)])
    with pytest.raises(AssertionError):
        TG.GGMP(x[:3], y, hps_obj=_hps_obj(TG, 2), likelihood_terms=2)
    g.initLikelihoods()
    g.initGPs()
    joints = g.build_pairwise_data_generating_normals(0, 1)
    assert len(joints) == 2 and joints[0]["cov"].shape == (2, 2)


def _gp_state(gp):
    state = {"x_data": np.asarray(gp.x_data), "y_data": np.asarray(gp.y_data),
             "noise_variances": np.asarray(gp.noise_variances),
             "hyperparameters": np.asarray(gp.hyperparameters),
             "args": {}, "gp2Scale": False}
    if hasattr(gp, "output_num"):
        state.update(output_num=gp.output_num, fvgp_x_data=gp.fvgp_x_data,
                     fvgp_y_data=gp.fvgp_y_data,
                     fvgp_noise_variances=gp.fvgp_noise_variances)
    return state


def _ggmp_state(g):
    return {"x_data": g.x_data, "y_data": g.y_data,
            "likelihood_terms": g.likelihood_terms,
            "weights": g.hps_obj.weights,
            "weights_bounds": g.hps_obj.weights_bounds,
            "hps": g.hps_obj.hps, "hps_bounds": g.hps_obj.hps_bounds,
            "likelihoods": [{"mean": lk.mean, "variance": lk.variance,
                             "weight": lk.weight} for lk in g.likelihoods],
            "gps": [_gp_state(gp) for gp in g.gps], "gp_eval_parallel": True}


def test_pickles_and_carries_across(trained):
    j = trained[("jax", False)]
    t = trained[("port", True)]
    count = t._batched_eval_count
    back = pickle.loads(pickle.dumps(t))
    _close(back.posterior_variance(XP), t.posterior_variance(XP), 1e-12)
    assert back._batched_eval_count == t._batched_eval_count == count + 1
    carried = ggmp_from_numpy_state(_ggmp_state(j), compute_device="cpu")
    _close(carried.posterior_mean(XP), j.posterior_mean(XP))
    _close(carried.posterior_variance(XP), j.posterior_variance(XP))
    assert carried._batched_eval_count == 2
    mt = _build(JG, _mt_data(6), _mt_hps_obj, 2, False)
    carried = ggmp_from_numpy_state(_ggmp_state(mt), compute_device="cpu")
    _close(carried.posterior_mean(XP[:3]), mt.posterior_mean(XP[:3]))


@pytest.mark.cuda
@pytest.mark.parametrize("multi_task", [False, True])
def test_component_posteriors_on_card_match_the_cpu(multi_task):
    """Card float32, per-GP and batched, against the CPU in float64: means
    1e-3 absolute, variances 1e-3 of their largest value, K3 launched on
    both card paths; the batched path against the per-GP path on the card
    at the same bounds; the batched path in float64 within 1e-8."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from fvgp_tpu_torch.ops import hopper_kernels as hk
    data, hps = ((_mt_data(150), _mt_hps_obj) if multi_task
                 else (_data(300), _hps_obj))
    ref = _build(TG, data, hps, 3, False)._component_posteriors(XP)
    out = {}
    for par in (False, True):
        g = _build(TG, data, hps, 3, par, gp_init_kwargs={
            "compute_device": "cuda"})
        before = hk.dense_covariance.launches
        out[par] = g._component_posteriors(XP)
        assert hk.dense_covariance.launches > before
        assert getattr(g, "_batched_eval_count", 0) == int(par)
    for m, v in (out[False], out[True]):
        assert np.abs(m - ref[0]).max() <= 1e-3
        assert np.abs(v - ref[1]).max() <= 1e-3 * np.abs(ref[1]).max()
    assert np.abs(out[True][0] - out[False][0]).max() <= 1e-3
    # in float64 on the card, the batched path (K3 float64) within 1e-8
    g = _build(TG, data, hps, 3, True, gp_init_kwargs={
        "compute_device": "cuda", "args": {"dtype": "float64"}})
    for a, b in zip(g._component_posteriors(XP), ref):
        _close(a, b)
