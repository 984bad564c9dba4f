"""The dense exact GP as a whole: the same seeded data through the JAX
``GP`` and, via ``gp_from_numpy_state``, the port's ``GP`` (CPU, float64):
LML, gradient, Hessian, posterior mean, full covariance and variance in the
``Chol``, ``CholInv`` and ``Inv`` modes, ``add_noise``, the append path,
the batched population objective and the three training methods — all at
1e-8."""

import warnings

import numpy as np
import pytest
import torch

from fvgp_tpu import GP as JaxGP
from fvgp_tpu_torch import GP, gp_from_numpy_state

TOL = 1e-8
MODES = ("Chol", "CholInv", "Inv")


def _data(dim, n):
    rng = np.random.default_rng(100 + dim)
    x = rng.uniform(0, 6, (n, dim))
    y = np.sin(x[:, 0]) + 0.5 * np.cos(x[:, -1]) \
        + 0.05 * rng.standard_normal(n)
    xp = rng.uniform(0, 6, (30, dim))
    return x, y, xp


def _hps(dim):
    return np.concatenate([[1.3], np.linspace(1.1, 1.9, dim)])


def _pair(dim, mode="Chol", n=None, **kw):
    """(JAX GP, port GP) on the same data, the port built from the JAX
    model's public state."""
    x, y, _ = _data(dim, n or (120 if dim == 1 else 300))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jgp = JaxGP(x, y, init_hyperparameters=_hps(dim), linalg_mode=mode,
                    **kw)
        state = {"x_data": np.asarray(jgp.x_data),
                 "y_data": np.asarray(jgp.y_data),
                 "noise_variances": jgp.noise_variances,
                 "hyperparameters": np.asarray(jgp.hyperparameters),
                 "args": {}, "gp2Scale": False, "linalg_mode": mode}
        tgp = gp_from_numpy_state(state, compute_device="cpu")
    return jgp, tgp


@pytest.fixture(scope="module", params=[1, 3], ids=["1d", "3d"])
def chol_pair(request):
    return request.param, _pair(request.param)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


def test_port_model_is_dense_on_the_cpu_in_float64(chol_pair):
    _, (_, tgp) = chol_pair
    assert not tgp.gp2Scale and tgp.kv.mode == "Chol"
    assert tgp.device.type == "cpu" and tgp.K.dtype == torch.float64


def test_lml_gradient_and_hessian_match_jax(chol_pair):
    dim, (jgp, tgp) = chol_pair
    h = _hps(dim) * 1.1
    _close(tgp.log_likelihood(h), jgp.log_likelihood(h))
    _close(tgp.log_likelihood(), jgp.log_likelihood())
    jv, jg = jgp.marginal_likelihood.log_likelihood_value_and_gradient(h)
    tv, tg = tgp.marginal_likelihood.log_likelihood_value_and_gradient(h)
    _close(tv, jv)
    _close(tg, jg)
    _close(tgp.neg_log_likelihood_gradient(h),
           jgp.neg_log_likelihood_gradient(h))
    _close(tgp.marginal_likelihood.neg_log_likelihood_hessian(h),
           jgp.marginal_likelihood.neg_log_likelihood_hessian(h))


def test_posterior_mean_matches_jax(chol_pair):
    dim, (jgp, tgp) = chol_pair
    _, _, xp = _data(dim, 1)
    got, ref = tgp.posterior_mean(xp), jgp.posterior_mean(xp)
    _close(got["m(x)"], ref["m(x)"])
    assert got["m(x)"].shape == (len(xp),)
    h = _hps(dim) * 0.9
    _close(tgp.posterior_mean(xp, hyperparameters=h)["m(x)"],
           jgp.posterior_mean(xp, hyperparameters=h)["m(x)"])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dim", [1, 3], ids=["1d", "3d"])
def test_covariance_and_variance_match_jax_in_every_mode(mode, dim):
    jgp, tgp = _pair(dim, mode)
    _, _, xp = _data(dim, 1)
    full_t, full_j = (g.posterior_covariance(xp) for g in (tgp, jgp))
    _close(full_t["S"], full_j["S"])
    _close(full_t["v(x)"], full_j["v(x)"])
    var_t, var_j = (g.posterior_covariance(xp, variance_only=True)
                    for g in (tgp, jgp))
    if mode == "Chol":       # no stored inverse: the variance is diag(S)
        _close(var_t["S"], var_j["S"])
    else:                    # the einsum against the stored inverse
        assert var_t["S"] is None and var_j["S"] is None
    _close(var_t["v(x)"], var_j["v(x)"])
    _close(tgp.log_likelihood(), jgp.log_likelihood())
    _close(tgp.posterior_mean(xp)["m(x)"], jgp.posterior_mean(xp)["m(x)"])


def _noise(x, hps):
    """A noise callable both packages can run (operators only)."""
    return 0.02 * hps[0] * (x[:, 0] * 0.0 + 1.0)


def test_add_noise_and_noise_callable_match_jax():
    x, y, xp = _data(2, 150)
    hps = _hps(2)
    out = {}
    for name, cls, extra in (("jax", JaxGP, {}),
                             ("torch", GP, {"compute_device": "cpu"})):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            gp = cls(x, y, init_hyperparameters=hps, noise_function=_noise,
                     **extra)
        vg = gp.marginal_likelihood.log_likelihood_value_and_gradient(hps)
        out[name] = (vg, gp.posterior_covariance(xp, add_noise=True),
                     gp.posterior_covariance(xp, add_noise=False))
    (jvg, jn, j0), (tvg, tn, t0) = out["jax"], out["torch"]
    _close(tvg[0], jvg[0])
    _close(tvg[1], jvg[1])
    _close(tn["v(x)"], jn["v(x)"])
    _close(tn["S"], jn["S"])
    _close(tn["v(x)"] - t0["v(x)"], np.full(len(xp), 0.02 * hps[0]))


@pytest.mark.parametrize("mode", MODES)
def test_update_gp_data_append_matches_jax(mode):
    """Measured noise keeps the old block fixed, so the rank-n update
    extends the factor (or the inverse) instead of refactorizing."""
    x, y, xp = _data(3, 260)
    nv = np.full(len(x), 4e-3)
    out = []
    for cls, extra in ((JaxGP, {}), (GP, {"compute_device": "cpu"})):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            gp = cls(x[:200], y[:200], init_hyperparameters=_hps(3),
                     noise_variances=nv[:200], linalg_mode=mode, **extra)
            gp.update_gp_data(x[200:], y[200:],
                              noise_variances_new=nv[200:], append=True)
        out.append((gp.log_likelihood(), gp.posterior_mean(xp)["m(x)"],
                    gp.posterior_covariance(xp)["v(x)"], len(gp.x_data)))
    (jl, jm, jv, jn), (tl, tm, tv, tn) = out
    assert jn == tn == 260
    _close(tl, jl)
    _close(tm, jm)
    _close(tv, jv)


def test_append_without_rank_n_update_refactorizes():
    x, y, xp = _data(1, 140)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        gp = GP(x[:100], y[:100], init_hyperparameters=_hps(1),
                compute_device="cpu")
        gp.update_gp_data(x[100:], y[100:], append=True)   # default noise
        fresh = GP(x, y, init_hyperparameters=_hps(1), compute_device="cpu")
    _close(gp.log_likelihood(), fresh.log_likelihood())
    _close(gp.posterior_mean(xp)["m(x)"], fresh.posterior_mean(xp)["m(x)"])


def test_batched_population_objective_matches_jax(chol_pair):
    dim, (jgp, tgp) = chol_pair
    P = _hps(dim)[None, :] * np.array([[1.0], [0.7], [1.4], [2.0]])
    _close(tgp.marginal_likelihood.batched_neg_log_likelihood(P),
           jgp.marginal_likelihood.batched_neg_log_likelihood(P))


def test_population_chunks_give_the_same_values(chol_pair, monkeypatch):
    dim, (_, tgp) = chol_pair
    ml = tgp.marginal_likelihood
    P = _hps(dim)[None, :] * np.linspace(0.6, 1.6, 5)[:, None]
    whole = ml.batched_neg_log_likelihood(P)
    monkeypatch.setattr(type(ml), "_population_chunk",
                        lambda self, pop: 2)
    _close(ml.batched_neg_log_likelihood(P), whole, tol=1e-12)
    _close(whole, [-ml.log_likelihood(p) for p in P])


def _bounds(dim):
    return np.array([[0.1, 5.0]] + [[0.3, 4.0]] * dim)


def test_train_local_matches_jax():
    jgp, tgp = _pair(2, n=150)
    got = tgp.train(hyperparameter_bounds=_bounds(2), method="local",
                    max_iter=40)
    ref = jgp.train(hyperparameter_bounds=_bounds(2), method="local",
                    max_iter=40)
    _close(got, ref, tol=1e-6)
    _close(tgp.hyperparameters, got)


def test_train_global_matches_jax():
    jgp, tgp = _pair(1, n=80)
    kw = dict(hyperparameter_bounds=_bounds(1), method="global",
              max_iter=3, pop_size=5)
    _close(tgp.train(**kw), jgp.train(**kw))


def test_train_mcmc_matches_jax():
    jgp, tgp = _pair(1, n=80)
    out = []
    for gp in (jgp, tgp):
        np.random.seed(5)
        out.append(gp.train(hyperparameter_bounds=_bounds(1), method="mcmc",
                            max_iter=40))
        assert gp.mcmc_info is not None
    _close(out[1], out[0])
    _close(tgp.mcmc_info["f(x)"], jgp.mcmc_info["f(x)"])


def test_vectorized_mcmc_chains_match_jax():
    jgp, tgp = _pair(1, n=80)
    kw = dict(hyperparameter_bounds=_bounds(1), method="mcmc", max_iter=20,
              mcmc_args={"n_chains": 3})
    _close(tgp.train(**kw), jgp.train(**kw))
    assert tgp.mcmc_info["n_chains"] == 3


def test_non_pd_trial_is_minus_infinity_and_nan_gradient():
    """A trial whose K+V fails the Cholesky: -inf value, NaN gradient (the
    JAX program returns NaN from a failed Cholesky)."""
    x, y, _ = _data(1, 60)
    x[1] = x[0]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        gp = GP(x, y, init_hyperparameters=_hps(1),
                noise_variances=np.full(len(x), 1e-30), compute_device="cpu",
                args={"dtype": "float32"})
        bad = np.array([1e6, 50.0])
        assert gp.log_likelihood(bad) == -np.inf
        val, grad = gp.marginal_likelihood.log_likelihood_value_and_gradient(
            bad)
    assert np.isnan(val) and np.all(np.isnan(grad))


def test_verify_recipe_runs_on_the_port():
    """The verify skill's drive recipe, on the port."""
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 10, (100, 1))
    y = np.sin(x[:, 0]) + 0.03 * rng.standard_normal(100)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        gp = GP(x, y, init_hyperparameters=np.array([1.0, 1.0]),
                compute_device="cpu")
        before = gp.log_likelihood()
        gp.train(method="local", max_iter=100)
    xp = gp.make_1d_x_pred([0, 10], res=50)
    assert gp.log_likelihood() > before + 40
    assert gp.rmse(xp, np.sin(xp[:, 0])) < 0.1
    assert gp.r2(xp, np.sin(xp[:, 0])) > 0.95
    assert gp.make_2d_x_pred([0, 1], [0, 2], resx=3, resy=4).shape == (12, 2)


def test_joint_gp_prior_matches_jax():
    jgp, tgp = _pair(2, n=60)
    _, _, xp = _data(2, 1)
    got, ref = tgp.joint_gp_prior(xp[:7]), jgp.joint_gp_prior(xp[:7])
    for key in ("K", "k", "kappa", "prior mean", "S"):
        _close(got[key], ref[key])


def test_user_kernel_and_mean_callables_match_jax():
    """4-argument kernel and 3-argument mean (arity sniffing), written with
    operators both packages run."""
    x, y, xp = _data(2, 90)

    def kernel(x1, x2, hps, args):
        d2 = ((x1[:, None, :] - x2[None, :, :]) ** 2).sum(-1)
        return hps[0] * (1.0 + d2 / hps[1] ** 2) ** (-args["power"])

    def mean(x, hps, args):
        return hps[2] * x[:, 0]

    hps = np.array([1.1, 1.7, 0.2])
    out = []
    for cls, extra in ((JaxGP, {}), (GP, {"compute_device": "cpu"})):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            gp = cls(x, y, init_hyperparameters=hps, kernel_function=kernel,
                     prior_mean_function=mean, args={"power": 1.5}, **extra)
        out.append((gp.marginal_likelihood
                    .log_likelihood_value_and_gradient(hps * 1.05),
                    gp.posterior_mean(xp)["m(x)"]))
    (jvg, jm), (tvg, tm) = out
    _close(tvg[0], jvg[0])
    _close(tvg[1], jvg[1])
    _close(tm, jm)


def test_host_kernel_value_matches_jax_and_gradient_waits():
    """A host (numpy) kernel: the LML value through the committed-mode
    trial solve matches the JAX package's; its gradient is the formula
    gradient (ROADMAP item 1.6), central differences of the kernel in both
    packages (1e-6)."""
    x, y, xp = _data(1, 70)

    def host_kernel(x1, x2, hps):
        d = np.abs(np.asarray(x1)[:, None, 0] - np.asarray(x2)[None, :, 0])
        return hps[0] * np.exp(-d / hps[1])

    hps = np.array([1.2, 1.4])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jgp = JaxGP(x, y, init_hyperparameters=hps,
                    kernel_function=host_kernel)
        tgp = GP(x, y, init_hyperparameters=hps, kernel_function=host_kernel,
                 compute_device="cpu")
    assert not tgp.prior.kernel_traceable
    _close(tgp.log_likelihood(hps * 1.1), jgp.log_likelihood(hps * 1.1))
    _close(tgp.posterior_mean(xp)["m(x)"], jgp.posterior_mean(xp)["m(x)"])
    tv, tg = tgp.marginal_likelihood.log_likelihood_value_and_gradient(hps)
    jv, jg = jgp.marginal_likelihood.log_likelihood_value_and_gradient(hps)
    _close(tv, jv)
    np.testing.assert_allclose(tg, np.asarray(jg), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", MODES)
def test_update_kv_extends_or_refactorizes_by_the_drift_check(mode):
    """update_KV extends the stored factor (or inverse) when the old-data
    block of K+V is unchanged and refactorizes when it moved; either way
    the result is that of a fresh factorization of the new K+V."""
    _, tgp = _pair(1, mode=mode, n=60)
    kv = tgp.kv
    old = kv.KV.clone()
    # new columns 0.5·(old columns 0..3): the Schur complement is 0.5·I
    B = 0.5 * old[:, :4]
    C = 0.25 * old[:4, :4] + 0.5 * torch.eye(4, dtype=old.dtype)
    grown = torch.cat([torch.cat([old, B], 1), torch.cat([B.T, C], 1)], 0)
    assert not kv._top_left_drifted(grown, 60)
    moved = grown.clone()
    moved[:60, :60] += 1e-3 * torch.eye(60, dtype=moved.dtype)
    assert kv._top_left_drifted(moved, 60)
    def close_at_scale(got, ref):    # K+V⁻¹ has entries of order 1e4
        scale = float(ref.abs().max())
        _close((got / scale).numpy(), (ref / scale).numpy())

    for KV in (grown, moved):
        kv.set_KV(old)
        kv.update_KV(KV)
        if mode != "Inv":
            close_at_scale(kv.Chol_factor, torch.linalg.cholesky(KV))
        if mode != "Chol":
            close_at_scale(kv.KVinv, torch.linalg.inv(KV))
        assert kv.KV is KV


def test_facade_methods_match_jax(chol_pair):
    """The small facade methods: the dask pair (no-ops), the deprecated
    hyperparameter accessor, the prior pdf, the gp2Scale cost model and the
    gradient self-test."""
    dim, (jgp, tgp) = chol_pair
    assert tgp.dask_client is None and jgp.dask_client is None
    marker = object()
    assert tgp.initialize_gp2Scale_dask_client(dask_client=marker) is marker
    with pytest.warns(DeprecationWarning, match="get_hyperparameters"):
        _close(tgp.get_hyperparameters(), jgp.hyperparameters)
    pdf, jpdf = tgp.get_prior_pdf(), jgp.get_prior_pdf()
    assert set(pdf) == set(jpdf)
    _close(pdf["prior covariance (K)"].numpy(), jpdf["prior covariance (K)"])
    _close(pdf["prior mean"].numpy(), jpdf["prior mean"])
    assert tgp.get_gp2Scale_exec_time(0.5, 4) == pytest.approx(
        jgp.get_gp2Scale_exec_time(0.5, 4), rel=1e-15)
    h = _hps(dim) * 1.05
    fd, an = tgp.test_log_likelihood_gradient(h, epsilon=1e-6)
    jfd, jan = jgp.test_log_likelihood_gradient(h, epsilon=1e-6)
    _close(an, jan)
    # forward differences: the LMLs' last bits over epsilon = 1e-6 and the
    # step's truncation, ~1e-5 of the gradient
    np.testing.assert_allclose(fd, jfd, rtol=1e-4)
    np.testing.assert_allclose(fd, an, rtol=1e-4)
    with pytest.raises(AssertionError):
        tgp.test_log_likelihood_gradient(list(h))
