"""The posterior and information API of the public GP: the port against
``fvgp_tpu.GP`` on the CPU in float64 — the posterior gradients, the
information-theory suite, the validation metrics, ``args["kernel_dtype"]``,
a custom ``[factor, solve, logdet]`` linalg mode and pickling.  Tolerance
1e-8, and 1e-6 absolute for the outputs that are difference quotients
(``dv/dx``, ``dS/dx``, ``d kappa/dx`` and what is built from them), which
divide a ~1e-15 disagreement of two kernel evaluations by 1e-6."""

import pickle
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

import fvgp_tpu_torch.models.gp_prior as TPRIOR
from fvgp_tpu import GP as JaxGP
from fvgp_tpu_torch import GP

TOL = 1e-8
FD_TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Small problems of many short torch ops: with the suite's workers
    sharing the cores, a full-width intra-op pool mostly waits on itself."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64), rtol=tol,
                               atol=tol)


def _dense_data():
    """The data and hyperparameters of tests/test_posterior_grads.py."""
    rng = np.random.default_rng(7)
    x = rng.uniform(0.0, 1.0, (25, 2))
    y = np.sin(3.0 * x[:, 0]) + np.cos(2.0 * x[:, 1])
    xp = np.random.default_rng(11).uniform(1.2, 1.8, (5, 2))
    return x, y, xp


def _jax_mean(x, hps):
    return 0.3 * hps[0] * jnp.sin(x[:, 0]) + x[:, 1] ** 2


def _torch_mean(x, hps):
    return 0.3 * hps[0] * torch.sin(x[:, 0]) + x[:, 1] ** 2


def _host_mean(x, hps):
    x, hps = np.asarray(x), np.asarray(hps)
    return 0.3 * hps[0] * np.sin(x[:, 0]) + x[:, 1] ** 2


def _build(cls, hps=(1.0, 0.4, 0.6), **kw):
    x, y, _ = _dense_data()
    if cls is GP:
        kw["compute_device"] = "cpu"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return cls(x, y, init_hyperparameters=np.asarray(hps),
                   noise_variances=np.full(len(x), 1e-3), **kw)


def _pair(jax_kw=None, **kw):
    """(JAX GP, port GP) on the dense data; ``jax_kw`` replaces arguments
    for the JAX side (its own user callables)."""
    return _build(JaxGP, **{**kw, **(jax_kw or {})}), _build(GP, **kw)


@pytest.fixture(scope="module")
def models():
    """Module-scoped pairs (JAX GP, port GP): the default dense model, one
    with a traceable user mean, one with a host (numpy) mean, and a
    gp2Scale model at N = 300 with 64-point tiles."""
    out = {"dense": _pair(),
           "traceable_mean": _pair(
               prior_mean_function=_torch_mean,
               jax_kw={"prior_mean_function": _jax_mean}),
           "host_mean": _pair(prior_mean_function=_host_mean)}
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 6, (300, 2))
    y = np.sin(x[:, 0]) + 0.05 * rng.standard_normal(300)
    kw = dict(init_hyperparameters=np.array([1.0, 1.5, 1.5]),
              noise_variances=np.full(300, 1e-2), gp2Scale=True,
              compute_device="cpu", linalg_mode="sparseCGpre",
              args={"gp2Scale_block_size": 64})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out["gp2Scale"] = (JaxGP(x, y, **dict(kw, args=dict(kw["args"]))),
                           GP(x, y, **dict(kw, args=dict(kw["args"]))))
    return out


def _xp(name):
    if name == "gp2Scale":
        return np.random.default_rng(5).uniform(0, 6, (6, 2))
    return _dense_data()[2]


@pytest.mark.parametrize("name", ["dense", "traceable_mean", "host_mean",
                                  "gp2Scale"])
@pytest.mark.parametrize("direction", [None, 1])
def test_posterior_mean_grad_matches_jax(models, name, direction):
    jgp, tgp = models[name]
    xp = _xp(name)
    want = jgp.posterior_mean_grad(xp, direction=direction)
    got = tgp.posterior_mean_grad(xp, direction=direction)
    assert got["direction"] == want["direction"]
    assert got["dm/dx"].shape == np.asarray(want["dm/dx"]).shape
    # the host mean's derivative is a forward difference at 1e-6
    _close(got["dm/dx"], want["dm/dx"],
           FD_TOL if name == "host_mean" else TOL)


def test_posterior_mean_grad_at_trial_hyperparameters(models):
    jgp, tgp = models["dense"]
    hps = np.array([1.3, 0.5, 0.7])
    _close(tgp.posterior_mean_grad(_xp("dense"), hyperparameters=hps,
                                   direction=0)["dm/dx"],
           jgp.posterior_mean_grad(_xp("dense"), hyperparameters=hps,
                                   direction=0)["dm/dx"])


# the covariance and its gradient do not read the prior mean
@pytest.mark.parametrize("name", ["dense", "gp2Scale"])
@pytest.mark.parametrize("direction", [None, 0])
def test_posterior_covariance_grad_matches_jax(models, name, direction):
    jgp, tgp = models[name]
    xp = _xp(name)
    want = jgp.posterior_covariance_grad(xp, direction=direction)
    got = tgp.posterior_covariance_grad(xp, direction=direction)
    assert set(got) == set(want)
    for key in ("dv/dx", "dS/dx") if direction is not None else ("dv/dx",):
        assert got[key].shape == np.asarray(want[key]).shape
        _close(got[key], want[key], FD_TOL)


def test_gradients_summed_over_data_chunks(models, monkeypatch):
    """The (∂k/∂x)ᵀ v sweep over row chunks of the data gives the one-pass
    product (patched to 64-row chunks: five at N = 300)."""
    jgp, tgp = models["gp2Scale"]
    xp = _xp("gp2Scale")
    monkeypatch.setattr(TPRIOR, "_CROSS_ROWS", 64)
    _close(tgp.posterior_mean_grad(xp)["dm/dx"],
           jgp.posterior_mean_grad(xp)["dm/dx"])
    _close(tgp.posterior_covariance_grad(xp, direction=1)["dS/dx"],
           jgp.posterior_covariance_grad(xp, direction=1)["dS/dx"], FD_TOL)


def test_d_kernel_dx_is_exact_and_zero_on_the_diagonal(models):
    """Forward-mode AD of the default kernel: the central difference of
    k(x1, x2) agrees, and the derivative at distance 0 is 0 (the safe
    square root), as in the JAX package."""
    jgp, tgp = models["dense"]
    x, _, xp = _dense_data()
    got = tgp.prior.d_kernel_dx(xp, x, 1, tgp.hyperparameters)
    _close(got, jgp.prior.d_kernel_dx(xp, x, 1, jgp.hyperparameters))
    h = 1e-6
    x1, x2 = xp.copy(), xp.copy()
    x1[:, 1] += h
    x2[:, 1] -= h
    fd = (tgp.prior.compute_covariances(x1, x, tgp.hyperparameters)
          - tgp.prior.compute_covariances(x2, x, tgp.hyperparameters)) / (2 * h)
    _close(got, fd, 1e-7)
    diag = tgp.prior.d_kernel_dx(x[:4], x[:4], 0, tgp.hyperparameters)
    assert torch.all(torch.diagonal(diag) == 0.0)


def _task_pair():
    """A GP over (x, task) inputs with two tasks, set up as multi-task data
    in both packages, so the posterior takes ``x_out``."""
    rng = np.random.default_rng(9)
    x = rng.uniform(0, 1, (20, 2))
    xt = np.vstack([np.column_stack([x, np.zeros(20)]),
                    np.column_stack([x, np.ones(20)])])
    y = np.concatenate([np.sin(3 * x[:, 0]), np.cos(2 * x[:, 1])])
    hps = np.array([1.0, 0.4, 0.6, 2.0])
    x_out = np.array([0.0, 1.0])
    pair = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for cls, kw in ((JaxGP, {}), (GP, {"compute_device": "cpu"})):
            gp = cls(xt, y, init_hyperparameters=hps,
                     noise_variances=np.full(40, 1e-3), **kw)
            gp.data.set_fvgp_data(x, y, None, x_out)
            pair.append(gp)
    return pair


def test_gradients_with_x_out_match_jax():
    jgp, tgp = _task_pair()
    xp = np.random.default_rng(2).uniform(0.2, 0.8, (4, 2))
    for direction in (None, 0):
        got = tgp.posterior_mean_grad(xp, direction=direction)["dm/dx"]
        want = jgp.posterior_mean_grad(xp, direction=direction)["dm/dx"]
        assert got.shape == np.asarray(want).shape
        _close(got, want)
        got = tgp.posterior_covariance_grad(xp, direction=direction)
        want = jgp.posterior_covariance_grad(xp, direction=direction)
        for key in got:
            if key != "x":
                assert got[key].shape == np.asarray(want[key]).shape
                _close(got[key], want[key], FD_TOL)


@pytest.mark.parametrize("direction", [0, 1])
def test_joint_gp_prior_grad_matches_jax(models, direction):
    jgp, tgp = models["traceable_mean"]
    xp = _xp("dense")
    got = tgp.joint_gp_prior_grad(xp, direction)
    want = jgp.joint_gp_prior_grad(xp, direction)
    assert set(got) == set(want)
    _close(got["x"], want["x"])
    _close(got["K"], want["K"])
    _close(got["dk/dx"], want["dk/dx"])
    for key in ("d kappa/dx", "d prior mean/x", "dS/dx"):
        _close(got[key], want[key], FD_TOL)


def _comparison(n, seed=4):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    return rng.standard_normal(n), A @ A.T / n + 0.5 * np.eye(n)


INFO = {
    "joint_gp_prior": lambda gp, xp: gp.joint_gp_prior(xp),
    "gp_entropy": lambda gp, xp: gp.gp_entropy(xp),
    "gp_entropy_grad": lambda gp, xp: gp.gp_entropy_grad(xp, 1),
    "gp_kl_div": lambda gp, xp: gp.gp_kl_div(xp, *_comparison(len(xp))),
    "gp_mutual_information": lambda gp, xp: gp.gp_mutual_information(xp),
    "gp_mutual_information_noise": lambda gp, xp: gp.gp_mutual_information(
        xp, add_noise=True),
    "gp_total_correlation": lambda gp, xp: gp.gp_total_correlation(xp),
    "gp_relative_information_entropy":
        lambda gp, xp: gp.gp_relative_information_entropy(xp),
    "gp_relative_information_entropy_set":
        lambda gp, xp: gp.gp_relative_information_entropy_set(xp[:2]),
    "posterior_probability": lambda gp, xp: gp.posterior_probability(
        xp, *_comparison(len(xp))),
}


def _compare_result(got, want, tol):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for key in want:
            _compare_result(got[key], want[key], tol)
    else:
        _close(got, want, tol)


@pytest.mark.parametrize("method", sorted(INFO))
def test_information_methods_match_jax(models, method):
    jgp, tgp = models["dense"]
    xp = _xp("dense")
    # the entropy gradient reads dS/dx, a difference quotient
    tol = FD_TOL if method == "gp_entropy_grad" else TOL
    _compare_result(INFO[method](tgp, xp), INFO[method](jgp, xp), tol)


def test_information_methods_under_gp2scale(models):
    """The posterior-side methods serve the gp2Scale model through its
    solves; the joint-prior family densifies K with the JAX package's
    warning."""
    jgp, tgp = models["gp2Scale"]
    xp = _xp("gp2Scale")
    for method in ("gp_kl_div", "gp_relative_information_entropy",
                   "posterior_probability"):
        _compare_result(INFO[method](tgp, xp), INFO[method](jgp, xp), TOL)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jgp.gp_entropy(xp)
    with pytest.warns(UserWarning, match="dense in the number of data"):
        got = tgp.gp_entropy(xp)
    _close(got, want)


def test_posterior_probability_beyond_float32_range():
    """Over 100 points of variance ~0.01 the density is ~e^96, beyond
    float32's range (~e^88): a float32 model still gives the float64 model's value
    (the exponential is taken on the host in float64)."""
    xp = np.random.default_rng(6).uniform(0.0, 1.0, (100, 2))
    m64 = _build(GP)
    m32 = _build(GP, args={"dtype": "float32"})
    mean = m64.posterior_mean(xp)["m(x)"]
    want = m64.posterior_probability(xp, mean, 0.01 * np.eye(100))
    got = m32.posterior_probability(xp, mean, 0.01 * np.eye(100))
    assert np.finfo(np.float32).max < want["probability"] < np.inf
    np.testing.assert_allclose(got["probability"], want["probability"],
                               rtol=1e-2)


def test_kl_div_warns_on_a_negative_value():
    from fvgp_tpu_torch.models.gp_posterior import GPposterior
    # an indefinite S2: log|det| is 0, tr(S2⁻¹) = 1, so the formula is -1
    with pytest.warns(UserWarning, match="Negative KL"):
        kld = GPposterior.kl_div(np.zeros(3), np.zeros(3), np.eye(3),
                                 np.diag([1.0, 1.0, -1.0]))
    assert kld == pytest.approx(1.0)


METRICS = {
    "crps": lambda gp, x, y: gp.crps(x, y),
    "rmse": lambda gp, x, y: gp.rmse(x, y),
    "nrmse": lambda gp, x, y: gp.nrmse(x, y),
    "nlpd": lambda gp, x, y: gp.nlpd(x, y),
    "r2": lambda gp, x, y: gp.r2(x, y),
    "picp": lambda gp, x, y: gp.picp(x, y, interval=0.5),
    "coverage_curve": lambda gp, x, y: gp.coverage_curve(
        x, y, intervals=[0.25, 0.5, 0.9]),
    "mpiw": lambda gp, x, y: gp.mpiw(x),
    "interval_score": lambda gp, x, y: gp.interval_score(x, y),
    "mae": lambda gp, x, y: gp.mae(x, y),
    "mape": lambda gp, x, y: gp.mape(x, y),
    "msll": lambda gp, x, y: gp.msll(x, y),
    "gaussian_1d": lambda gp, x, y: gp.gaussian_1d(y, 0.1, 0.7),
}


@pytest.mark.parametrize("metric", sorted(METRICS))
@pytest.mark.parametrize("name", ["dense", "gp2Scale"])
def test_validation_metrics_match_jax(models, metric, name):
    jgp, tgp = models[name]
    xt = _xp(name) * 0.5
    yt = np.sin(3.0 * xt[:, 0]) + np.cos(2.0 * xt[:, 1])
    got, want = METRICS[metric](tgp, xt, yt), METRICS[metric](jgp, xt, yt)
    if isinstance(want, dict):
        _close(got["target_coverage"], want["target_coverage"])
        _close(got["measured_coverage"], want["measured_coverage"])
    else:
        _close(got, want)


def test_plot_observed_vs_predicted_draws(models):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    _, tgp = models["dense"]
    xt = _xp("dense") * 0.5
    fig, ax = plt.subplots()
    tgp.plot_observed_vs_predicted(xt, np.sin(xt[:, 0]), title="t", ax=ax)
    assert len(ax.lines) >= 1 and ax.get_title() == "t"
    plt.close(fig)


def test_kernel_dtype_governs_the_dense_assembly():
    """args['kernel_dtype'] evaluates the dense kernel in that dtype and
    casts back to the linalg dtype, as the JAX package does
    (tests/test_narrow_branches.py): K moves at float32's resolution, and
    the port's float32 K is the JAX package's float32 K."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (30, 2))
    y = np.sin(3 * x[:, 0])
    hps = np.array([1.0, 1.0, 1.0])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        gp64 = GP(x, y, init_hyperparameters=hps, compute_device="cpu")
        gp32 = GP(x, y, init_hyperparameters=hps, compute_device="cpu",
                  args={"kernel_dtype": "float32"})
        jgp32 = JaxGP(x, y, init_hyperparameters=hps,
                      args={"kernel_dtype": "float32"})
    K32, K64 = gp32.prior.K.numpy(), gp64.prior.K.numpy()
    assert gp32.prior.K.dtype == torch.float64
    assert 0.0 < np.abs(K32 - K64).max() < 1e-5
    np.testing.assert_allclose(K32, np.asarray(jgp32.prior.K), rtol=0,
                               atol=1e-6)
    assert abs(gp32.log_likelihood() - gp64.log_likelihood()) < 1e-3


def _cho_factor(KV):
    return scipy.linalg.cho_factor(np.asarray(KV), lower=True)


def _cho_solve(factor, b):
    return scipy.linalg.cho_solve(factor, np.asarray(b))


def _cho_logdet(factor):
    return 2.0 * np.sum(np.log(np.diag(factor[0])))


CUSTOM = [_cho_factor, _cho_solve, _cho_logdet]


def test_custom_linalg_mode_serves_lml_posterior_and_append():
    """A user's numpy [factor, solve, logdet] takes the port's CPU tensors
    (numpy reads them) and gives what the JAX package gives: the LML at the
    committed and at trial hyperparameters, the posterior, an append, and
    the LML gradient through the formula engine (ROADMAP item 1.6)."""
    jgp, tgp = _pair(linalg_mode=CUSTOM)
    x, y, xp = _dense_data()
    for gp in (jgp, tgp):
        assert gp.kv.mode is CUSTOM
    hps = np.array([1.2, 0.5, 0.5])
    _close(tgp.log_likelihood(), jgp.log_likelihood())
    _close(tgp.log_likelihood(hps), jgp.log_likelihood(hps))
    _close(tgp.posterior_mean(xp)["m(x)"], jgp.posterior_mean(xp)["m(x)"])
    _close(tgp.posterior_covariance(xp)["S"],
           jgp.posterior_covariance(xp)["S"])
    xn = np.random.default_rng(1).uniform(0, 1, (6, 2))
    for gp in (jgp, tgp):
        gp.update_gp_data(xn, np.sin(xn[:, 0]),
                          noise_variances_new=np.full(6, 1e-3))
    _close(tgp.log_likelihood(), jgp.log_likelihood())
    _close(tgp.posterior_mean(xp)["m(x)"], jgp.posterior_mean(xp)["m(x)"])
    tv, tg = tgp.marginal_likelihood.log_likelihood_value_and_gradient(hps)
    jv, jg = jgp.marginal_likelihood.log_likelihood_value_and_gradient(hps)
    _close(tv, jv)
    _close(tg, jg)


def test_custom_linalg_mode_with_torch_callables():
    """Callables on tensors: a torch Cholesky factor, solve and logdet."""
    mode = [torch.linalg.cholesky,
            lambda L, b: torch.cholesky_solve(b.reshape(len(L), -1),
                                              L).reshape(b.shape),
            lambda L: 2.0 * torch.sum(torch.log(torch.diagonal(L)))]
    ref, tgp = _build(GP), _build(GP, linalg_mode=mode)
    xp = _dense_data()[2]
    _close(tgp.log_likelihood(), ref.log_likelihood())
    _close(tgp.posterior_covariance(xp)["v(x)"],
           ref.posterior_covariance(xp)["v(x)"])


def _no_tensor_in(blob):
    # a torch tensor pickles through torch._utils._rebuild_tensor*
    return b"_rebuild_tensor" not in blob


@pytest.mark.parametrize("name", ["dense", "gp2Scale"])
def test_pickle_round_trip(models, name):
    """A pickled GP holds host arrays and loads to the same LML and
    posterior (the gp2Scale one through its rebuilt committed solver)."""
    _, tgp = models[name]
    xp = _xp(name)
    mean = tgp.posterior_mean(xp)["m(x)"]
    var = tgp.posterior_covariance(xp, variance_only=True)["v(x)"]
    lml = tgp.log_likelihood()
    blob = pickle.dumps(tgp)
    assert _no_tensor_in(blob)
    back = pickle.loads(blob)
    assert back.device == tgp.device
    _close(back.log_likelihood(), lml)
    _close(back.posterior_mean(xp)["m(x)"], mean)
    _close(back.posterior_covariance(xp, variance_only=True)["v(x)"], var)
    _close(back.log_likelihood(tgp.hyperparameters * 1.01),
           tgp.log_likelihood(tgp.hyperparameters * 1.01))
