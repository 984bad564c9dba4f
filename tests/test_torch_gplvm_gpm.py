"""``GPm`` and ``GPLVM`` of the port against the JAX package (CPU,
float64, the same seeded data): the LML and its gradient, 5 Adam steps,
every posterior-suite method (equal to 1e-8), ``local`` training (1e-6),
the ``mcmc`` chain with and without ``sample_latent`` (the same steps and
MAP at one numpy seed, 1e-8), a callable method, pickling and the
``*_from_numpy_state`` carriers.  On a card (``cuda``): both models in
float64 against the CPU within 1e-8, GPm also in float32 at the dense
bounds, their posterior covariances on K3."""

import pickle
import warnings

import numpy as np
import pytest
import torch

from fvgp_tpu_torch import GPLVM, GPm
from fvgp_tpu_torch.interop import (gplvm_from_numpy_state,
                                    gpm_from_numpy_state)

try:
    from fvgp_tpu.models.gplvm import GPLVM as JaxGPLVM
    from fvgp_tpu.models.gpm import GPm as JaxGPm
except ImportError:     # a card's machine without JAX runs the cuda cases
    JaxGPLVM = JaxGPm = None

TOL = 1e-8
TRAINED = 1e-6

warnings.simplefilter("ignore")


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# GPm
# ---------------------------------------------------------------------------

def _gpm_data(n=40, d=6):
    rng = np.random.default_rng(3)
    x = rng.uniform(-2, 2, (n, d))
    t = x @ np.array([1.0, -0.5, 0.25, 0.0, 0.0, 0.0])
    y = np.stack([np.sin(t), np.cos(t), 0.5 * t], axis=1)
    return x, y + 0.02 * rng.standard_normal(y.shape)


def _gpm_pair(**kw):
    x, y = _gpm_data()
    return (JaxGPm(x, y, manifold_dim=1, **kw),
            GPm(x, y, manifold_dim=1, compute_device="cpu", **kw))


def _gpm_grad(m):
    """(value, gradients) of the port's objective by autograd."""
    leaves = [p.detach().clone().requires_grad_(True) for p in m._params()]
    val = m._neg_lml(*leaves)
    return float(val.detach()), [g.cpu().double().numpy()
                                 for g in torch.autograd.grad(val, leaves)]


def test_gpm_lml_and_gradient_match_jax():
    jm, tm = _gpm_pair(init_hyperparameters=np.array([1.3, 0.7]))
    _close(tm.log_likelihood(), jm.log_likelihood())
    val, grads = _gpm_grad(tm)
    jval, jgrads = jm._neg_lml_vg(jm._params())
    _close(val, float(jval))
    for g, jg in zip(grads, jgrads):
        _close(g, np.asarray(jg))
    _close(tm.embed(np.ones((3, 6))), jm.embed(np.ones((3, 6))))


@pytest.mark.parametrize("train_embedding", [True, False])
def test_gpm_adam_steps_match_jax(train_embedding):
    jm, tm = _gpm_pair(train_embedding=train_embedding)
    W0 = tm.W.clone()
    _close(tm.train(max_iter=5, learning_rate=5e-2),
           jm.train(max_iter=5, learning_rate=5e-2))
    _close(tm.W.numpy(), np.asarray(jm.W))
    _close(tm.log_noise, jm.log_noise)
    _close(tm.log_likelihood(), jm.log_likelihood())
    if not train_embedding:
        assert torch.equal(tm.W, W0)


def test_gpm_posterior_matches_jax():
    jm, tm = _gpm_pair()
    jm.train(max_iter=5, learning_rate=5e-2)
    tm.train(max_iter=5, learning_rate=5e-2)
    xq = np.random.default_rng(8).uniform(-2, 2, (9, 6))
    _close(tm.posterior_mean(xq), jm.posterior_mean(xq))
    _close(tm.posterior_variance(xq), jm.posterior_variance(xq))


def test_gpm_pickles_and_carries_across():
    jm, tm = _gpm_pair()
    jm.train(max_iter=3, learning_rate=5e-2)
    tm.train(max_iter=3, learning_rate=5e-2)
    back = pickle.loads(pickle.dumps(tm))
    assert back.device == tm.device and back.W.dtype == torch.float64
    _close(back.log_likelihood(), tm.log_likelihood(), 1e-12)
    carried = gpm_from_numpy_state(jm.__getstate__(), compute_device="cpu")
    xq = np.random.default_rng(9).uniform(-2, 2, (5, 6))
    _close(carried.posterior_mean(xq), jm.posterior_mean(xq))
    _close(carried.log_likelihood(), jm.log_likelihood())


# ---------------------------------------------------------------------------
# GPLVM
# ---------------------------------------------------------------------------

def _lvm_data(n=40):
    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(0, np.pi, n))
    Y = np.stack([np.sin(t), np.cos(t), np.sin(2 * t), np.cos(2 * t),
                  0.3 * t], axis=1)
    return Y + 0.01 * rng.standard_normal(Y.shape)


def _lvm_pair(**kw):
    Y = _lvm_data()
    return (JaxGPLVM(Y, latent_dim=1, **kw),
            GPLVM(Y, latent_dim=1, compute_device="cpu", **kw))


@pytest.fixture(scope="module")
def trained_lvm():
    """(JAX, port) after the same 5 Adam steps."""
    jl, tl = _lvm_pair()
    jl.train(max_iter=5)
    tl.train(max_iter=5)
    return jl, tl


def test_gplvm_lml_and_gradient_match_jax():
    jl, tl = _lvm_pair(init_hyperparameters=np.array([1.2, 0.8]))
    _close(tl.log_likelihood(), jl.log_likelihood())
    theta = np.array([0.9, 1.1, 0.02])
    _close(tl.log_likelihood(theta), jl.log_likelihood(theta))
    _close(tl.neg_log_likelihood_gradient(), jl.neg_log_likelihood_gradient())
    _close(tl.neg_log_likelihood_gradient(theta),
           jl.neg_log_likelihood_gradient(theta))
    a, fd = tl.test_log_likelihood_gradient(theta)
    ja, jfd = jl.test_log_likelihood_gradient(theta)
    _close(a, ja)
    _close(fd, jfd, 1e-6)
    np.testing.assert_allclose(a, fd, rtol=1e-4, atol=1e-4)
    # the full objective's gradient in (X, log hps, log noise)
    val, grads = tl._value_and_grad(tl._params(), (0, 1, 2))
    jval, jgrads = jl._neg_lml_vg(jl._params())
    _close(float(val), float(jval))
    for g, jg in zip(grads, jgrads):
        _close(g.numpy(), np.asarray(jg))
    _close(tl._get_default_hyperparameter_bounds(),
           jl._get_default_hyperparameter_bounds())


def test_gplvm_adam_steps_match_jax(trained_lvm):
    jl, tl = trained_lvm
    _close(tl.latent_coordinates, np.asarray(jl.X))
    _close(tl.get_hyperparameters(), jl.get_hyperparameters())
    _close(tl.log_likelihood(), jl.log_likelihood())


def _zq():
    return np.linspace(-1.2, 1.3, 7)[:, None]


@pytest.mark.parametrize("method", [
    "posterior_mean", "posterior_mean_grad", "posterior_mean_grad_0",
    "posterior_covariance", "posterior_variance", "posterior_variance_noisy",
    "posterior_covariance_noisy", "posterior_covariance_grad",
    "posterior_covariance_grad_0", "joint_gp_prior", "gp_entropy",
    "gp_kl_div", "gp_mutual_information", "reconstruct", "predict_variance"])
def test_gplvm_posterior_suite_matches_jax(trained_lvm, method):
    jl, tl = trained_lvm
    zq = _zq()
    calls = {
        "posterior_mean": lambda m: m.posterior_mean(zq),
        "posterior_mean_grad": lambda m: m.posterior_mean_grad(zq),
        "posterior_mean_grad_0": lambda m: m.posterior_mean_grad(
            zq, direction=0),
        "posterior_covariance": lambda m: m.posterior_covariance(zq),
        "posterior_variance": lambda m: m.posterior_covariance(
            zq, variance_only=True),
        "posterior_variance_noisy": lambda m: m.posterior_covariance(
            zq, variance_only=True, add_noise=True),
        "posterior_covariance_noisy": lambda m: m.posterior_covariance(
            zq, add_noise=True),
        "posterior_covariance_grad": lambda m: m.posterior_covariance_grad(
            zq),
        "posterior_covariance_grad_0": lambda m: m.posterior_covariance_grad(
            zq, direction=0),
        "joint_gp_prior": lambda m: m.joint_gp_prior(zq),
        "gp_entropy": lambda m: m.gp_entropy(zq),
        "gp_kl_div": lambda m: m.gp_kl_div(
            zq, np.full(7, 0.1), 0.5 * np.eye(7) + 0.1),
        "gp_mutual_information": lambda m: m.gp_mutual_information(zq),
        "reconstruct": lambda m: m.reconstruct(),
        "predict_variance": lambda m: m.predict_variance(zq)}
    got, ref = calls[method](tl), calls[method](jl)
    if isinstance(ref, dict):
        assert set(got) == set(ref)
        for key in ref:
            if isinstance(ref[key], (str, int)) or ref[key] is None:
                assert got[key] == ref[key], key
            else:
                assert np.shape(got[key]) == np.shape(ref[key]), key
                _close(got[key], ref[key])
    else:
        assert np.shape(got) == np.shape(ref)
        _close(got, ref)


def test_gplvm_local_training_matches_jax():
    jl, tl = _lvm_pair()
    bounds = np.array([[1e-2, 1e2], [1e-2, 1e2], [1e-5, 1.0]])
    ref = jl.train(method="local", hyperparameter_bounds=bounds, max_iter=5)
    got = tl.train(method="local", hyperparameter_bounds=bounds, max_iter=5)
    _close(got, ref, TRAINED)
    _close(tl.get_hyperparameters(), jl.get_hyperparameters(), TRAINED)
    with pytest.raises(AssertionError):
        tl.train(method="local", hyperparameter_bounds=bounds[:2])


@pytest.mark.parametrize("sample_latent", [False, True])
def test_gplvm_mcmc_chain_matches_jax(sample_latent):
    """At one numpy seed both chains take the same steps: the MAP, its
    point and the committed state equal to 1e-8; a second chain draws its
    start from numpy's global RNG in both."""
    out = []
    for m in _lvm_pair():
        np.random.seed(11)
        hps = m.train(method="mcmc", max_iter=25,
                      sample_latent=sample_latent, n_chains=2)
        out.append((hps, m.mcmc_info, np.asarray(m.latent_coordinates)))
    (jh, ji, jX), (th, ti, tX) = out
    _close(th, jh)
    _close(ti["MAP"], ji["MAP"])
    _close(ti["max x"], ji["max x"])
    _close(ti["f(x)"], ji["f(x)"])
    _close(tX, jX)


def test_gplvm_callable_and_legacy_positional_train():
    jl, tl = _lvm_pair()
    theta = np.array([0.8, 1.4, 0.05])
    _close(tl.train(lambda m: theta), theta)
    _close(tl.log_likelihood(), jl.log_likelihood(theta))
    with pytest.raises(AssertionError):
        tl.set_hyperparameters(np.array([1.0, -1.0, 0.1]))
    with pytest.raises(ValueError):
        tl.train(method="bogus")
    jl2, tl2 = _lvm_pair()
    _close(tl2.train(3, 5e-2), jl2.train(3, 5e-2))


def test_gplvm_pickles_and_carries_across(trained_lvm):
    jl, tl = trained_lvm
    back = pickle.loads(pickle.dumps(tl))
    _close(back.log_likelihood(), tl.log_likelihood(), 1e-12)
    assert back.X.dtype == torch.float64 and back.device == tl.device
    carried = gplvm_from_numpy_state(jl.__getstate__(), compute_device="cpu")
    _close(carried.posterior_mean(_zq())["m(x)"],
           jl.posterior_mean(_zq())["m(x)"])
    _close(carried.gp_entropy(_zq()), jl.gp_entropy(_zq()))


def _card_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from fvgp_tpu_torch.ops import hopper_kernels as hk
    return hk


def _var_err(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.cuda
def test_gpm_on_card_matches_the_cpu():
    """GPm on the card against the CPU in float64: in float32 the LML
    within 1e-4 relative, its gradient 1e-3 (relative 2-norm), mean 1e-3
    absolute, variance 1e-3 of its largest value; in float64 all within
    1e-8.  The posterior launches K3 in both."""
    hk = _card_or_skip()
    x, y = _gpm_data(n=500)
    xq = x[:60] + 0.01
    out = {}
    for key, device, dtype in (("cpu", "cpu", "float64"),
                               ("f32", "cuda", "float32"),
                               ("f64", "cuda", "float64")):
        m = GPm(x, y, manifold_dim=1, compute_device=device,
                args={"dtype": dtype})
        _, grads = _gpm_grad(m)
        before = hk.dense_covariance.launches
        out[key] = (m.log_likelihood(), np.concatenate(
            [g.ravel() for g in grads]), m.posterior_mean(xq),
            m.posterior_variance(xq))
        if device == "cuda":
            assert hk.dense_covariance.launches - before == 6
    (v0, g0, m0, s0), (v1, g1, m1, s1) = out["cpu"], out["f32"]
    assert abs(v1 - v0) <= 1e-4 * abs(v0)
    assert np.linalg.norm(g1 - g0) <= 1e-3 * np.linalg.norm(g0)
    assert np.abs(m1 - m0).max() <= 1e-3
    assert _var_err(s1, s0) <= 1e-3
    for a, b in zip(out["f64"], out["cpu"]):
        _close(a, b)


@pytest.mark.cuda
def test_gplvm_on_card_matches_the_cpu():
    """GPLVM on the card in float64 against the CPU: LML, hyperparameter
    gradient, mean, its latent gradient and variance within 1e-8; the
    posterior launches K3 (float64), the forward-mode latent gradients take
    the plain formula.  (K+V's condition number is near 1e5 here: float32
    sits ~1e-2 from float64 on the card and on the CPU alike —
    ``PERF.md``.)"""
    hk = _card_or_skip()
    Y = _lvm_data(n=500)
    zq = np.linspace(-1.5, 1.5, 40)[:, None]
    out = {}
    for device in ("cpu", "cuda"):
        m = GPLVM(Y, latent_dim=1, compute_device=device,
                  args={"dtype": "float64"})
        before = hk.dense_covariance.launches
        mean = m.posterior_mean(zq)["m(x)"]
        launches = hk.dense_covariance.launches - before
        out[device] = (m.log_likelihood(), m.neg_log_likelihood_gradient(),
                       mean, m.posterior_mean_grad(zq)["dm/dx"],
                       m.posterior_covariance(zq, variance_only=True)["v(x)"])
    assert launches == 2
    for a, b in zip(out["cuda"], out["cpu"]):
        _close(a, b)
