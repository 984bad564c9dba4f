"""The deep-kernel networks of the port against the JAX package (CPU,
float64): ``get_number_of_hps``, the ``Network`` and ``WarpNet`` forward
passes on one flat weight vector, the deep kernel, and a deep-kernel ``GP``
(BASELINE config 4's ``WarpNet(2, 4, 4, 2)`` + Matérn-5/2, 44
hyperparameters) — LML, gradient and posterior through both packages'
``GP``, carried across by ``gp_from_numpy_state`` — all equal to 1e-8.
On a card (``cuda``): the deep-kernel GP in float64 against the CPU within
1e-8, with no K3 launch (a user kernel is not routed to it)."""

import pickle
import warnings

import numpy as np
import pytest
import torch

from fvgp_tpu_torch import GP, gp_from_numpy_state
from fvgp_tpu_torch.models import deep_kernel_network as tdk

try:
    from fvgp_tpu import GP as JaxGP
    from fvgp_tpu.models import deep_kernel_network as jdk
except ImportError:     # a card's machine without JAX runs the cuda cases
    JaxGP = jdk = None

TOL = 1e-8
N = 40


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=tol, atol=tol)


def _data():
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 2, (N, 2))
    y = np.sin(4 * x[:, 0] * x[:, 1])
    return x, y


def _init(net):
    rng = np.random.default_rng(7)
    return np.concatenate([0.3 * rng.standard_normal(net.number_of_hps),
                           [1.0, 1.0]])


@pytest.mark.parametrize("dims", [(2, 4, 4, 2), (3, 8, 8, 2), (1, 5, 3, 4)])
def test_number_of_hps_matches_jax(dims):
    assert tdk.get_number_of_hps(*dims) == jdk.get_number_of_hps(*dims)
    assert tdk.Network(*dims).number_of_hps == jdk.Network(*dims) \
        .number_of_hps


@pytest.mark.parametrize("cls", ["Network", "WarpNet"])
def test_forward_matches_jax(cls):
    """One flat vector, read in the same (W1, b1, W2, b2, W3, b3)
    row-major layout: the forward passes and the unflattened views equal
    JAX's to 1e-8; the module owns no parameters."""
    rng = np.random.default_rng(3)
    dims = (3, 5, 4, 2)
    jnet, tnet = getattr(jdk, cls)(*dims), getattr(tdk, cls)(*dims)
    w = rng.standard_normal(tnet.number_of_hps)
    x = rng.uniform(-1, 1, (17, 3))
    _close(tnet(torch.as_tensor(x), torch.as_tensor(w)).numpy(),
           np.asarray(jnet(x, w)))
    _close(tnet(x, w).numpy(), np.asarray(jnet(x, w)))       # numpy in
    for a, b in zip(tnet.unflatten(w), jnet.unflatten(w)):
        _close(a.numpy(), np.asarray(b))
    assert isinstance(tnet, torch.nn.Module)
    assert list(tnet.parameters()) == []
    np.testing.assert_array_equal(tnet.get_weights(w), w)
    np.testing.assert_array_equal(tnet.set_weights(w), w)


def test_warpnet_output_is_bounded_and_differentiable():
    net = tdk.WarpNet(2, 4, 4, 2)
    w = torch.as_tensor(np.random.default_rng(0).standard_normal(
        net.number_of_hps) * 3.0).requires_grad_(True)
    out = net(torch.rand(30, 2, dtype=torch.float64) * 4.0, w)
    assert torch.all(out.abs() <= 1.0)
    (g,) = torch.autograd.grad(out.sum(), w)
    assert g.shape == w.shape and torch.all(torch.isfinite(g))


def test_deep_kernel_matches_jax():
    net_j, net_t = jdk.WarpNet(2, 4, 4, 2), tdk.WarpNet(2, 4, 4, 2)
    kj, kt = jdk.make_deep_kernel(net_j), tdk.make_deep_kernel(net_t)
    assert kt.number_of_hps == kj.number_of_hps == 44
    x, _ = _data()
    h = _init(net_t)
    K = kt(torch.as_tensor(x), torch.as_tensor(x[:9] + 0.1),
           torch.as_tensor(h))
    _close(K.numpy(), np.asarray(kj(x, x[:9] + 0.1, h)))


def _pair():
    x, y = _data()
    net_j, net_t = jdk.WarpNet(2, 4, 4, 2), tdk.WarpNet(2, 4, 4, 2)
    h = _init(net_t)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jgp = JaxGP(x, y, init_hyperparameters=h,
                    kernel_function=jdk.make_deep_kernel(net_j))
        tgp = GP(x, y, init_hyperparameters=h, compute_device="cpu",
                 kernel_function=tdk.make_deep_kernel(net_t))
    return jgp, tgp, h


@pytest.fixture(scope="module")
def pair():
    return _pair()


def test_deep_kernel_gp_lml_and_gradient_match_jax(pair):
    jgp, tgp, h = pair
    assert tgp.prior.kernel_traceable
    _close(tgp.log_likelihood(), jgp.log_likelihood())
    h2 = h * 1.05
    _close(tgp.log_likelihood(h2), jgp.log_likelihood(h2))
    _close(tgp.neg_log_likelihood_gradient(h2),
           jgp.neg_log_likelihood_gradient(h2))
    val, grad = tgp.marginal_likelihood.log_likelihood_value_and_gradient(h2)
    _close(val, jgp.log_likelihood(h2))
    _close(grad, -jgp.neg_log_likelihood_gradient(h2))


def test_deep_kernel_gp_posterior_matches_jax(pair):
    jgp, tgp, _ = pair
    xp = np.random.default_rng(4).uniform(0, 2, (11, 2))
    _close(tgp.posterior_mean(xp)["m(x)"], jgp.posterior_mean(xp)["m(x)"])
    _close(tgp.posterior_covariance(xp, variance_only=True)["v(x)"],
           jgp.posterior_covariance(xp, variance_only=True)["v(x)"])
    _close(tgp.posterior_covariance(xp)["S"], jgp.posterior_covariance(xp)["S"])


def test_deep_kernel_state_carries_across(pair):
    """A deep kernel's weights are its hyperparameters:
    ``gp_from_numpy_state(..., kernel_function=make_deep_kernel(net))``
    rebuilds the JAX model's posterior."""
    jgp, _, _ = pair
    state = {"x_data": np.asarray(jgp.x_data),
             "y_data": np.asarray(jgp.y_data),
             "noise_variances": jgp.noise_variances,
             "hyperparameters": np.asarray(jgp.hyperparameters),
             "args": {}, "gp2Scale": False}
    gp = gp_from_numpy_state(
        state, compute_device="cpu",
        kernel_function=tdk.make_deep_kernel(tdk.WarpNet(2, 4, 4, 2)))
    xp = np.random.default_rng(5).uniform(0, 2, (6, 2))
    _close(gp.posterior_mean(xp)["m(x)"], jgp.posterior_mean(xp)["m(x)"])
    _close(gp.log_likelihood(), jgp.log_likelihood())


def test_deep_kernel_gp_trains_by_hgdl():
    """BASELINE config 4's journey on the port: ``hgdl`` (4 starts) moves
    the 44 hyperparameters and raises the LML; the network module pickles."""
    _, tgp, h = _pair()
    net = tdk.WarpNet(2, 4, 4, 2)
    bounds = np.vstack([np.tile([-3.0, 3.0], (net.number_of_hps, 1)),
                        [[0.01, 10.0], [0.1, 10.0]]])
    before = tgp.log_likelihood()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tgp.train(method="hgdl", hyperparameter_bounds=bounds, pop_size=4,
                  max_iter=5)
    assert tgp.log_likelihood() > before
    assert np.abs(tgp.hyperparameters - h).max() > 1e-3
    back = pickle.loads(pickle.dumps(net))
    w = torch.as_tensor(h[:net.number_of_hps])
    x = torch.rand(5, 2, dtype=torch.float64)
    assert torch.equal(back(x, w), net(x, w))


@pytest.mark.cuda
def test_deep_kernel_gp_on_card_matches_the_cpu():
    """The deep-kernel GP on the card in float64 against the CPU: LML,
    gradient, mean and variance within 1e-8; K3 never launches.  (Its K+V
    has a condition number near 1e5 here: the card's float32 result is as
    far from float64 as float32 on the CPU is, ~1e-3 — ``PERF.md``.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from fvgp_tpu_torch.ops import hopper_kernels as hk
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 2, (400, 2))
    y = np.sin(4 * x[:, 0] * x[:, 1]) + 0.05 * rng.standard_normal(400)
    net = tdk.WarpNet(2, 4, 4, 2)
    h = _init(net)
    out = {}
    before = hk.dense_covariance.launches
    for device in ("cpu", "cuda"):
        gp = GP(x, y, init_hyperparameters=h, compute_device=device,
                noise_variances=np.full(400, 1e-2),
                kernel_function=tdk.make_deep_kernel(net),
                args={"dtype": "float64"})
        val, grad = gp.marginal_likelihood \
            .log_likelihood_value_and_gradient(h)
        xp = x[:50] + 0.01
        out[device] = (val, grad, gp.posterior_mean(xp)["m(x)"],
                       gp.posterior_covariance(xp, variance_only=True)[
                           "v(x)"])
    assert hk.dense_covariance.launches == before
    for a, b in zip(out["cuda"], out["cpu"]):
        _close(a, b)
