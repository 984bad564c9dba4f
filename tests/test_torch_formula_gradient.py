"""The formula / finite-difference gradient engine of the port against the
JAX package's (CPU, float64, the same seeded data): host (numpy) kernel,
mean and noise callables, the three user gradient callables with and
without ``ram_economy``, forward-mode AD of traceable callables at the
committed state, a custom ``[factor, solve, logdet]`` mode's gradient, the
central-difference Hessian, the posterior gradients of host callables and
training on the formula gradient.

Bounds: 1e-8 where both packages compute the same exact arithmetic (user
gradients, forward-mode AD against ``jacfwd``); 1e-6 where both take
difference quotients of the same callables (host kernels and means, the
Hessian's central differences of the gradient); trained hyperparameters
1e-5 (the optimizer's steps carry the quotients' 1e-10 differences on:
local training of the host kernel ends 2e-6 apart)."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvgp_tpu import GP as JaxGP
from fvgp_tpu_torch import GP

warnings.simplefilter("ignore")

EXACT = 1e-8
QUOTIENT = 1e-6
TRAINED = 1e-5
HPS = np.array([1.2, 1.4])


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _data(n=30, d=1, seed=11):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 8, (n, d))
    return x, np.sin(x[:, 0]) + 0.02 * rng.standard_normal(n)


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=tol, atol=tol)


def np_sqexp(x1, x2, h):
    x1 = np.asarray(x1, np.float64)
    x2 = np.asarray(x2, np.float64)
    d2 = ((x1[:, None, :] - x2[None, :, :]) ** 2 / h[1] ** 2).sum(-1)
    return h[0] * np.exp(-0.5 * d2)


def np_sqexp3(x1, x2, h, args):
    assert args.get("flag") == 7
    return np_sqexp(x1, x2, h)


def np_mean(x, h):
    return 0.3 * np.asarray(x)[:, 0] ** 2


def np_mean3(x, h, args):
    assert args.get("flag") == 7
    return 0.1 * np.asarray(x)[:, 0]


def np_noise(x, h):
    return np.full(len(x), 1e-2 * h[0])


def dk_dh_dir(x1, x2, h, direction):
    d2 = ((np.asarray(x1)[:, None, :] - np.asarray(x2)[None, :, :]) ** 2
          / h[1] ** 2).sum(-1)
    if direction == 0:
        return np.exp(-0.5 * d2)
    return h[0] * np.exp(-0.5 * d2) * d2 / h[1]


def dk_dh_full(x1, x2, h):
    return np.stack([dk_dh_dir(x1, x2, h, i) for i in range(len(h))])


def dv_dh_dir(x, h, direction):
    return np.full(len(x), 1e-2) if direction == 0 else np.zeros(len(x))


def dv_dh_full(x, h):
    return np.stack([dv_dh_dir(x, h, i) for i in range(len(h))])


# name: (keyword callables, bound) — the same callables in both packages
HOST_CASES = {
    "host_kernel": (dict(kernel_function=np_sqexp), QUOTIENT),
    "host_kernel_mean_noise": (dict(kernel_function=np_sqexp,
                                    prior_mean_function=np_mean,
                                    noise_function=np_noise), QUOTIENT),
    "three_arg_callables": (dict(kernel_function=np_sqexp3,
                                 prior_mean_function=np_mean3,
                                 args={"flag": 7}), QUOTIENT),
    "user_kernel_and_noise_grads": (dict(kernel_function=np_sqexp,
                                         kernel_function_grad=dk_dh_full,
                                         noise_function=np_noise,
                                         noise_function_grad=dv_dh_full),
                                    EXACT),
}


def _pair(ram_economy=False, x=None, y=None, hps=HPS, **kw):
    if x is None:
        x, y = _data()
    kw = dict(kw)
    if ram_economy:
        if kw.get("kernel_function_grad") is dk_dh_full:
            kw["kernel_function_grad"] = dk_dh_dir
        if kw.get("noise_function_grad") is dv_dh_full:
            kw["noise_function_grad"] = dv_dh_dir
    args = kw.pop("args", None)
    return (JaxGP(x, y, init_hyperparameters=hps, ram_economy=ram_economy,
                  args=None if args is None else dict(args), **kw),
            GP(x, y, init_hyperparameters=hps, ram_economy=ram_economy,
               compute_device="cpu",
               args=None if args is None else dict(args), **kw))


@pytest.mark.parametrize("ram_economy", [False, True])
@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_value_and_formula_gradient_match_jax(case, ram_economy):
    """The shared-factorization value and gradient at a trial vector, the
    committed-state gradient, and the self-test pair."""
    kw, tol = HOST_CASES[case]
    jgp, tgp = _pair(ram_economy, **kw)
    assert not tgp.prior.kernel_traceable
    trial = HPS * 1.1
    jv, jg = jgp.marginal_likelihood.log_likelihood_value_and_gradient(trial)
    tv, tg = tgp.marginal_likelihood.log_likelihood_value_and_gradient(trial)
    _close(tv, jv, EXACT)
    _close(tg, jg, tol)
    assert tv == pytest.approx(tgp.log_likelihood(trial), rel=1e-12)
    _close(tgp.neg_log_likelihood_gradient(),
           jgp.neg_log_likelihood_gradient(), tol)
    _close(tgp.neg_log_likelihood_gradient(trial),
           jgp.neg_log_likelihood_gradient(trial), tol)
    fd, an = tgp.test_log_likelihood_gradient(HPS, epsilon=1e-7)
    np.testing.assert_allclose(fd, an, rtol=5e-3, atol=1e-3)


def test_user_mean_grad_takes_the_mean_term_only():
    """A hyperparameter with a non-zero mean derivative contributes the
    mean term alone (the JAX package's rule, kept): equal to JAX's exactly,
    and the full autograd gradient differs in that entry."""
    x, y = _data()
    hps = np.array([1.2, 1.4, 0.5])

    def kern(x1, x2, h):
        return np_sqexp(x1, x2, h[:2])

    def mean(xx, h):
        return h[2] * np.asarray(xx)[:, 0]

    def dm_dh(xx, h):
        xx = np.asarray(xx)
        return np.stack([np.zeros(len(xx)), np.zeros(len(xx)), xx[:, 0]])

    jgp, tgp = _pair(x=x, y=y, hps=hps, kernel_function=kern,
                     prior_mean_function=mean, prior_mean_function_grad=dm_dh)
    g = tgp.neg_log_likelihood_gradient(hps)
    _close(g, jgp.neg_log_likelihood_gradient(hps), QUOTIENT)
    # the mean entry is -dm/dh·b, without the kernel terms
    b = tgp.marginal_likelihood._trial(hps)[4][:, 0].numpy()
    assert g[2] == pytest.approx(-(np.asarray(x)[:, 0] @ b), rel=1e-10)


def _torch_sqexp(x1, x2, h):
    d2 = ((x1[:, None, :] - x2[None, :, :]) ** 2 / h[1] ** 2).sum(-1)
    return h[0] * torch.exp(-0.5 * d2)


def _jnp_sqexp(x1, x2, h):
    d2 = ((x1[:, None, :] - x2[None, :, :]) ** 2 / h[1] ** 2).sum(-1)
    return h[0] * jnp.exp(-0.5 * d2)


@pytest.mark.parametrize("ram_economy", [False, True])
def test_committed_state_gradient_of_traceable_callables(ram_economy):
    """The committed-state gradient takes the formula on the traced path
    too (forward-mode AD of kernel, mean and noise against JAX's
    ``jacfwd``), equal to JAX's and to the port's own autograd gradient."""
    x, y = _data(n=40, d=2)
    hps = np.array([1.1, 1.3, 0.02, 0.1])

    def tmean(xx, h):
        return 0.0 * h[3] + 0.2 * xx[:, 0]

    def jmean(xx, h):
        return 0.0 * h[3] + 0.2 * xx[:, 0]

    def tnoise(xx, h):
        return h[2] * torch.ones(len(xx), dtype=xx.dtype) + 0 * h[3]

    def jnoise(xx, h):
        return h[2] * jnp.ones(len(xx)) + 0 * h[3]

    def tkern(x1, x2, h):
        return _torch_sqexp(x1, x2, h[:2])

    def jkern(x1, x2, h):
        return _jnp_sqexp(x1, x2, h[:2])

    jgp = JaxGP(x, y, init_hyperparameters=hps, kernel_function=jkern,
                prior_mean_function=jmean, noise_function=jnoise,
                ram_economy=ram_economy)
    tgp = GP(x, y, init_hyperparameters=hps, kernel_function=tkern,
             prior_mean_function=tmean, noise_function=tnoise,
             ram_economy=ram_economy, compute_device="cpu")
    assert tgp.marginal_likelihood._traced_ready()
    g = tgp.neg_log_likelihood_gradient()
    _close(g, jgp.neg_log_likelihood_gradient(), EXACT)
    _close(g, tgp.neg_log_likelihood_gradient(hps), EXACT)
    _close(tgp.prior.dk_dh(x, x, hps, direction=1),
           jgp.prior.dk_dh(x, x, hps, direction=1), EXACT)
    _close(tgp.likelihood.calculate_V_grad(x, hps),
           jgp.likelihood.calculate_V_grad(x, hps), EXACT)


def test_default_kernel_committed_gradient_matches_autograd():
    """The default kernel's committed-state gradient (forward-mode AD of
    the Matérn kernel through the formula) against its autograd gradient
    and JAX's committed-state gradient."""
    x, y = _data(n=50, d=2, seed=3)
    hps = np.array([1.0, 1.5, 1.5])
    nv = np.full(50, 1e-2)
    jgp = JaxGP(x, y, init_hyperparameters=hps, noise_variances=nv)
    tgp = GP(x, y, init_hyperparameters=hps, noise_variances=nv,
             compute_device="cpu")
    g = tgp.neg_log_likelihood_gradient()
    _close(g, tgp.neg_log_likelihood_gradient(hps), EXACT)
    _close(g, jgp.neg_log_likelihood_gradient(), EXACT)


CUSTOM = [lambda KV: np.linalg.cholesky(np.asarray(KV)),
          lambda L, b: np.linalg.solve(L.T, np.linalg.solve(L, np.asarray(b))),
          lambda L: 2.0 * np.sum(np.log(np.diag(L)))]


def test_custom_mode_gradient_matches_jax():
    """A custom numpy ``[factor, solve, logdet]``: the LML gradient is the
    formula gradient over the custom solve."""
    x, y = _data(n=40, d=2)
    hps = np.array([1.0, 1.5, 1.5])
    jgp = JaxGP(x, y, init_hyperparameters=hps, linalg_mode=CUSTOM,
                noise_variances=np.full(40, 1e-2))
    tgp = GP(x, y, init_hyperparameters=hps, linalg_mode=CUSTOM,
             noise_variances=np.full(40, 1e-2), compute_device="cpu")
    for h in (None, hps * 1.2):
        _close(tgp.neg_log_likelihood_gradient(h),
               jgp.neg_log_likelihood_gradient(h), EXACT)
    jv = jgp.marginal_likelihood.log_likelihood_value_and_gradient(hps * 0.9)
    tv = tgp.marginal_likelihood.log_likelihood_value_and_gradient(hps * 0.9)
    _close(tv[0], jv[0], EXACT)
    _close(tv[1], jv[1], EXACT)


def test_fd_hessian_matches_jax_and_the_exact_hessian():
    """The central-difference Hessian of a host kernel equals JAX's and is
    near the exact autograd Hessian of the same kernel on tensors."""
    jgp, tgp = _pair(kernel_function=np_sqexp)
    x, y = _data()
    traced = GP(x, y, init_hyperparameters=HPS, kernel_function=_torch_sqexp,
                compute_device="cpu")
    Hh = tgp.marginal_likelihood.neg_log_likelihood_hessian(HPS)
    _close(Hh, jgp.marginal_likelihood.neg_log_likelihood_hessian(HPS),
           QUOTIENT)
    Ht = traced.marginal_likelihood.neg_log_likelihood_hessian(HPS)
    np.testing.assert_allclose(Hh, Ht, rtol=5e-2, atol=5e-3)


def test_host_kernel_and_mean_posterior_grads_match_jax():
    """Posterior gradients of a host kernel and mean (forward differences
    in both packages)."""
    jgp, tgp = _pair(kernel_function=np_sqexp, prior_mean_function=np_mean)
    xp = np.array([[2.0], [5.5]])
    _close(tgp.posterior_mean_grad(xp, direction=0)["dm/dx"],
           jgp.posterior_mean_grad(xp, direction=0)["dm/dx"], QUOTIENT)
    _close(tgp.posterior_covariance_grad(xp, direction=0)["dv/dx"],
           jgp.posterior_covariance_grad(xp, direction=0)["dv/dx"], QUOTIENT)


@pytest.mark.parametrize("method", ["local", "adam"])
def test_training_on_the_formula_gradient_matches_jax(method):
    """``train`` on a host-kernel model runs on the formula gradient in
    both packages: the same trained hyperparameters."""
    jgp, tgp = _pair(kernel_function=np_sqexp)
    bounds = np.array([[0.1, 10.0], [0.2, 10.0]])
    kw = dict(hyperparameter_bounds=bounds, method=method, max_iter=15,
              init_hyperparameters=HPS)
    got = tgp.train(**kw)
    ref = jgp.train(**kw)
    _close(got, ref, TRAINED)
    assert tgp.log_likelihood() > GP(*_data(), init_hyperparameters=HPS,
                                     kernel_function=np_sqexp,
                                     compute_device="cpu").log_likelihood()


def test_hgdl_trains_a_host_kernel_model():
    """``hgdl`` on a host-kernel model: no batched device program exists,
    the starts run on the formula gradient and the LML improves."""
    _, tgp = _pair(kernel_function=np_sqexp)
    before = tgp.log_likelihood()
    np.random.seed(0)
    tgp.train(hyperparameter_bounds=np.array([[0.1, 10.0], [0.2, 10.0]]),
              method="hgdl", pop_size=4, max_iter=10)
    assert tgp.log_likelihood() > before


def test_gp2scale_without_a_traced_program_has_no_gradient():
    """gp2Scale off the traced sparse program has a value and no gradient
    (the JAX package's message); training switches to MCMC."""
    rng = np.random.default_rng(0)
    xs = rng.uniform(0, 30, (300, 2))
    ys = np.sin(xs[:, 0])

    def np_wendland_like(x1, x2, h):
        d = np.sqrt(((np.asarray(x1)[:, None, :] / h[1:]
                      - np.asarray(x2)[None, :, :] / h[1:]) ** 2).sum(-1))
        return h[0] * np.clip(1 - d, 0, None) ** 2

    hps = np.array([1.0, 5.0, 5.0])
    gp = GP(xs, ys, init_hyperparameters=hps, gp2Scale=True,
            kernel_function=np_wendland_like, compute_device="cpu",
            args={"gp2Scale_block_size": 32})
    ml = gp.marginal_likelihood
    assert np.isfinite(gp.log_likelihood(hps))
    for call in (lambda: ml.neg_log_likelihood_gradient(hps),
                 lambda: ml.log_likelihood_value_and_gradient(hps),
                 lambda: ml.neg_log_likelihood_hessian(hps)):
        with pytest.raises(Exception, match="non-traceable"):
            call()
