"""The rest of the JAX package's kernel catalog in the port
(``fvgp_tpu_torch/kernels.py`` against ``fvgp_tpu/kernels.py``): the same
inputs, made from a seed with numpy, through both, on the CPU in float64,
at 1e-12, on inputs with n1 != n2 so that a transposition cannot hide."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.sparse import issparse

import fvgp_tpu.kernels as J
import fvgp_tpu_torch.kernels as T


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: under the suite's
    parallel workers torch's default of a thread per core oversubscribes
    the cores, and loops of small tensor ops slow down tenfold and more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = 1e-12


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return dict(x1=rng.uniform(0, 3, (7, 2)), x2=rng.uniform(0, 3, (5, 2)),
                x0=rng.uniform(0, 3, (4, 2)), w=rng.uniform(0.5, 1.5, 4),
                a=rng.uniform(0.1, 1.0, (6, 9)), b=rng.uniform(0.1, 1.0,
                                                               (3, 9)))


def _cases():
    v = _inputs()
    x1, x2, x0, w = v["x1"], v["x2"], v["x0"], v["w"]
    hps4 = [1.0, 1.5, 1.0, 0.7]
    return {
        "linear_kernel": ((x1, x2[:1], 1.0, 2.0, 0.5), {}),
        "dot_product_kernel": ((x1.T, x2.T, 0.3, np.diag([1.0, 2.0])), {}),
        "polynomial_kernel": ((x1.T, x2.T, 3.0), {}),
        "non_stat_kernel": ((x1, x2, x0, w, 1.2), {}),
        "non_stat_kernel_gradient": ((x1, x2, x0, w, 1.2), {}),
        "wasserstein_1d": ((v["a"][0], v["a"][1]), {}),
        "wasserstein_1d_outer_vec": ((v["a"], v["b"]), {}),
        "bump": ((np.linspace(0.0, 2.0, 11), 1.3), {"beta": 0.7,
                                                      "ampl": 2.0}),
        "sle_kernel": ((x1, x2, hps4, {"x_data": x0}), {}),
        "sle_kernel_landmarks": ((x1, x2, hps4, {"landmarks": x0}), {}),
    }


def _port_args(args):
    return tuple(a if isinstance(a, (float, dict)) else _t(a) for a in args)


@pytest.mark.parametrize("name", sorted(_cases()))
def test_catalog_function_matches_jax(name):
    args, kw = _cases()[name]
    fn = name.replace("_landmarks", "")
    want = np.asarray(getattr(J, fn)(*args, **kw))
    got = getattr(T, fn)(*_port_args(args), **kw)
    assert torch.is_tensor(got) and got.dtype == torch.float64
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_non_stat_gradient_is_autograd_of_the_kernel():
    """The explicit (len(w) + 1, n1, n2) gradient equals the Jacobian of
    ``non_stat_kernel`` in (w, l) by autograd, at n1 != n2."""
    v = _inputs(1)
    x1, x2, x0 = _t(v["x1"]), _t(v["x2"]), _t(v["x0"])
    w, l = _t(v["w"]), torch.tensor(1.2, dtype=torch.float64)
    jw, jl = torch.autograd.functional.jacobian(
        lambda w_, l_: T.non_stat_kernel(x1, x2, x0, w_, l_), (w, l))
    want = torch.cat([jw.permute(2, 0, 1), jl[None]])
    got = T.non_stat_kernel_gradient(x1, x2, x0, w, l)
    assert got.shape == (5, 7, 5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=TOL)


def test_bump_and_sle_gradients_are_finite_at_the_support_edge():
    """The double ``where``: at and beyond the radius the bump is 0 and
    its gradient 0, not NaN; the landmark kernel's hyperparameter
    gradient is finite with points exactly on a landmark's support edge,
    and equals JAX's."""
    r = torch.tensor(1.3, dtype=torch.float64, requires_grad=True)
    d = torch.tensor([0.0, 0.7, 1.3, 2.0], dtype=torch.float64,
                     requires_grad=True)
    T.bump(d, r, beta=0.7).sum().backward()
    assert torch.all(torch.isfinite(d.grad)) and torch.isfinite(r.grad)
    np.testing.assert_array_equal(d.grad[2:].numpy(), 0.0)
    jr = jax.grad(lambda r_: jnp.sum(J.bump(jnp.asarray(d.detach().numpy()),
                                            r_, beta=0.7)))(1.3)
    np.testing.assert_allclose(r.grad.item(), float(jr), rtol=0, atol=TOL)
    x0 = np.array([[0.0, 0.0], [2.0, 0.0]])
    x1 = np.array([[1.5, 0.0], [0.3, 0.2], [4.0, 4.0]])    # on the edge
    x2 = x1[:2] + 0.1
    hps = np.array([1.0, 1.5, 1.0, 0.7])
    h = _t(hps).requires_grad_(True)
    T.sle_kernel(_t(x1), _t(x2), h, {"x_data": x0}).sum().backward()
    assert torch.all(torch.isfinite(h.grad))
    jh = jax.grad(lambda h_: jnp.sum(J.sle_kernel(x1, x2, h_,
                                                  {"x_data": x0})))(
        jnp.asarray(hps))
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(jh), rtol=0,
                               atol=1e-10)


def test_wendland_aliases_and_the_sparse_kernel():
    """The cpu / gpu / tpu names are the Wendland kernel itself; the
    ``_sparse`` kernel is a host callable returning a COO matrix of the
    dense kernel's nonzeros, equal to the JAX package's."""
    for alias in ("wendland_anisotropic_tpu",
                  "wendland_anisotropic_gp2Scale_cpu",
                  "wendland_anisotropic_gp2Scale_gpu"):
        assert getattr(T, alias) is T.wendland_anisotropic
    assert T.wendland_anisotropic_gp2Scale_gpu_sparse \
        is T.wendland_anisotropic_gp2Scale_cpu_sparse
    rng = np.random.default_rng(5)
    x1 = rng.uniform(0, 4, (30, 2))
    x2 = rng.uniform(0, 4, (20, 2))
    hps = np.array([1.2, 1.0, 1.5])
    s = T.wendland_anisotropic_gp2Scale_cpu_sparse(x1, x2, hps)
    assert issparse(s) and s.format == "coo"
    dense = T.wendland_anisotropic(_t(x1), _t(x2), _t(hps)).numpy()
    np.testing.assert_allclose(s.toarray(), dense, rtol=0, atol=TOL)
    assert s.nnz == np.count_nonzero(dense) < dense.size
    j = J.wendland_anisotropic_gp2Scale_cpu_sparse(x1, x2, hps)
    np.testing.assert_allclose(s.toarray(), j.toarray(), rtol=0, atol=TOL)
    # tensors in (the card's, in a model) give the same host matrix
    np.testing.assert_array_equal(
        T.wendland_anisotropic_gp2Scale_cpu_sparse(_t(x1), _t(x2),
                                                   _t(hps)).toarray(),
        s.toarray())


@pytest.mark.parametrize("gp2Scale", [False, True])
def test_a_gp_takes_the_sparse_kernel_on_both_engines(gp2Scale):
    """A reference user's ``_sparse`` kernel as ``kernel_function``: the
    model densifies its blocks (the dense engine) or tiles them on the host
    (gp2Scale), and matches the dense Wendland model and the JAX package's
    sparse-kernel model."""
    from fvgp_tpu import GP as JaxGP
    from fvgp_tpu_torch import GP
    rng = np.random.default_rng(6)
    x = rng.uniform(0, 5, (70, 2))
    y = np.sin(x[:, 0])
    xp = rng.uniform(0, 5, (9, 2))
    kw = dict(init_hyperparameters=np.array([1.0, 1.0, 1.0]),
              gp2Scale=gp2Scale)
    if gp2Scale:
        kw["args"] = {"gp2Scale_block_size": 32,
                      "gp2Scale_traced_lml": False}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dense = GP(x, y, kernel_function=T.wendland_anisotropic,
                   compute_device="cpu", **kw)
        sparse = GP(x, y, compute_device="cpu",
                    kernel_function=T.wendland_anisotropic_gp2Scale_cpu_sparse,
                    **kw)
        jax_sparse = JaxGP(
            x, y, kernel_function=J.wendland_anisotropic_gp2Scale_cpu_sparse,
            **kw)
        assert not sparse.prior.kernel_traceable
        lml, mean = sparse.log_likelihood(), sparse.posterior_mean(xp)["m(x)"]
        np.testing.assert_allclose(lml, dense.log_likelihood(), rtol=1e-8)
        np.testing.assert_allclose(lml, jax_sparse.log_likelihood(),
                                   rtol=1e-8)
        np.testing.assert_allclose(mean, dense.posterior_mean(xp)["m(x)"],
                                   atol=1e-8)
        np.testing.assert_allclose(
            mean, jax_sparse.posterior_mean(xp)["m(x)"], atol=1e-8)


def test_sle_kernel_through_a_gp_matches_jax():
    """The 4-argument landmark kernel through the port's arity dispatch:
    the LML and posterior mean of a dense GP equal the JAX package's."""
    from fvgp_tpu import GP as JaxGP
    from fvgp_tpu_torch import GP
    rng = np.random.default_rng(9)
    x = rng.uniform(0, 2, (40, 2))
    y = np.cos(2 * x[:, 0]) + 0.05 * rng.standard_normal(40)
    xp = rng.uniform(0, 2, (6, 2))
    kw = dict(init_hyperparameters=np.array([1.0, 1.5, 1.0, 0.7]),
              args={"x_data": x[::4]})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        gp = GP(x, y, kernel_function=T.sle_kernel, compute_device="cpu",
                **kw)
        jgp = JaxGP(x, y, kernel_function=J.sle_kernel, **kw)
    assert gp.prior.k_n_params == 4 and gp.prior.kernel_traceable
    np.testing.assert_allclose(gp.log_likelihood(), jgp.log_likelihood(),
                               rtol=1e-8)
    np.testing.assert_allclose(gp.posterior_mean(xp)["m(x)"],
                               jgp.posterior_mean(xp)["m(x)"], atol=1e-8)
