"""The gp2Scale journey as a whole: the same ``GP(gp2Scale=True,
linalg_mode="sparseCGpre")`` in the JAX package and in the port, with the
same probes injected into both — LML + gradient, ``train(method="local")``,
posterior mean and variance (CPU, float64).  Also the port's float32 fused
committed route against the dense oracle, and ``gp_from_numpy_state``."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fvgp_tpu_torch.models.gp_marginal_likelihood as TML
from fvgp_tpu import GP as JaxGP
from fvgp_tpu_torch import GP, gp_from_numpy_state


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: under the suite's
    parallel workers torch's default of a thread per core oversubscribes
    the cores, and loops of small tensor ops slow down tenfold and more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N, D, B, PROBES = 900, 3, 64, 16
HPS = np.array([1.0, 2.0, 2.0, 2.0])
BOUNDS = np.array([[0.05, 5.0], [1.9, 2.1], [1.9, 2.1], [1.9, 2.1]])
ARGS = {"gp2Scale_block_size": B, "random_logdet_fixed_probes": PROBES,
        "sparse_cg_maxiter": 64}


def _data():
    rng = np.random.default_rng(11)
    x = rng.uniform(0, 14, (N, D))
    y = np.sin(0.5 * x[:, 0]) + 0.05 * rng.standard_normal(N)
    xp = rng.uniform(0, 14, (25, D))
    return x, y, xp


def _probes(nb):
    Z = np.random.default_rng(3).choice([-1.0, 1.0], size=(nb * B, PROBES))
    return Z


@pytest.fixture(scope="module")
def journeys():
    x, y, xp = _data()
    nb = -(-N // B)
    Z = _probes(nb)
    out = {}
    with pytest.MonkeyPatch.context() as mp, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mp.setattr(jax.random, "rademacher",
                   lambda key, shape, dtype=jnp.float64: jnp.asarray(
                       Z, dtype))
        mp.setattr(TML, "_rademacher_probes",
                   lambda n, p, dtype, device, generator: torch.as_tensor(
                       Z, dtype=dtype).to(device))
        for name, cls in (("jax", JaxGP), ("torch", GP)):
            gp = cls(x, y, init_hyperparameters=HPS,
                     noise_variances=np.full(N, 1e-2), gp2Scale=True,
                     compute_device="cpu", linalg_mode="sparseCGpre",
                     args=dict(ARGS))
            val, grad = gp.marginal_likelihood \
                .log_likelihood_value_and_gradient(HPS)
            trained = gp.train(hyperparameter_bounds=BOUNDS, method="local",
                               max_iter=3)
            mean = gp.posterior_mean(xp)["m(x)"]
            var = gp.posterior_covariance(xp, variance_only=True)["v(x)"]
            out[name] = {"gp": gp, "val": val, "grad": np.asarray(grad),
                         "hps": np.asarray(trained), "mean": mean,
                         "var": var}
    return out


def test_same_morton_order_and_data(journeys):
    np.testing.assert_array_equal(journeys["torch"]["gp"].x_data,
                                  np.asarray(journeys["jax"]["gp"].x_data))


def test_lml_and_gradient_match_jax(journeys):
    j, t = journeys["jax"], journeys["torch"]
    np.testing.assert_allclose(t["val"], j["val"], rtol=1e-7)
    np.testing.assert_allclose(t["grad"], j["grad"], rtol=1e-7)


def test_train_local_gives_the_same_hyperparameters(journeys):
    j, t = journeys["jax"], journeys["torch"]
    np.testing.assert_allclose(t["hps"], j["hps"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(t["gp"].hyperparameters, t["hps"])


def test_posterior_mean_and_variance_match_jax(journeys):
    j, t = journeys["jax"], journeys["torch"]
    np.testing.assert_allclose(t["mean"], j["mean"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(t["var"], j["var"], rtol=0, atol=1e-8)


def test_gp_from_numpy_state_round_trip(journeys):
    """A port GP rebuilt from the JAX model's public state computes the
    same posterior mean as the port model that trained alongside it."""
    jgp = journeys["jax"]["gp"]
    state = {"x_data": np.asarray(jgp.x_data),
             "y_data": np.asarray(jgp.y_data),
             "noise_variances": jgp.noise_variances,
             "hyperparameters": np.asarray(jgp.hyperparameters),
             "args": dict(jgp.args), "linalg_mode": "sparseCGpre"}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        gp = gp_from_numpy_state(state, compute_device="cpu")
    np.testing.assert_array_equal(gp.x_data, state["x_data"])
    np.testing.assert_allclose(gp.hyperparameters, state["hyperparameters"])
    _, _, xp = _data()
    np.testing.assert_allclose(gp.posterior_mean(xp)["m(x)"],
                               journeys["jax"]["mean"], rtol=0, atol=1e-6)
    shuffled = dict(state, x_data=state["x_data"][::-1].copy())
    with pytest.raises(ValueError):
        gp_from_numpy_state(shuffled, compute_device="cpu")


def test_float32_fused_route_matches_dense_oracle():
    """dtype=float32 engages the fused row-aligned (K2) committed path —
    its plain version on the CPU; posteriors within float32 tolerance of
    the dense oracle (the JAX package's test_fused_committed_solver_end_
    to_end_f32)."""
    from fvgp_tpu_torch.kernels import wendland_anisotropic
    rng = np.random.default_rng(7)
    n = 1200
    x = rng.uniform(0, 16, (n, 3))
    y = np.sin(x[:, 0]) + 0.03 * rng.standard_normal(n)
    hps = np.array([1.0, 2.0, 2.0, 2.0])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        gp = GP(x, y, init_hyperparameters=hps,
                noise_variances=np.full(n, 1e-2), gp2Scale=True,
                compute_device="cpu", linalg_mode="sparseCGpre",
                args={"gp2Scale_block_size": 64, "dtype": "float32",
                      "gp2Scale_posterior_budget": int(1.6e7)})
    xp = rng.uniform(0, 16, (30, 3))
    pv = gp.posterior_covariance(xp, variance_only=True)["v(x)"]
    pm = gp.posterior_mean(xp)["m(x)"]
    ctx = gp.kv._fast_solver_ctx
    assert ctx["rows"].shape != ctx["cols"].shape     # rowsc engaged
    xd = torch.as_tensor(gp.x_data)
    h = torch.as_tensor(hps)
    xpt = torch.as_tensor(xp)
    K = wendland_anisotropic(xd, xd, h).numpy() + np.eye(n) * 1e-2
    ks = wendland_anisotropic(xd, xpt, h).numpy()
    kk = wendland_anisotropic(xpt, xpt, h).numpy()
    yd = gp.y_data[:, 0]
    mo = yd.mean() + ks.T @ np.linalg.solve(K, yd - yd.mean())
    vo = np.diag(kk - ks.T @ np.linalg.solve(K, ks))
    np.testing.assert_allclose(pm, mo, atol=5e-4)
    np.testing.assert_allclose(pv, vo, atol=5e-4)


@pytest.fixture
def two_threads():
    """Small problems of many short torch ops: with the suite's workers
    sharing the cores, a full-width intra-op pool mostly waits on itself."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


OPTIONS = {"gp2Scale_solver": "slq", "random_logdet_lanczos_degree": 12,
           "gp2Scale_posterior_precond": "two_level",
           "gp2Scale_posterior_coarse_width": 2}


@pytest.fixture(scope="module")
def options(journeys):
    """The solver options of the gp2Scale engine, in both packages at the
    same probes: the SLQ training solver at degree 12 (LML + gradient) and
    the two-level committed posterior solve with coarse width 2; then the
    port alone with each option moved back (mBCG, degree 20, block-Jacobi,
    coarse width 1).  Each of the four arguments must change what the port
    computes."""
    x, y, xp = _data()
    Z = _probes(-(-N // B))
    out = {}
    with pytest.MonkeyPatch.context() as mp, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mp.setattr(jax.random, "rademacher",
                   lambda key, shape, dtype=jnp.float64: jnp.asarray(
                       Z, dtype))
        mp.setattr(TML, "_rademacher_probes",
                   lambda n, p, dtype, device, generator: torch.as_tensor(
                       Z, dtype=dtype).to(device))
        for name, cls in (("jax", JaxGP), ("torch", GP)):
            gp = cls(x, y, init_hyperparameters=HPS,
                     noise_variances=np.full(N, 1e-2), gp2Scale=True,
                     compute_device="cpu", linalg_mode="sparseCGpre",
                     args=dict(ARGS, **OPTIONS))
            val, grad = gp.marginal_likelihood \
                .log_likelihood_value_and_gradient(HPS)
            var = gp.posterior_covariance(xp, variance_only=True)["v(x)"]
            out[name] = {"gp": gp, "val": val, "grad": np.asarray(grad),
                         "var": var,
                         "iters": int(gp.kv.last_solve_info["iterations"]),
                         "lml_var": gp.marginal_likelihood
                         .log_likelihood_variance()}
        gp = out["torch"]["gp"]
        ml = gp.marginal_likelihood
        gp.args["random_logdet_lanczos_degree"] = 20
        out["degree 20"] = ml.log_likelihood_value_and_gradient(HPS)[0]
        out["coarse"] = gp.kv._fast_solver_ctx["Minv"][1].shape
        for key, value in (("gp2Scale_posterior_coarse_width", 1),
                           ("gp2Scale_posterior_precond", "block_jacobi")):
            gp.args[key] = value
            v = gp.posterior_covariance(xp, variance_only=True)["v(x)"]
            ctx = gp.kv._fast_solver_ctx
            out[value] = (v, int(gp.kv.last_solve_info["iterations"]),
                          ctx["Minv"], gp.kv.last_solve_info)
    return out


def test_gp2scale_solver_selects_slq(options, journeys):
    """``gp2Scale_solver="slq"``: the port's LML and gradient are the JAX
    package's SLQ estimate at the same probes, not the mBCG one."""
    j, t = options["jax"], options["torch"]
    np.testing.assert_allclose(t["val"], j["val"], rtol=1e-8)
    np.testing.assert_allclose(t["grad"], j["grad"], rtol=1e-8)
    np.testing.assert_allclose(t["lml_var"], j["lml_var"], rtol=1e-8)
    mbcg = journeys["torch"]["val"]
    assert abs(t["val"] - mbcg) > 1e-6 * abs(mbcg)


def test_lanczos_degree_is_read(options):
    """``random_logdet_lanczos_degree`` sets the SLQ degree (12 against the
    default 20)."""
    t = options["torch"]
    assert abs(options["degree 20"] - t["val"]) > 1e-8 * abs(t["val"])
    assert t["gp"].kv.last_logdet_info["degree"] == 20


def test_posterior_precond_two_level(options):
    """``gp2Scale_posterior_precond="two_level"`` runs the two-level
    committed solve: the JAX package's iteration count (±1: the float32
    coarse inverses differ in their last bits) and its variances, where
    block-Jacobi takes another count to the same variances."""
    j, t = options["jax"], options["torch"]
    assert abs(t["iters"] - j["iters"]) <= 1
    # both CGs freeze at a relative residual of 1e-7
    np.testing.assert_allclose(t["var"], j["var"], rtol=0, atol=1e-6)
    v_bj, it_bj, pdata, info = options["block_jacobi"]
    assert isinstance(pdata, torch.Tensor) and it_bj != t["iters"]
    assert info["preconditioner"] == "block_jacobi"
    assert t["gp"].kv.last_solve_info["preconditioner"] == "block_jacobi"
    np.testing.assert_allclose(v_bj, t["var"], rtol=0, atol=1e-6)


def test_posterior_coarse_width_is_read(options):
    """``gp2Scale_posterior_coarse_width`` sets the coarse grid: 15 point
    blocks in groups of 2 give an 8 x 8 coarse inverse, groups of 1 a
    15 x 15 one."""
    nb = -(-N // B)
    assert options["coarse"] == (-(-nb // 2),) * 2
    v1, _, pdata, _ = options[1]
    assert pdata[1].shape == (nb, nb)
    np.testing.assert_allclose(v1, options["torch"]["var"], rtol=0,
                               atol=1e-6)


def _slq_model(x, y):
    return GP(x, y, init_hyperparameters=HPS,
              noise_variances=np.full(N, 1e-2), gp2Scale=True,
              compute_device="cpu", linalg_mode="sparseCGpre",
              args=dict(ARGS, gp2Scale_solver="slq"))


def test_gp2scale_hessian_is_central_differences_of_the_gradient(
        two_threads):
    """Under gp2Scale the Hessian is central differences of the gradient at
    the steps 1e-3·max(1, |h_i|), symmetrized; each gradient draws fresh
    probes (generator seed 42 + its call count), so replaying the calls
    from the same count gives the same matrix."""
    x, y, _ = _data()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        gp = _slq_model(x, y)
        ml = gp.marginal_likelihood
        ml.log_likelihood_value_and_gradient(HPS)
        entry, = ml._sparse_cache.values()
        start = entry["counter"]
        H = ml.neg_log_likelihood_hessian(HPS)
        assert entry["counter"] == start + 2 * len(HPS)
        entry["counter"] = start
        d2 = np.zeros((len(HPS), len(HPS)))
        for i in range(len(HPS)):
            e = 1e-3 * max(1.0, abs(HPS[i]))
            d2[i] = (ml.neg_log_likelihood_gradient(HPS + e * np.eye(4)[i])
                     - ml.neg_log_likelihood_gradient(HPS - e * np.eye(4)[i])
                     ) / (2 * e)
    np.testing.assert_array_equal(H, 0.5 * (d2 + d2.T))


def test_gp2scale_hessian_against_the_exact_dense_hessian(two_threads):
    """At fixed probes the gp2Scale Hessian (SLQ solver) against the exact
    Hessian of the dense GP with the same Wendland kernel.  What separates
    them is the fixed-probe error e(h) of the log-determinant, whose
    standard deviation is the reported sqrt(log_likelihood_variance()); it
    varies with h on the scale of h itself, so its second derivative is of
    order sqrt(v) / (h_i h_j): allowed 8 of those per entry."""
    from fvgp_tpu_torch.kernels import wendland_anisotropic
    x, y, _ = _data()
    Z = _probes(-(-N // B))
    with pytest.MonkeyPatch.context() as mp, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mp.setattr(TML, "_rademacher_probes",
                   lambda n, p, dtype, device, generator: torch.as_tensor(
                       Z, dtype=dtype).to(device))
        gp = _slq_model(x, y)
        H = gp.marginal_likelihood.neg_log_likelihood_hessian(HPS)
        v = gp.marginal_likelihood.log_likelihood_variance()
        dense = GP(x, y, init_hyperparameters=HPS,
                   noise_variances=np.full(N, 1e-2), compute_device="cpu",
                   kernel_function=wendland_anisotropic)
        exact = dense.marginal_likelihood.neg_log_likelihood_hessian(HPS)
    assert v > 0
    np.testing.assert_array_less(np.abs(H - exact),
                                 8 * np.sqrt(v) / np.outer(HPS, HPS))
