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
                     linalg_mode="sparseCGpre", args=dict(ARGS))
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
        gp_from_numpy_state(shuffled)


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
                linalg_mode="sparseCGpre",
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
