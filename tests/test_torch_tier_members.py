"""The tier objects every ``GP`` carries (``gp.kv``,
``gp.marginal_likelihood``, ``gp.posterior``, ``gp.trainer``): the members
the port had missed, and host (numpy) inputs to their methods and to the
kernel catalog, against ``fvgp_tpu`` on the CPU in float64.

Tolerance 1e-8 (the kernel catalog 1e-12).  The stored-K sparse mode draws
its SLQ probes from a matrix injected into both packages, so its
log-determinant is compared at 1e-8 as well."""

import inspect
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch
from scipy.sparse import diags

import fvgp_tpu.ops.slq as JSLQ
import fvgp_tpu_torch.ops.slq as TSLQ
from fvgp_tpu import GP as JaxGP
from fvgp_tpu import kernels as JK
from fvgp_tpu.models.gp_kv import GPkv as JaxGPkv
from fvgp_tpu.models.gp_kv import resolve_linalg_mode as jax_resolve
from fvgp_tpu_torch import GP, config
from fvgp_tpu_torch import kernels as TK
from fvgp_tpu_torch.models.gp_kv import GPkv, resolve_linalg_mode
from fvgp_tpu_torch.parallel.block_sparse import is_block_sparse

TOL = 1e-8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: under the suite's
    parallel workers torch's default of a thread per core oversubscribes
    the cores, and loops of small tensor ops slow down tenfold and more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64),
                               rtol=tol, atol=tol)


def _host(a):
    return config.to_numpy(a) if torch.is_tensor(a) else np.asarray(a)


def _data(n=40, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 8, (n, 2))
    return x, np.sin(x[:, 0]) + 0.1 * np.cos(x[:, 1]), \
        rng.uniform(0, 8, (5, 2))


HPS = np.array([1.2, 1.5, 0.8])


def _pair(mode=None, **kw):
    x, y, _ = _data()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (GP(x, y, init_hyperparameters=HPS, linalg_mode=mode,
                   compute_device="cpu", **kw),
                JaxGP(x, y, init_hyperparameters=HPS, linalg_mode=mode, **kw))


def _cho_triple():
    """A numpy ``[factor, solve, logdet]`` mode, the same in both packages
    (a CPU tensor and a jnp array both read as numpy)."""
    return [lambda KV: scipy.linalg.cho_factor(np.asarray(KV)),
            lambda f, b: scipy.linalg.cho_solve(f, np.asarray(b)),
            lambda f: 2.0 * float(np.sum(np.log(np.diag(f[0]))))]


# ---------------------------------------------------------------------------
# the faults repaired
# ---------------------------------------------------------------------------

def test_resolve_linalg_mode_passes_a_custom_mode():
    """A custom mode and its args pass unchanged, as in the JAX package;
    the aliases resolve as before."""
    triple = _cho_triple()
    for mode, args in ((triple, {"z": 2}), ("sparseCGpre_amg", {"k": 1}),
                       ("Chol", None)):
        got, jgot = resolve_linalg_mode(mode, args), jax_resolve(mode, args)
        assert got[0] is jgot[0] or got[0] == jgot[0]
        assert got[1] == jgot[1]
    assert resolve_linalg_mode(triple, {"z": 2})[0] is triple


def test_matrix_fingerprint_takes_numpy():
    """The same tuple for a numpy matrix and its tensor, and the JAX
    package's."""
    rng = np.random.default_rng(1)
    A = rng.standard_normal((7, 7))
    A = A @ A.T + 7 * np.eye(7)
    fp = GPkv.matrix_fingerprint(A)
    assert fp == GPkv.matrix_fingerprint(torch.as_tensor(A))
    jfp = JaxGPkv.matrix_fingerprint(A)
    assert fp[:2] == jfp[:2]
    _close(fp[2:], jfp[2:])
    assert GPkv.matrix_fingerprint(None) is None


def test_sparse_factories_take_the_jax_parameter_order():
    """``make_sparse_lml`` and ``make_committed_solver`` list their
    parameters in the JAX package's order."""
    import fvgp_tpu.ops.sparse_lml as JSL
    import fvgp_tpu_torch.ops.sparse_lml as TSL
    for name in ("make_sparse_lml", "make_committed_solver",
                 "make_padded_inputs"):
        ours = [p for p in inspect.signature(getattr(TSL, name)).parameters
                if p != "device"]
        assert ours == list(inspect.signature(
            getattr(JSL, name)).parameters), name


def _catalog_args(name, rng):
    """Host inputs with n1 != n2: (x1, x2[, hps]) for the stationary
    kernels; the dot-product kernels take (D, n) inputs and a numpy
    matrix or exponent."""
    x1, x2 = rng.uniform(0, 3, (9, 2)), rng.uniform(0, 3, (6, 2))
    if name == "get_distance_matrix":
        return x1, x2
    if name == "dot_product_kernel":
        return x1.T, x2.T, 0.3, np.diag([1.0, 2.0])
    if name == "polynomial_kernel":
        return x1.T, x2.T, 2
    return x1, x2, HPS


@pytest.mark.parametrize("name", ["get_distance_matrix",
                                  "wendland_anisotropic",
                                  "default_matern_ard",
                                  "dot_product_kernel",
                                  "polynomial_kernel"])
def test_kernel_catalog_takes_host_arrays(name):
    """numpy inputs (n1 != n2) give a tensor equal to ``fvgp_tpu.kernels``
    at 1e-12; a list is taken too, and host arrays beside a tensor follow
    its device and dtype (a float32 tensor with float64 numpy operands
    gives float32, equal to the float64 result at float32 rounding)."""
    args = _catalog_args(name, np.random.default_rng(2))
    got = getattr(TK, name)(*args)
    assert torch.is_tensor(got) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(getattr(JK, name)(*args)),
                               rtol=0, atol=1e-12)
    listed = getattr(TK, name)(*(a.tolist() if isinstance(a, np.ndarray)
                                 else a for a in args))
    np.testing.assert_allclose(listed.numpy(), got.numpy(), rtol=0,
                               atol=1e-12)
    mixed = getattr(TK, name)(torch.as_tensor(args[0]), *args[1:])
    assert mixed.device == torch.device("cpu")
    np.testing.assert_array_equal(mixed.numpy(), got.numpy())
    single = getattr(TK, name)(torch.as_tensor(args[0], dtype=torch.float32),
                               *args[1:])
    assert single.dtype == torch.float32
    np.testing.assert_allclose(single.double().numpy(), got.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_add_noise_warns_on_an_unusable_noise_format():
    """A noise callable whose result is neither a vector nor a matrix: the
    JAX package's warning, and v, S unchanged."""
    x, y, _ = _data()
    for cls, kw in ((GP, {"compute_device": "cpu"}), (JaxGP, {})):
        gp = cls(x, y, init_hyperparameters=HPS,
                 noise_function=lambda xx, hps: np.full(len(xx), 0.01), **kw)
        gp.likelihood.calculate_V = lambda xx, hps: np.ones((3, 3, 3))
        with pytest.warns(UserWarning, match="Noise could not be added"):
            v, S = gp.posterior.add_noise(x[:3], np.ones(3), np.eye(3))
        np.testing.assert_array_equal(v, np.ones(3))
        np.testing.assert_array_equal(S, np.eye(3))


def test_posterior_takes_a_host_compute_covariances():
    """A ``compute_covariances`` replaced by a host callable returning
    numpy (here it skews k(x*, x*)): the posterior covariance, mean and
    relative information entropy equal the JAX package's."""
    x, y, xp = _data()
    out = []
    for gp in _pair():
        orig = gp.prior.compute_covariances

        def skewed(x1, x2, hps, orig=orig):
            k = _host(orig(x1, x2, hps))
            return k + 0.01 * np.eye(len(x1)) if len(x1) == len(x2) == 5 \
                else k
        gp.prior.compute_covariances = skewed
        cov = gp.posterior_covariance(xp)
        out.append((cov["S"], cov["v(x)"], gp.posterior_mean(xp)["m(x)"],
                    gp.gp_relative_information_entropy(xp)["RIE"]))
    for got, want in zip(*out):
        _close(got, want)


def test_addkv_takes_host_arrays():
    """Dense K with a vector, a matrix and a scipy V, all numpy, and a
    block-sparse K with a numpy diagonal: the JAX package's K+V."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((6, 6))
    K = A @ A.T + 6 * np.eye(6)
    v = np.full(6, 0.5)
    for V in (v, np.diag(v), diags(v), list(v)):
        got = GPkv.addKV(K, V)
        assert torch.is_tensor(got)
        _close(got, JaxGPkv.addKV(K, V))
    with pytest.raises(AssertionError, match="square"):
        GPkv.addKV(np.ones((4, 6)), np.ones(4))
    with pytest.raises(Exception, match="K\\+V"):
        GPkv.addKV(np.eye(4), np.ones((4, 4, 4)))
    from fvgp_tpu_torch.parallel.block_sparse import BlockSparseMatrix
    bsm = BlockSparseMatrix(8, 8, 4, np.array([0, 1]), np.array([0, 1]),
                            np.stack([np.eye(4), np.eye(4)]), device="cpu")
    out = GPkv.addKV(bsm, np.full(8, 0.25))
    assert is_block_sparse(out)
    _close(out.to_dense(), 1.25 * np.eye(8))


def test_kv_solves_take_host_arrays():
    """``solve`` and ``compute_new_KVinvY`` on numpy right-hand sides,
    matrices and means: the JAX package's solutions."""
    tgp, jgp = _pair()
    b = np.random.default_rng(3).standard_normal((40, 2))
    _close(tgp.kv.solve(b), jgp.kv.solve(b))
    KV = _host(jgp.kv.KV) + 0.1 * np.eye(40)
    m = np.full(40, 0.2)
    _close(tgp.kv.compute_new_KVinvY(KV, m), jgp.kv.compute_new_KVinvY(KV, m))
    _close(tgp.marginal_likelihood.compute_new_KVinvY(KV, m),
           jgp.marginal_likelihood.compute_new_KVinvY(KV, m))


def test_kv_methods_move_a_tensor_to_the_model_dtype():
    """A float32 tensor handed to the float64 model's methods is taken in
    the model's dtype: the result is float64 and equals the JAX package's
    on the same float32-rounded matrix."""
    tgp, jgp = _pair()
    KV = (_host(jgp.kv.KV) + 0.1 * np.eye(40)).astype(np.float32)
    m = np.full(40, 0.2)
    got = tgp.kv.compute_new_KVinvY(torch.as_tensor(KV), m)
    assert got.dtype == torch.float64
    _close(got, jgp.kv.compute_new_KVinvY(KV.astype(np.float64), m))
    fp = GPkv.matrix_fingerprint(KV)
    assert fp == GPkv.matrix_fingerprint(torch.as_tensor(KV))


@pytest.mark.cuda
def test_host_operands_reach_a_model_on_the_card():
    """On the card (float32 model), a K+V that ``addKV`` made from numpy K
    and V and a K that the catalog made from numpy alone (both on the card
    in float64) go into ``compute_new_KVinvY`` and
    ``compute_new_KVlogdet_KVinvY``; the results equal the CPU float64
    model's within 1e-4 of their scale (float32 rounding at a condition
    number near 1e2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    x, y, _ = _data()
    V, m = np.full(len(x), 0.1), np.zeros(len(x))
    K = TK.default_matern_ard(x, x, HPS)
    assert K.device.type == "cuda" and K.dtype == torch.float64
    KV = GPkv.addKV(_host(K), V)
    assert KV.device.type == "cuda"
    out = {}
    for device in ("cpu", "cuda"):
        gp = GP(x, y, init_hyperparameters=HPS, compute_device=device)
        a = gp.kv.compute_new_KVinvY(KV, m)
        b, logdet = gp.kv.compute_new_KVlogdet_KVinvY(K, V, m)
        assert a.device.type == b.device.type == device
        out[device] = (_host(a), _host(b), logdet)
    for got, want in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


# ---------------------------------------------------------------------------
# the members added
# ---------------------------------------------------------------------------

def test_tier_views_match_jax():
    """``GPkv.K`` / ``m`` / ``V``, ``GPposterior.args`` / ``KVinvY`` /
    ``KVinv`` / ``input_set_dim`` / ``K`` / ``m``,
    ``GPMarginalLikelihood.ram_economy`` / ``gp2Scale`` and
    ``GPtraining.gp2Scale``: views of the port's own state, equal to the
    JAX package's."""
    tgp, jgp = _pair("CholInv", ram_economy=True)
    for tier in ("kv", "posterior"):
        t, j = getattr(tgp, tier), getattr(jgp, tier)
        for name in ("K", "m"):
            assert getattr(t, name) is getattr(tgp.prior, name)
            _close(getattr(t, name), getattr(j, name))
    assert tgp.kv.V is tgp.likelihood.V
    _close(tgp.kv.V, jgp.kv.V)
    p, jp = tgp.posterior, jgp.posterior
    assert p.args is tgp.args and p.args == jp.args
    assert p.KVinvY is tgp.kv.KVinvY and p.KVinv is tgp.kv.KVinv
    _close(p.KVinvY, jp.KVinvY)
    _close(p.KVinv, jp.KVinv)
    assert p.input_set_dim == jp.input_set_dim == 2
    ml, jml = tgp.marginal_likelihood, jgp.marginal_likelihood
    assert ml.ram_economy is jml.ram_economy is True
    for obj, jobj in ((ml, jml), (tgp.trainer, jgp.trainer)):
        assert obj.gp2Scale is jobj.gp2Scale is False


def _stored_pair():
    """A gp2Scale model on the stored K (sparseCGpre), in both packages,
    whose SLQ draws exactly one batch of 32 probes."""
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 40, (500, 2))
    y = np.sin(x[:, 0]) + 0.05 * rng.standard_normal(500)
    args = {"gp2Scale_block_size": 64, "gp2Scale_traced_lml": False,
            "sparse_cg_tol": 1e-12, "random_logdet_min_num_samples": 32,
            "random_logdet_max_num_samples": 32}
    kw = dict(init_hyperparameters=np.array([1.0, 1.5, 1.5]), gp2Scale=True,
              linalg_mode="sparseCGpre")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (GP(x, y, args=dict(args), compute_device="cpu", **kw),
                JaxGP(x, y, args=dict(args), **kw))


@pytest.fixture
def injected_probes(monkeypatch):
    """One (n, 32) Rademacher matrix as the SLQ probes of both packages."""
    Z = np.where(np.random.default_rng(9).random((500, 32)) < 0.5, -1.0, 1.0)

    def port_probes(n, p, dtype, device, generator):
        return torch.as_tensor(Z[:n, :p], dtype=dtype).to(device)

    def jax_batch(fn, data, key, n, degree, num, dtype):
        z = jnp.asarray(Z[:n, :num].T, dtype)
        return jax.vmap(lambda zz: JSLQ._probe_quadrature(fn, data, zz,
                                                          degree))(z)
    monkeypatch.setattr(TSLQ, "rademacher_probes", port_probes)
    monkeypatch.setattr(JSLQ, "_probe_batch", jax_batch)


@pytest.mark.parametrize("mode", ["Chol", "custom", "sparseCGpre"])
def test_compute_new_kvlogdet_kvinvy_matches_jax(mode, request):
    """``compute_new_KVlogdet_KVinvY`` of ``gp.kv`` and
    ``gp.marginal_likelihood`` on host (numpy) K, V and m at trial
    hyperparameters — dense ``Chol``, a custom triple, and ``sparseCGpre``
    on the stored block-sparse K (CG and the SLQ log-determinant, at
    injected probes) — against the JAX package's, and against the trial
    LML that the port computes through its own path."""
    if mode == "sparseCGpre":
        request.getfixturevalue("injected_probes")
        tgp, jgp = _stored_pair()
        K, jK = tgp.kv.K, jgp.kv.K
        assert is_block_sparse(K)
    else:
        tgp, jgp = _pair(_cho_triple() if mode == "custom" else mode)
        hps = HPS * 1.1
        K = jK = _host(jgp.prior.compute_prior_covariance_matrix(
            jgp.x_data, hps))
    V, m = _host(jgp.kv.V), _host(jgp.kv.m)
    for tier in ("kv", "marginal_likelihood"):
        got = getattr(tgp, tier).compute_new_KVlogdet_KVinvY(K, V, m)
        want = getattr(jgp, tier).compute_new_KVlogdet_KVinvY(jK, V, m)
        assert torch.is_tensor(got[0]) and got[0].shape == (len(m), 1)
        _close(got[0], want[0])
        _close(got[1], want[1])
    if mode == "sparseCGpre":
        # the stored K's trial LML runs the same solve and logdet
        ym = np.asarray(tgp.y_data) - m[:, None]
        lml = -0.5 * (np.sum(ym * _host(got[0])) + got[1]
                      + len(m) * np.log(2 * np.pi))
        _close(tgp.log_likelihood(tgp.hyperparameters), lml)


def test_invalidate_traced_drops_the_traced_caches(monkeypatch):
    """``invalidate_traced`` empties the traced gp2Scale LML's per-dataset
    caches; the next evaluation rebuilds them and gives the same LML, the
    JAX package's at the same injected probes."""
    import fvgp_tpu_torch.models.gp_marginal_likelihood as TML
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 30, (300, 2))
    y = np.sin(x[:, 0])
    Z = np.random.default_rng(3).choice([-1.0, 1.0], size=(320, 16))
    monkeypatch.setattr(jax.random, "rademacher",
                        lambda key, shape, dtype=jnp.float64: jnp.asarray(
                            Z, dtype))
    monkeypatch.setattr(TML, "_rademacher_probes",
                        lambda n, p, dtype, device, generator:
                        torch.as_tensor(Z, dtype=dtype).to(device))
    kw = dict(init_hyperparameters=np.array([1.0, 2.0, 2.0]), gp2Scale=True,
              noise_variances=np.full(300, 1e-2),
              args={"gp2Scale_block_size": 32,
                    "random_logdet_fixed_probes": 16})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tgp = GP(x, y, compute_device="cpu", **kw)
        jgp = JaxGP(x, y, **kw)
    ml, jml = tgp.marginal_likelihood, jgp.marginal_likelihood
    hps = np.array([1.0, 2.2, 1.9])
    before = ml.log_likelihood(hps)
    tiles = tgp.data.tile_structure
    assert ml._sparse_cache and tiles._candidates is not None
    ml.invalidate_traced()
    assert ml._sparse_cache == {} and tiles._candidates is None \
        and tiles._dead is None and tiles._exact is None
    jbefore = jml.log_likelihood(hps)
    jml.invalidate_traced()
    _close(ml.log_likelihood(hps), before)
    _close(before, jbefore)
    _close(jml.log_likelihood(hps), jbefore)
