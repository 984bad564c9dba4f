"""Structured noise in the port against the JAX package (CPU, float64, the
same seeded data): a noise callable that returns ``scipy.sparse`` or a
``BlockSparseMatrix`` on a dense K (densified) and on a block-sparse K
(tiled onto K's grid on K's device and merged), ``add_noise`` with
structured noise, the finite-difference noise gradient over structured
returns, a diagonal noise callable under gp2Scale (the committed fast
solver keeps serving it) and the tile helpers ``from_scipy`` / ``merge``.

Bounds: 1e-8 for exact paths (dense Cholesky, below-cutoff direct modes);
1e-6 where both packages take difference quotients; an SLQ log-determinant
against the exact one within 4 standard deviations of its reported
variance."""

import warnings

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from fvgp_tpu_torch import GP
from fvgp_tpu_torch.parallel import block_sparse as tbs

try:
    from fvgp_tpu import GP as JaxGP
    from fvgp_tpu.parallel import block_sparse as jbs
except ImportError:     # a card's machine without JAX runs the cuda cases
    JaxGP = jbs = None

warnings.simplefilter("ignore")

EXACT = 1e-8
QUOTIENT = 1e-6


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def banded_noise(n, level=0.05, coupling=0.02):
    """SPD tridiagonal noise with a dominant diagonal."""
    main = np.full(n, level)
    off = np.full(n - 1, coupling)
    return sps.diags([off, main, off], [-1, 0, 1]).tocsr()


def sparse_noise(x, h):
    return banded_noise(len(x))


def dense_noise(x, h):
    return banded_noise(len(x)).toarray()


def _data(n=120, d=2, seed=0, span=10.0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, span, (n, d))
    return x, np.sin(x[:, 0]) + 0.05 * rng.standard_normal(n)


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=tol, atol=tol)


def _dense(m):
    return m.toarray() if hasattr(m, "toarray") else np.asarray(m)


# -- the tile helpers ------------------------------------------------------

def test_from_scipy_and_merge_match_jax():
    """Tiles of a random sparse matrix, the merge of two (duplicate tiles
    sum), its product and fingerprint: equal to the JAX package's."""
    A = sps.random(40, 40, density=0.1, random_state=1)
    Bm = sps.random(40, 40, density=0.2, random_state=2)
    t = tbs.merge(tbs.from_scipy(A, 8, device="cpu"),
                  tbs.from_scipy(Bm, 8, device="cpu"))
    j = jbs.merge(jbs.from_scipy(A, 8), jbs.from_scipy(Bm, 8))
    _close(t.toarray(), (A + Bm).toarray(), 1e-14)
    _close(t.toarray(), _dense(j.to_dense()), 1e-14)
    v = np.random.default_rng(3).standard_normal((40, 2))
    _close(t.matmat(torch.as_tensor(v)), (A + Bm) @ v, 1e-12)
    # the JAX package sums the squares in float32 (a deviation in ROADMAP §3)
    (t_tr, t_fro), (j_tr, j_fro) = t.trace_and_fro(), j.trace_and_fro()
    _close(float(t_tr), float(j_tr), 1e-12)
    _close(float(t_fro), float(j_fro), 1e-6)
    _close(float(t_fro), np.linalg.norm((A + Bm).toarray()), 1e-12)


def test_from_scipy_takes_the_device_and_dtype_asked_for():
    A = sps.identity(20, format="csr")
    m = tbs.from_scipy(A, 8, device="cpu", dtype=torch.float32)
    assert m.device.type == "cpu" and m.tiles.dtype == torch.float32
    _close(m.toarray(), np.eye(20), 0.0)


def test_merge_refuses_mixed_devices():
    """Two matrices on two devices cannot merge: the tile lists would be
    concatenated across devices (here the CPU and the ``meta`` device)."""
    A = tbs.from_scipy(sps.identity(16, format="csr"), 8, device="cpu")
    meta = tbs.BlockSparseMatrix(16, 16, 8, np.array([0, 1]),
                                 np.array([0, 1]),
                                 torch.zeros((2, 8, 8), device="meta"))
    with pytest.raises(ValueError, match="one device"):
        tbs.merge(A, meta)


def test_merge_with_bfloat16_storage_keeps_the_noise_in_float32():
    """bfloat16-stored K + float64 noise tiles merge into float32 tiles
    (the JAX package's cap)."""
    K = tbs.from_scipy(sps.identity(16, format="csr"), 8, device="cpu",
                       dtype=torch.bfloat16)
    V = tbs.from_scipy(banded_noise(16, 1e-3, 1e-4), 8, device="cpu")
    M = tbs.merge(K, V)
    assert M.tiles.dtype == torch.float32
    jK = jbs.from_scipy(sps.identity(16, format="csr"), 8)
    jM = jbs.merge(jbs.BlockSparseMatrix(16, 16, 8, jK.rows, jK.cols,
                                         jK.tiles.astype("bfloat16")),
                   jbs.from_scipy(banded_noise(16, 1e-3, 1e-4), 8))
    assert str(jM.tiles.dtype) == "float32"
    _close(M.toarray(), _dense(jM.to_dense()), 0.0)


def test_addKV_puts_structured_noise_on_the_stored_K():
    """On a block-sparse K a scipy or block-sparse V is tiled onto K's
    grid on K's device and merged; on a dense K it is densified."""
    x, y = _data(n=48)
    gp = GP(x, y, init_hyperparameters=np.array([1.0, 2.0, 2.0]),
            gp2Scale=True, compute_device="cpu",
            args={"gp2Scale_block_size": 16, "gp2Scale_traced_lml": False})
    K = gp.K
    V = banded_noise(48)
    want = K.toarray() + V.toarray()
    for noise in (V, tbs.from_scipy(V, 16, device="cpu")):
        KV = gp.kv.addKV(K, noise)
        assert KV.device == K.device
        _close(KV.toarray(), want, 1e-14)
    dense = gp.kv.addKV(torch.as_tensor(K.toarray()), V)
    _close(dense, want, 1e-14)


# -- noise callables ---------------------------------------------------------

@pytest.mark.parametrize("kind", ["scipy", "block_sparse"])
def test_dense_gp_structured_noise_matches_jax_and_the_dense_oracle(kind):
    """A structured noise callable on the dense path: LML, posterior,
    ``add_noise`` and the formula gradient (central differences over the
    densified noise) equal to the JAX package's and to the port's model
    with the same noise passed dense."""
    x, y = _data()
    hps = np.array([1.0, 1.0, 1.0])
    fn = sparse_noise if kind == "scipy" else \
        (lambda xx, h: tbs.from_scipy(banded_noise(len(xx)), 16,
                                      device="cpu"))
    jfn = sparse_noise if kind == "scipy" else \
        (lambda xx, h: jbs.from_scipy(banded_noise(len(xx)), 16))
    tgp = GP(x, y, init_hyperparameters=hps, noise_function=fn,
             compute_device="cpu")
    jgp = JaxGP(x, y, init_hyperparameters=hps, noise_function=jfn)
    oracle = GP(x, y, init_hyperparameters=hps, noise_function=dense_noise,
                compute_device="cpu")
    xp = x[:7] + 0.1
    for ref in (jgp, oracle):
        _close(tgp.log_likelihood(), ref.log_likelihood(), EXACT)
        _close(tgp.log_likelihood(hps * 1.1), ref.log_likelihood(hps * 1.1),
               EXACT)
        _close(tgp.posterior_mean(xp)["m(x)"], ref.posterior_mean(xp)["m(x)"],
               EXACT)
        _close(tgp.posterior_covariance(xp, add_noise=True)["v(x)"],
               ref.posterior_covariance(xp, add_noise=True)["v(x)"], EXACT)
    _close(tgp.neg_log_likelihood_gradient(),
           jgp.neg_log_likelihood_gradient(), QUOTIENT)


def test_add_noise_densifies_structured_noise():
    """``posterior_covariance(add_noise=True)`` adds a structured noise's
    diagonal (and its matrix to S) as the JAX package does."""
    x, y = _data(n=80)
    hps = np.array([1.0, 1.0, 1.0])
    tgp = GP(x, y, init_hyperparameters=hps, noise_function=sparse_noise,
             compute_device="cpu")
    jgp = JaxGP(x, y, init_hyperparameters=hps, noise_function=sparse_noise)
    xp = x[:6] + 0.1
    got = tgp.posterior_covariance(xp, add_noise=True)
    ref = jgp.posterior_covariance(xp, add_noise=True)
    _close(got["v(x)"], ref["v(x)"], EXACT)
    _close(got["S"], ref["S"], EXACT)
    v0 = tgp.posterior_covariance(xp, add_noise=False)["v(x)"]
    _close(got["v(x)"] - v0, np.full(6, 0.05), 1e-12)


def test_noise_fd_gradient_densifies_structured_noise():
    """The central-difference noise gradient densifies a scipy return."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (8, 1))

    def noise(x_, h, args=None):
        return sps.diags(np.full(len(x_), h[0] * 1e-2)).tocsr()

    gp = GP(x, np.sin(x[:, 0]), init_hyperparameters=np.array([1.0, 1.0]),
            noise_function=noise, compute_device="cpu")
    jgp = JaxGP(x, np.sin(x[:, 0]), init_hyperparameters=np.array([1.0, 1.0]),
                noise_function=noise)
    g = gp.likelihood.calculate_V_grad(x, np.array([1.0, 1.0]), 0)
    _close(torch.diagonal(g), np.full(8, 1e-2), 1e-5)
    _close(g, jgp.likelihood.calculate_V_grad(x, np.array([1.0, 1.0]), 0),
           EXACT)


def _gp2(pkg_gp, x, y, hps, mode, noise, **args):
    from fvgp_tpu_torch.kernels import wendland_anisotropic as tw
    from fvgp_tpu.kernels import wendland_anisotropic as jw
    kw = dict(init_hyperparameters=hps, gp2Scale=True, linalg_mode=mode,
              noise_function=noise,
              args={"gp2Scale_block_size": 32, "gp2Scale_reorder": False,
                    "gp2Scale_lengthscales": lambda h: h[1:], **args})
    if pkg_gp is GP:
        return GP(x, y, kernel_function=tw, compute_device="cpu", **kw)
    return pkg_gp(x, y, kernel_function=jw, **kw)


def _sorted_data(n=300):
    from fvgp_tpu_torch.parallel.ordering import morton_order
    x, y = _data(n=n, span=25.0, seed=3)
    perm = morton_order(x)
    return x[perm], y[perm]


def test_gp2scale_structured_noise_matches_jax_and_the_dense_oracle():
    """Banded scipy noise under gp2Scale: the merged K+V equals the dense
    model's K+V exactly; in ``sparseLU`` (a direct solve below the dense
    cutoff) the LML and posteriors equal the JAX package's; in
    ``sparseCGpre`` the SLQ LML falls within its variance of the exact
    one."""
    from fvgp_tpu_torch.kernels import wendland_anisotropic as tw
    x, y = _sorted_data()
    hps = np.array([1.0, 2.0, 2.0])
    tgp = _gp2(GP, x, y, hps, "sparseLU", sparse_noise)
    jgp = _gp2(JaxGP, x, y, hps, "sparseLU", sparse_noise)
    oracle = GP(x, y, init_hyperparameters=hps, kernel_function=tw,
                noise_function=dense_noise, compute_device="cpu")
    assert tbs.is_block_sparse(tgp.kv.KV)
    _close(tgp.kv.KV.toarray(), oracle.K.numpy() + banded_noise(300)
           .toarray(), 1e-12)
    xp = x[:5] + 0.05
    for ref in (jgp, oracle):
        _close(tgp.log_likelihood(), ref.log_likelihood(), EXACT)
        _close(tgp.log_likelihood(hps * 1.05), ref.log_likelihood(hps * 1.05),
               EXACT)
        _close(tgp.posterior_mean(xp)["m(x)"], ref.posterior_mean(xp)["m(x)"],
               EXACT)
        _close(tgp.posterior_covariance(xp)["v(x)"],
               ref.posterior_covariance(xp)["v(x)"], EXACT)
    cg = _gp2(GP, x, y, hps, "sparseCGpre", sparse_noise,
              sparse_cg_tol=1e-12)
    assert cg.kv._fast_sparse_solver() is None       # structured: stored K+V
    lml = cg.log_likelihood()
    sd = np.sqrt(cg.marginal_likelihood.log_likelihood_variance())
    assert abs(lml - oracle.log_likelihood()) <= 4.0 * sd + 1e-8
    _close(cg.posterior_mean(xp)["m(x)"], oracle.posterior_mean(xp)["m(x)"],
           1e-7)


def test_gp2scale_diagonal_noise_callable_keeps_the_fast_solver():
    """A noise callable returning a per-point diagonal under gp2Scale: the
    committed fast solver serves the posterior (K2's path on the card), and
    the posterior equals the JAX package's; a trial LML runs on the stored
    K+V and equals JAX's in the direct mode; training switches to MCMC."""
    x, y = _sorted_data()
    hps = np.array([1.0, 2.0, 2.0])

    def diag_noise(xx, h):
        return np.full(len(xx), 0.02) + 0.01 * np.asarray(xx)[:, 0] / 25.0

    tgp = _gp2(GP, x, y, hps, "sparseCGpre", diag_noise,
               sparse_cg_tol=1e-12, gp2Scale_posterior_cg_tol=1e-12)
    jgp = _gp2(JaxGP, x, y, hps, "sparseCGpre", diag_noise,
               sparse_cg_tol=1e-12, gp2Scale_posterior_cg_tol=1e-12)
    assert not tgp.marginal_likelihood._sparse_traced_ready()
    assert tgp.kv._fast_sparse_solver() is not None
    xp = x[:5] + 0.05
    _close(tgp.posterior_mean(xp)["m(x)"], jgp.posterior_mean(xp)["m(x)"],
           1e-7)
    _close(tgp.posterior_covariance(xp, variance_only=True)["v(x)"],
           jgp.posterior_covariance(xp, variance_only=True)["v(x)"], 1e-7)
    lu = _gp2(GP, x, y, hps, "sparseLU", diag_noise)
    jlu = _gp2(JaxGP, x, y, hps, "sparseLU", diag_noise)
    _close(lu.log_likelihood(hps * 1.02), jlu.log_likelihood(hps * 1.02),
           EXACT)
    with pytest.warns(UserWarning, match="switched to MCMC"):
        lu.train(hyperparameter_bounds=np.array([[0.5, 2.0], [1.5, 2.5],
                                                 [1.5, 2.5]]),
                 method="local", max_iter=3)


@pytest.mark.cuda
def test_merged_structured_noise_runs_k1_on_the_card():
    """On the card a bfloat16-stored K plus scipy noise merges into
    float32 tiles whose product launches K1, against the float64 CPU
    product of the same matrix (float32 tiles: 1e-5 of the scale)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from fvgp_tpu_torch.ops import hopper_kernels as hk
    x, y = _sorted_data(n=1024)
    hps = np.array([1.0, 2.0, 2.0])
    args = {"gp2Scale_block_size": 128, "gp2Scale_traced_lml": False,
            "gp2Scale_storage_dtype": "bfloat16"}
    gp = GP(x, y, init_hyperparameters=hps, gp2Scale=True,
            noise_function=sparse_noise, linalg_mode="sparseCGpre",
            compute_device="cuda", args=args)
    KV = gp.kv.KV
    assert KV.tiles.dtype == torch.float32 and KV.device.type == "cuda"
    X = torch.randn(1024, 3, dtype=torch.float32, device="cuda")
    before = hk.chunked_spmm.launches
    got = KV.matmat(X).double().cpu().numpy()
    assert hk.chunked_spmm.launches == before + 1
    ref = KV.toarray() @ X.double().cpu().numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.cuda
def test_diagonal_noise_callable_posterior_runs_k2_on_the_card():
    """A diagonal noise callable under gp2Scale on the card: the committed
    posterior solve launches K2, and the mean agrees with the CPU in
    float64 (the float32 bound of the gp2Scale journey, 1e-3)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from fvgp_tpu_torch.ops import hopper_kernels as hk
    x, y = _sorted_data(n=2048)
    hps = np.array([1.0, 2.0, 2.0])

    def diag_noise(xx, h):
        return np.full(len(xx), 0.02)

    out = {}
    for device in ("cpu", "cuda"):
        gp = GP(x, y, init_hyperparameters=hps, gp2Scale=True,
                noise_function=diag_noise, linalg_mode="sparseCGpre",
                compute_device=device, args={"gp2Scale_block_size": 128})
        before = hk.row_chunk_sums.launches
        out[device] = gp.posterior_mean(x[:16] + 0.05)["m(x)"]
        if device == "cuda":
            assert hk.row_chunk_sums.launches > before
    assert np.abs(out["cuda"] - out["cpu"]).max() <= 1e-3
