"""The dense path's kernels and linear algebra held against the JAX package
on the CPU (float64): K3 ``dense_covariance`` and K4 ``block_spmv`` — their
plain versions against the Pallas kernels in interpret mode, or, for the
slow Matérn case, against ``default_matern_ard`` — the stationary kernel
catalog, the CPU dispatch of ``default_matern_ard``, and ``ops/dense``.
The kernels themselves run only on a card (tests/test_torch_kernels_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvgp_tpu import kernels as JK
from fvgp_tpu.ops import dense as JD
from fvgp_tpu.ops import pallas_kernels as PK
from fvgp_tpu.parallel.block_sparse import BlockSparseMatrix
from fvgp_tpu_torch import kernels as TK
from fvgp_tpu_torch.ops import dense as TD
from fvgp_tpu_torch.ops import hopper_kernels as HK

T = torch.as_tensor


# ---------------------------------------------------------------------------
# K3 and K4: the four cases of tests/test_pallas_kernels.py
# ---------------------------------------------------------------------------

def test_k3_plain_matern_matches_jax_default_kernel(rng):
    x1 = rng.uniform(0, 5, (70, 3))
    x2 = rng.uniform(0, 5, (50, 3))
    hps = np.array([1.3, 0.8, 1.1, 2.0])
    K = HK.dense_covariance(T(x1), T(x2), T(hps), kind="matern32")
    ref = np.asarray(JK.default_matern_ard(x1, x2, hps))
    assert K.dtype == torch.float64
    np.testing.assert_allclose(K.numpy(), ref, rtol=0, atol=1e-10)


def test_k3_plain_wendland_matches_pallas(rng):
    x1 = rng.uniform(0, 8, (60, 2))
    hps = np.array([0.7, 1.5, 1.5])
    K = HK.dense_covariance_reference(T(x1), T(x1), T(hps), kind="wendland")
    ref = np.asarray(PK.dense_covariance(x1, x1, hps, kind="wendland",
                                         tile=32))
    np.testing.assert_allclose(K.numpy(), ref, rtol=0, atol=1e-10)
    np.testing.assert_array_equal(np.diag(K.numpy()), np.full(60, 0.7))


def test_k4_plain_matches_pallas_block_spmv(rng):
    B, nb = 16, 5
    n = nb * B - 7          # ragged logical size
    entries = [(0, 0), (0, 1), (1, 1), (1, 3), (3, 0), (3, 3)]
    tiles = rng.standard_normal((len(entries), B, B))
    rows = np.array([e[0] for e in entries], np.int32)
    cols = np.array([e[1] for e in entries], np.int32)
    bsm = BlockSparseMatrix(n, n, B, rows, cols, tiles)
    X = rng.standard_normal((n, 4))
    tiles_j = np.array(bsm.tiles)
    ref = np.asarray(PK.block_spmv(rows, cols, jnp.asarray(tiles_j), X, nb,
                                   B))
    got = HK.block_spmv(T(rows), T(cols), T(tiles_j), T(X), nb, B)
    assert got.shape == (n, 4) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-10)
    np.testing.assert_allclose(got.numpy(), np.asarray(bsm.to_dense()) @ X,
                               rtol=0, atol=1e-10)


def test_k4_plain_sentinels_and_1d_x_match_pallas(rng):
    """Sentinel-padded tile lists (rows == nb, zero tiles) are no-ops; a
    1-D X comes back 1-D; ``n`` truncates."""
    B, nb = 8, 3
    n = nb * B
    tiles = rng.standard_normal((3, B, B))
    rows = np.array([0, 1, 2, nb, nb], np.int32)
    cols = np.array([0, 1, 2, nb, nb], np.int32)
    tiles_p = np.concatenate([tiles, np.zeros((2, B, B))])
    X = rng.standard_normal(n)
    ref = np.asarray(PK.block_spmv(rows, cols, jnp.asarray(tiles_p), X, nb,
                                   B))
    got = HK.block_spmv(T(rows), T(cols), T(tiles_p), T(X), nb, B)
    assert got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-10)
    short = HK.block_spmv_reference(T(rows), T(cols), T(tiles_p), T(X), nb,
                                    B, n=n - 5)
    np.testing.assert_allclose(short.numpy(), ref[:n - 5], rtol=0,
                               atol=1e-10)


def test_k4_plain_accumulates_float32_and_returns_x_dtype(rng):
    B, nb = 8, 4
    rows = np.array([0, 0, 2], np.int32)
    cols = np.array([1, 3, 2], np.int32)
    tiles = rng.standard_normal((3, B, B))
    X = rng.standard_normal((nb * B, 3))
    exact = HK.block_spmv_reference(T(rows), T(cols), T(tiles), T(X), nb, B)
    got = HK.block_spmv_reference(
        T(rows), T(cols), T(tiles, dtype=torch.bfloat16),
        T(X, dtype=torch.bfloat16), nb, B)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), exact.numpy(), rtol=0,
                               atol=2e-2 * float(exact.abs().max()))
    np.testing.assert_array_equal(got[B:2 * B].float().numpy(), 0.0)


@pytest.mark.parametrize("kind", ["matern32", "wendland"])
@pytest.mark.parametrize("D", [1, 2, 3, 8, 32])
@pytest.mark.parametrize("n", [1, 33, 301])
def test_k3_plain_matches_pallas_over_shapes(n, D, kind):
    """The plain K3 against the Pallas kernel in interpret mode (float64,
    1e-12) over the dimensions the card's kernel treats apart — a template
    parameter for D <= 4, a run-time loop up to 32 — and sizes of one
    element, just past a tile edge and ragged; x2 seven rows shorter."""
    rng = np.random.default_rng(100 * D + n)
    x1 = rng.uniform(0, 4, (n, D))
    x2 = rng.uniform(0, 4, (max(1, n - 7), D))
    hps = np.concatenate([[1.3], rng.uniform(1.0, 3.0, D)])
    K = HK.dense_covariance_reference(T(x1), T(x2), T(hps), kind=kind)
    ref = np.asarray(PK.dense_covariance(x1, x2, hps, kind=kind, tile=64))
    assert K.shape == ref.shape and K.dtype == torch.float64
    np.testing.assert_allclose(K.numpy(), ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("n2,dtype,vector", [
    (10_000, torch.float32, True), (500, torch.float32, True),
    (1002, torch.float32, False), (999, torch.float32, False),
    (1, torch.float32, False), (1002, torch.float64, True),
    (999, torch.float64, False), (1, torch.float64, False)])
def test_k3_store_instance_follows_n2_and_dtype(n2, dtype, vector):
    """Which instance of the card's kernel a shape takes: 16-byte stores only
    where every row of the output starts 16-byte aligned (n2 % 4 == 0 in
    float32, n2 % 2 == 0 in float64), the scalar-store instance elsewhere."""
    assert HK._cov_vector_stores(n2, dtype) is vector


def test_k3_symmetric_route_is_decided_by_storage_not_values():
    """``x2`` counts as ``x1`` only when it is the same data: one address,
    shape, strides, dtype.  Equal values in another tensor, a shorter view,
    a strided view or another dtype's view of the bytes do not."""
    x = torch.arange(24.0).reshape(6, 4)
    assert HK._same_storage(x, x)
    assert HK._same_storage(x, x[:])                  # a full view
    assert HK._same_storage(x, x.view(6, 4))
    assert not HK._same_storage(x, x.clone())         # equal values
    assert not HK._same_storage(x, x[:5])             # same address, shorter
    assert not HK._same_storage(x, x[1:])
    assert not HK._same_storage(x[:, ::2], x[:, :2])  # same address and shape
    assert not HK._same_storage(x, x.view(torch.int32))      # another dtype
    wide = x[:, ::2]
    assert HK._same_storage(wide, x[:, ::2])          # the same strided view


def test_k3_symmetric_route_is_taken_where_the_arithmetic_sets_the_time():
    """One tensor takes the symmetric route in float64 and, in float32,
    past the templated D <= 4; two tensors never do."""
    for D, dtype, symmetric in ((3, torch.float32, False),
                                (4, torch.float32, False),
                                (5, torch.float32, True),
                                (32, torch.float32, True),
                                (1, torch.float64, True),
                                (3, torch.float64, True)):
        x = torch.zeros((6, D), dtype=dtype)
        assert HK._cov_symmetric_route(x, x) is symmetric
        assert HK._cov_symmetric_route(x, x[:]) is symmetric
        assert not HK._cov_symmetric_route(x, x.clone())


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-12),
                                        (np.float32, 1e-5)])
@pytest.mark.parametrize("x_shape", ["2-D", "1-D"])
def test_k4_plain_with_unclamped_sentinels_matches_pallas_with_clamped(
        rng, dtype, rtol, x_shape):
    """The contract K4's launch path relies on: sentinels (row == col == nb,
    zero tiles) passed as they are give what the Pallas ``block_spmv`` gives
    for sentinels clamped into the last block — float64 at 1e-12, float32
    at 1e-5 of the output scale; a row block without tiles, ragged n."""
    B, nb = 16, 5
    n = nb * B - 7
    rows = np.array([0, 0, 1, 1, 3, 3, 4, nb, nb, nb], np.int32)
    cols = np.array([0, 1, 1, 3, 0, 4, 4, nb, nb, nb], np.int32)
    tiles = rng.standard_normal((len(rows), B, B)).astype(dtype)
    tiles[-3:] = 0.0
    X = rng.standard_normal((n, 4) if x_shape == "2-D" else n).astype(dtype)
    ref = np.asarray(PK.block_spmv(np.minimum(rows, nb - 1),
                                   np.minimum(cols, nb - 1),
                                   jnp.asarray(tiles), X, nb, B))
    got = HK.block_spmv(T(rows), T(cols), T(tiles), T(X), nb, B)
    assert got.shape == ref.shape == X.shape
    assert got.numpy().dtype == dtype
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=rtol * float(np.abs(ref).max()))
    np.testing.assert_array_equal(got[2 * B:3 * B].numpy(), 0.0)


def test_k4_plain_takes_lists_and_numpy_indices(rng):
    """Rows and cols as lists or numpy arrays reach the same product as
    tensors (the card's wrapper makes a new tensor from them on each call
    and so pays the schedule each time)."""
    B, nb = 8, 3
    rows, cols = [0, 1, 2, nb], [2, 1, 0, nb]
    tiles = rng.standard_normal((4, B, B))
    tiles[-1] = 0.0
    X = rng.standard_normal((nb * B, 2))
    want = HK.block_spmv(T(np.array(rows, np.int32)),
                         T(np.array(cols, np.int32)), T(tiles), T(X), nb, B)
    for r, c in ((rows, cols), (np.array(rows), np.array(cols))):
        got = HK.block_spmv(r, c, T(tiles), T(X), nb, B)
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_dense_covariance_reference_checks_its_inputs():
    with pytest.raises(ValueError, match="kind"):
        HK.dense_covariance_reference(T(np.ones((2, 2))), T(np.ones((2, 2))),
                                      T(np.ones(3)), kind="cubic")
    with pytest.raises(ValueError, match="D"):
        HK.dense_covariance_reference(T(np.ones((2, 2))), T(np.ones((2, 3))),
                                      T(np.ones(4)))


# ---------------------------------------------------------------------------
# the dispatch of default_matern_ard
# ---------------------------------------------------------------------------

def test_cpu_dispatch_of_default_kernel_never_touches_k3(rng, monkeypatch):
    def no_kernel(*args, **kwargs):
        raise AssertionError("K3 called for CPU tensors")

    HK.reset_launch_counts()
    monkeypatch.setattr(HK, "dense_covariance", no_kernel)
    x1 = T(rng.uniform(0, 4, (9, 2)))
    x2 = T(rng.uniform(0, 4, (6, 2)))
    hps = T(np.array([1.2, 0.9, 1.4]))
    K = TK.default_matern_ard(x1, x2, hps)
    ref = np.asarray(JK.default_matern_ard(x1.numpy(), x2.numpy(),
                                           hps.numpy()))
    np.testing.assert_allclose(K.numpy(), ref, rtol=0, atol=1e-12)
    assert not TK._k3_applies(x1, x2, hps)
    assert HK.dense_covariance.__name__ == "no_kernel"
    monkeypatch.undo()
    assert HK.dense_covariance.launches == 0


def test_k3_dispatch_rule_follows_the_inputs():
    """The rule itself, decided on the tensors' properties: 2-D CUDA
    float32/float64 inputs that autograd does not record (a CUDA tensor is
    imitated by its ``is_cuda`` flag, so the rule runs without a card)."""
    class FakeCuda:
        def __init__(self, t):
            self._t = t
            self.is_cuda = True

        def __getattr__(self, name):
            return getattr(self._t, name)

    x = FakeCuda(torch.zeros((4, 3)))
    h = torch.ones(4)
    assert TK._k3_applies(x, x, h)
    assert not TK._k3_applies(x, x, h.clone().requires_grad_(True))
    with torch.no_grad():
        assert TK._k3_applies(x, x, h.clone().requires_grad_(True))
    assert not TK._k3_applies(FakeCuda(torch.zeros((2, 4, 3))),
                              FakeCuda(torch.zeros((2, 4, 3))), h)
    assert not TK._k3_applies(FakeCuda(torch.zeros((4, 3),
                                                   dtype=torch.bfloat16)),
                              x, h)
    assert not TK._k3_applies(FakeCuda(torch.zeros((4, 40))),
                              FakeCuda(torch.zeros((4, 40))), h)


def test_default_kernel_gradient_matches_jax(rng):
    import jax
    x = rng.uniform(0, 4, (12, 3))
    hps = np.array([1.2, 0.9, 1.4, 0.7])
    g_ref = np.asarray(jax.grad(
        lambda h: jnp.sum(JK.default_matern_ard(x, x, h) ** 2))(hps))
    h = T(hps).requires_grad_(True)
    torch.sum(TK.default_matern_ard(T(x), T(x), h) ** 2).backward()
    np.testing.assert_allclose(h.grad.numpy(), g_ref, rtol=1e-12,
                               atol=1e-12)


# ---------------------------------------------------------------------------
# the stationary kernel catalog
# ---------------------------------------------------------------------------

_DISTANCE_KERNELS = [
    ("squared_exponential_kernel", (1.3,)),
    ("squared_exponential_kernel_robust", (0.8,)),
    ("exponential_kernel", (1.3,)),
    ("exponential_kernel_robust", (0.8,)),
    ("matern_kernel_diff1", (1.3,)),
    ("matern_kernel_diff1_robust", (0.8,)),
    ("matern_kernel_diff2", (1.3,)),
    ("matern_kernel_diff2_robust", (0.8,)),
    ("sparse_kernel", (2.5,)),
    ("periodic_kernel", (1.3, 2.0)),
    ("wendland_kernel", ()),
]


@pytest.mark.parametrize("name,params", _DISTANCE_KERNELS,
                         ids=[k[0] for k in _DISTANCE_KERNELS])
def test_stationary_kernel_matches_jax(name, params, rng):
    x1 = rng.uniform(0, 3, (15, 2))
    x2 = rng.uniform(0, 3, (11, 2))
    d_ref = np.asarray(JK.get_distance_matrix(x1, x2))
    d = TK.get_distance_matrix(T(x1), T(x2))
    np.testing.assert_allclose(d.numpy(), d_ref, rtol=0, atol=1e-13)
    got = getattr(TK, name)(d, *params)
    ref = np.asarray(getattr(JK, name)(jnp.asarray(d_ref), *params))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12)


def test_matern_grad_helper_and_high_dim_distance_match_jax(rng):
    d = rng.uniform(0, 2, (5, 4))
    dd = rng.uniform(-1, 1, (5, 4))
    np.testing.assert_allclose(
        TK.matern_kernel_diff1_grad(T(d), T(dd)).numpy(),
        np.asarray(JK.matern_kernel_diff1_grad(d, dd)), rtol=1e-12)
    x1 = rng.uniform(0, 1, (7, 40))    # D > 32: the matmul expansion
    x2 = rng.uniform(0, 1, (5, 40))
    np.testing.assert_allclose(
        TK.get_distance_matrix(T(x1), T(x2)).numpy(),
        np.asarray(JK.get_distance_matrix(x1, x2)), rtol=1e-10, atol=1e-10)


# ---------------------------------------------------------------------------
# ops/dense
# ---------------------------------------------------------------------------

def _spd(rng, n):
    A = rng.standard_normal((n, n))
    return A @ A.T + n * np.eye(n)


def test_dense_factor_solve_logdet_inverse_match_jax(rng):
    A = _spd(rng, 20)
    b = rng.standard_normal((20, 3))
    L = TD.cholesky_factor(T(A))
    np.testing.assert_allclose(L.numpy(), np.asarray(JD.cholesky_factor(A)),
                               rtol=0, atol=1e-10)
    for got, ref in (
            (TD.cholesky_solve(L, T(b)), JD.cholesky_solve(
                JD.cholesky_factor(A), b)),
            (TD.cholesky_solve(L, T(b[:, 0])), JD.cholesky_solve(
                JD.cholesky_factor(A), b[:, 0])),
            (TD.cholesky_logdet(L), JD.cholesky_logdet(JD.cholesky_factor(A))),
            (TD.inv_from_chol(L), JD.inv_from_chol(JD.cholesky_factor(A))),
            (TD.calculate_inv(T(A)), JD.calculate_inv(A)),
            (TD.calculate_logdet(T(A)), JD.calculate_logdet(A)),
            (TD.solve(T(A), T(b)), JD.solve(A, b)),
            (TD.add_diagonal(T(A), T(np.arange(20.0))),
             JD.add_diagonal(A, np.arange(20.0)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10,
                                   atol=1e-10)


def test_dense_rank_n_appends_match_jax(rng):
    A = _spd(rng, 24)
    n_old = 17
    L_old = TD.cholesky_factor(T(A[:n_old, :n_old]))
    np.testing.assert_allclose(
        TD.update_chol_factor(L_old, T(A)).numpy(),
        np.asarray(JD.update_chol_factor(
            JD.cholesky_factor(A[:n_old, :n_old]), A)), rtol=0, atol=1e-10)
    inv_old = np.linalg.inv(A[:n_old, :n_old])
    np.testing.assert_allclose(
        TD.update_inv(T(inv_old), T(A)).numpy(),
        np.asarray(JD.update_inv(inv_old, A)), rtol=0, atol=1e-10)
    ld_old = float(np.linalg.slogdet(A[:n_old, :n_old])[1])
    np.testing.assert_allclose(
        float(TD.update_logdet(ld_old, T(inv_old), T(A))),
        float(JD.update_logdet(ld_old, inv_old, A)), rtol=1e-12)


def test_non_positive_definite_raises_the_typed_error(rng):
    A = _spd(rng, 6)
    A[0, 0] = -1.0
    with pytest.raises(TD.NonPositiveDefiniteError,
                       match="not positive definite"):
        TD.cholesky_factor(T(A))
    assert isinstance(TD.NonPositiveDefiniteError(), np.linalg.LinAlgError)
    # the general inverse falls back to LU
    np.testing.assert_allclose(TD.calculate_inv(T(A)).numpy(),
                               np.linalg.inv(A), rtol=1e-10, atol=1e-10)
    # a singular system takes the least-squares fallback
    S = np.ones((4, 4))
    np.testing.assert_allclose(
        TD.solve(T(S), T(np.ones((4, 1)))).numpy(),
        np.linalg.lstsq(S, np.ones((4, 1)), rcond=None)[0], atol=1e-10)


@pytest.mark.parametrize("D,hps", [
    (1, [1.3, 2.0, 1.7]),            # GGMP's constant mean: [var, l, mean]
    (1, [0.7, 2.0, -1.5, 3.0]),
    (3, [1.3, 0.8]),                 # one lengthscale for every dimension
    (3, [1.3, 0.8, 1.1, 2.0])])
def test_k3_takes_the_lengthscales_of_the_formulas_broadcast(rng, D, hps):
    """JAX's ``default_matern_ard`` divides the points by ``hps[1:]`` with
    broadcasting; the K3 operands from ``_k3_hyperparameters`` (K3's plain
    twin here, the kernel on the card) give the same covariance."""
    x1 = rng.uniform(0, 5, (40, D))
    x2 = rng.uniform(0, 5, (30, D))
    h = np.asarray(hps)
    k3 = TK._k3_hyperparameters(T(h), D)
    K = HK.dense_covariance(T(x1), T(x2), k3, kind="matern32")
    ref = np.asarray(JK.default_matern_ard(x1, x2, h))
    np.testing.assert_allclose(K.numpy(), ref, rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        TK.default_matern_ard(T(x1), T(x2), T(h)).numpy(), ref, rtol=0,
        atol=1e-12)
    assert TK._k3_hyperparameters(T(np.ones(3)), 3) is None
