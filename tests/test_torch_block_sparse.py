"""``BlockSparseMatrix`` and ``distributed_covariance`` of the port against
the JAX package: the same numpy tiles and points, made from a seed, go
through both (CPU, float64, the plain version of the K1 product).

Tolerance 1e-10 — both do the same float64 arithmetic, only the order of
the sums differs; the bfloat16 storage case is held to 1e-2 (bfloat16 keeps
8 mantissa bits of entries <= 1)."""

import pickle
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fvgp_tpu.parallel.block_sparse as jbs
import fvgp_tpu_torch.parallel.block_sparse as tbs
from fvgp_tpu import GP as JaxGP
from fvgp_tpu.kernels import wendland_anisotropic as jax_wendland
from fvgp_tpu_torch import GP
from fvgp_tpu_torch.kernels import wendland_anisotropic
from fvgp_tpu_torch.parallel.sharded_cov import distributed_covariance

ATOL = 1e-10
HPS = np.array([1.0, 1.5, 1.5])


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _random_tiles(n=50, B=16, seed=0, frac=0.6):
    """A random symmetric tile set on an n-point grid (both triangles, the
    padding region zero) and its dense oracle."""
    rng = np.random.default_rng(seed)
    nb = -(-n // B)
    rows, cols, tiles = [], [], []
    dense = np.zeros((nb * B, nb * B))
    valid = (np.arange(nb * B) < n).reshape(nb, B)
    for i in range(nb):
        for j in range(i, nb):
            if i != j and rng.uniform() > frac:
                continue
            t = rng.standard_normal((B, B))
            if i == j:
                t = t + t.T
            t = t * (valid[i][:, None] * valid[j][None, :])
            for r, c, blk in ((i, j, t),) + (((j, i, t.T),) if i != j
                                             else ()):
                rows.append(r)
                cols.append(c)
                tiles.append(blk)
                dense[r * B:(r + 1) * B, c * B:(c + 1) * B] += blk
    return (np.array(rows), np.array(cols), np.stack(tiles),
            dense[:n, :n])


def _pair(n=50, B=16, seed=0, frac=0.6):
    rows, cols, tiles, dense = _random_tiles(n, B, seed, frac)
    return (jbs.BlockSparseMatrix(n, n, B, rows, cols, tiles),
            tbs.BlockSparseMatrix(n, n, B, rows, cols, tiles, device="cpu"),
            dense)


def _rect_pair(n, m, B, seed):
    rng = np.random.default_rng(seed)
    nb, nbc = -(-n // B), -(-m // B)
    rows, cols, tiles = [], [], []
    dense = np.zeros((nb * B, nbc * B))
    for i in range(nb):
        for j in range(nbc):
            t = rng.standard_normal((B, B))
            t[max(0, n - i * B):, :] = 0.0
            t[:, max(0, m - j * B):] = 0.0
            rows.append(i)
            cols.append(j)
            tiles.append(t)
            dense[i * B:(i + 1) * B, j * B:(j + 1) * B] = t
    rows, cols, tiles = np.array(rows), np.array(cols), np.stack(tiles)
    return (jbs.BlockSparseMatrix(n, m, B, rows, cols, tiles),
            tbs.BlockSparseMatrix(n, m, B, rows, cols, tiles, device="cpu"),
            dense[:n, :m])


@pytest.mark.parametrize("seed,k", [(0, 3), (1, 1), (2, None)])
def test_matmat_diagonal_and_to_dense_match_jax(seed, k):
    J, T, dense = _pair(seed=seed)
    rng = np.random.default_rng(seed + 10)
    X = rng.standard_normal(50 if k is None else (50, k))
    got = _np(T.matmat(torch.as_tensor(X)))
    assert got.shape == X.shape
    np.testing.assert_allclose(got, np.asarray(J.matmat(jnp.asarray(X))),
                               atol=ATOL)
    np.testing.assert_allclose(got, dense @ X, atol=ATOL)
    np.testing.assert_allclose(_np(T @ torch.as_tensor(X)), got, atol=0)
    np.testing.assert_allclose(_np(T.diagonal()), np.asarray(J.diagonal()),
                               atol=ATOL)
    np.testing.assert_allclose(_np(T.to_dense()), np.asarray(J.to_dense()),
                               atol=ATOL)
    np.testing.assert_allclose(T.toarray(), dense, atol=ATOL)
    assert T.nnz == J.nnz and T.shape == J.shape
    assert T.sparsity() == pytest.approx(J.sparsity())


def test_add_diagonal_is_a_view_and_fingerprint_matches_jax():
    J, T, dense = _pair(seed=2)
    v = np.random.default_rng(2).uniform(0.5, 1.0, 50)
    Jkv, Tkv = J.add_diagonal(jnp.asarray(v)), T.add_diagonal(
        torch.as_tensor(v))
    assert Tkv.tiles.data_ptr() == T.tiles.data_ptr()     # shared buffer
    assert Tkv.rows is T.rows
    np.testing.assert_allclose(_np(Tkv.to_dense()), dense + np.diag(v),
                               atol=ATOL)
    X = np.random.default_rng(3).standard_normal((50, 4))
    np.testing.assert_allclose(_np(Tkv.matmat(torch.as_tensor(X))),
                               np.asarray(Jkv.matmat(jnp.asarray(X))),
                               atol=ATOL)
    tr, fro = Tkv.trace_and_fro()
    jtr, jfro = Jkv.trace_and_fro()
    np.testing.assert_allclose(tr, np.trace(dense + np.diag(v)), atol=1e-9)
    np.testing.assert_allclose(fro, np.linalg.norm(dense + np.diag(v)),
                               atol=1e-9)
    # the JAX package sums the squares in float32
    np.testing.assert_allclose([tr, fro], [float(jtr), float(jfro)],
                               rtol=1e-6)
    # a second diagonal adds onto the first
    np.testing.assert_allclose(
        _np(Tkv.add_diagonal(torch.as_tensor(v)).diagonal()),
        np.diag(dense) + 2 * v, atol=ATOL)


def test_rect_matmat_rmatmat_and_transpose_match_jax():
    J, T, dense = _rect_pair(24, 16, 8, seed=4)
    rng = np.random.default_rng(4)
    X = rng.standard_normal((16, 2))
    Y = rng.standard_normal((24, 2))
    np.testing.assert_allclose(_np(T.matmat(torch.as_tensor(X))),
                               np.asarray(J.matmat(jnp.asarray(X))),
                               atol=ATOL)
    np.testing.assert_allclose(_np(T.matmat(torch.as_tensor(X))), dense @ X,
                               atol=ATOL)
    np.testing.assert_allclose(_np(T.rmatmat(torch.as_tensor(Y))),
                               np.asarray(J.rmatmat(jnp.asarray(Y))),
                               atol=ATOL)
    np.testing.assert_allclose(_np(T.rmatmat(torch.as_tensor(Y))),
                               dense.T @ Y, atol=ATOL)
    np.testing.assert_allclose(_np(T.T.to_dense()), dense.T, atol=ATOL)
    np.testing.assert_allclose(_np(T.T.matmat(torch.as_tensor(Y))),
                               dense.T @ Y, atol=ATOL)


def test_rectangular_ragged_shapes_and_square_only_guard():
    J, T, dense = _rect_pair(21, 14, 8, seed=5)
    rng = np.random.default_rng(5)
    X = rng.standard_normal((14, 4))
    Y = rng.standard_normal(21)
    np.testing.assert_allclose(_np(T.matmat(torch.as_tensor(X))), dense @ X,
                               atol=ATOL)
    np.testing.assert_allclose(_np(T.rmatmat(torch.as_tensor(Y))),
                               dense.T @ Y, atol=ATOL)
    np.testing.assert_allclose(_np(T.rmatmat(torch.as_tensor(Y))),
                               np.asarray(J.rmatmat(jnp.asarray(Y))),
                               atol=ATOL)
    with pytest.raises(AssertionError):
        T.add_diagonal(1.0)


def test_stack_augmented_covariance_matches_jax():
    B = 8
    JA, TA, denseA = _pair(n=2 * B, B=B, seed=5, frac=1.0)
    rng = np.random.default_rng(6)
    Bt = rng.standard_normal((2, B, B))
    Dt = rng.standard_normal((1, B, B))
    Dt = Dt + np.swapaxes(Dt, 1, 2)
    full = {}
    for name, mod, kw in (("jax", jbs, {}), ("torch", tbs,
                                             {"device": "cpu"})):
        bB = mod.BlockSparseMatrix(2 * B, B, B, np.array([0, 1]),
                                   np.array([0, 0]), Bt, **kw)
        bD = mod.BlockSparseMatrix(B, B, B, np.array([0]), np.array([0]),
                                   Dt, **kw)
        full[name] = mod.stack_augmented_covariance(
            JA if name == "jax" else TA, bB, bD)
    dB = np.vstack([Bt[0], Bt[1]])
    expected = np.block([[denseA, dB], [dB.T, Dt[0]]])
    np.testing.assert_allclose(_np(full["torch"].to_dense()), expected,
                               atol=ATOL)
    np.testing.assert_allclose(_np(full["torch"].to_dense()),
                               np.asarray(full["jax"].to_dense()), atol=ATOL)
    # a misaligned K is refused: the caller recomputes
    _, Tmis, _ = _pair(n=2 * B - 3, B=B, seed=5)
    with pytest.raises(ValueError, match="misaligned"):
        tbs.stack_augmented_covariance(Tmis, bB, bD)


def test_stacked_sentinels_stay_sentinels():
    """The parts' bucket-padding sentinels must not become live row blocks
    of the stacked matrix (K's sentinel row index is a real block there)."""
    B = 4
    tiles = np.ones((2, B, B))
    K = tbs.BlockSparseMatrix(B, B, B, np.array([0, 1]), np.array([0, 1]),
                              tiles * np.array([1.0, 0.0])[:, None, None],
                              device="cpu")
    Bm = tbs.BlockSparseMatrix(B, B, B, np.array([0]), np.array([0]),
                               2 * tiles[:1], device="cpu")
    D = tbs.BlockSparseMatrix(B, B, B, np.array([0, 1]), np.array([0, 1]),
                              3 * tiles * np.array([1.0, 0.0])[:, None, None],
                              device="cpu")
    full = tbs.stack_augmented_covariance(K, Bm, D)
    assert full.nnz == 4 * B * B
    np.testing.assert_allclose(
        full.toarray(), np.block([[np.ones((B, B)), 2 * np.ones((B, B))],
                                  [2 * np.ones((B, B)), 3 * np.ones((B, B))]]))


def test_misc_branches_match_the_dense_oracle(monkeypatch):
    """dtype, the transposed view, column-chunked products under a tiny
    memory budget, dense_columns with an added diagonal, merge."""
    J, A, dense = _pair(n=40, B=8, seed=3)
    assert A.dtype == A.tiles.dtype == torch.float64
    X = np.random.default_rng(0).standard_normal((40, 7))
    Xt = torch.as_tensor(X)
    np.testing.assert_allclose(_np(A.T.matmat(Xt)), dense.T @ X, atol=1e-9)
    np.testing.assert_allclose(_np(A.rmatmat(Xt)), dense.T @ X, atol=1e-9)
    monkeypatch.setattr(tbs, "_MATMAT_BUDGET",
                        2 * A.tiles.shape[0] * A.block_size * 8 * 2)
    assert A._col_chunk(7, 8) == J._col_chunk(7, 8) or A._col_chunk(7, 8) < 7
    assert A._col_chunk(7, 8) < 7
    # off the card the square product is the plain one and keeps its bound
    assert A.square_col_chunk(7, torch.float64) == A._col_chunk(7, 8)
    np.testing.assert_allclose(_np(A.matmat(Xt)), dense @ X, atol=1e-9)
    np.testing.assert_allclose(_np(A.rmatmat(Xt)), dense.T @ X, atol=1e-9)
    monkeypatch.undo()
    assert A._col_chunk(7, 8) == J._col_chunk(7, 8) == 7
    Ad = A.add_diagonal(torch.full((40,), 2.5, dtype=torch.float64))
    Jd = J.add_diagonal(np.full(40, 2.5))
    want = dense[:, 3:11].copy()
    for i in range(3, 11):
        want[i, i - 3] += 2.5
    np.testing.assert_allclose(_np(Ad.dense_columns(3, 11)), want, atol=1e-9)
    np.testing.assert_allclose(_np(Ad.dense_columns(3, 11)),
                               np.asarray(Jd.dense_columns(3, 11)), atol=ATOL)
    M = tbs.merge(Ad, Ad)
    np.testing.assert_allclose(_np(M.to_dense()),
                               2 * dense + 5.0 * np.eye(40), atol=1e-9)
    np.testing.assert_allclose(_np(M.matmat(Xt)),
                               (2 * dense + 5.0 * np.eye(40)) @ X, atol=1e-9)
    _, small, _ = _pair(n=24, B=8, seed=4)
    with pytest.raises(ValueError):
        tbs.merge(A, small)


def test_rect_column_chunking_matches_unchunked(monkeypatch):
    J, A, dense = _rect_pair(200, 100, 32, seed=0)
    rng = np.random.default_rng(0)
    X = torch.as_tensor(rng.standard_normal((100, 17)))
    Y = torch.as_tensor(rng.standard_normal((200, 17)))
    full_mat, full_r = _np(A.matmat(X)), _np(A.rmatmat(Y))
    monkeypatch.setattr(tbs, "_MATMAT_BUDGET", A.tiles.shape[0] * 32 * 4 * 3)
    assert A._col_chunk(17) < 17
    np.testing.assert_allclose(_np(A.matmat(X)), full_mat, rtol=1e-12)
    np.testing.assert_allclose(_np(A.rmatmat(Y)), full_r, rtol=1e-12)
    monkeypatch.undo()
    np.testing.assert_allclose(full_mat, dense @ _np(X), rtol=1e-10)
    np.testing.assert_allclose(full_r, dense.T @ _np(Y), rtol=1e-10)
    np.testing.assert_allclose(full_mat,
                               np.asarray(J.matmat(jnp.asarray(_np(X)))),
                               atol=ATOL)


def test_nnz_and_fingerprint_ignore_sentinel_padding():
    rng = np.random.default_rng(0)
    B, nb = 8, 3
    t0, t1 = rng.standard_normal((2, B, B))
    rows = np.array([0, 1, nb, nb, nb], np.int32)
    cols = np.array([0, 1, nb, nb, nb], np.int32)
    tiles = np.stack([t0, t1] + [np.zeros((B, B))] * 3)
    A = tbs.BlockSparseMatrix(nb * B, nb * B, B, rows, cols, tiles,
                              device="cpu")
    J = jbs.BlockSparseMatrix(nb * B, nb * B, B, rows, cols, tiles)
    assert A.nnz == J.nnz == 2 * B * B
    dense = np.zeros((nb * B, nb * B))
    dense[:B, :B] = t0
    dense[B:2 * B, B:2 * B] = t1
    tr, fro = A.trace_and_fro()
    assert abs(tr - np.trace(dense)) < 1e-10
    assert abs(fro - np.linalg.norm(dense)) < 1e-10
    # duplicates from merge are corrected exactly, with no coalescing
    M = tbs.merge(A, A)
    tr2, fro2 = M.trace_and_fro()
    assert abs(tr2 - 2 * np.trace(dense)) < 1e-10
    assert abs(fro2 - np.linalg.norm(2 * dense)) < 1e-10
    assert M.nnz == 4 * B * B
    np.testing.assert_allclose(_np(M.diagonal()), 2 * np.diag(dense),
                               atol=ATOL)
    np.testing.assert_allclose(_np(M.diagonal_tiles())[0], 2 * t0, atol=ATOL)
    A2 = tbs.BlockSparseMatrix(nb * B, nb * B, B, rows, cols, tiles,
                               live_tiles=2, device="cpu")
    assert A2.nnz == 2 * B * B


def test_merge_dtype_rule_keeps_structured_noise_precision():
    B = 8
    K = tbs.BlockSparseMatrix(B, B, B, np.array([0]), np.array([0]),
                              torch.ones((1, B, B), dtype=torch.bfloat16))
    v = 1e-3 * (1 + np.arange(B * B).reshape(B, B) / (B * B))
    V = tbs.BlockSparseMatrix(B, B, B, np.array([0]), np.array([0]),
                              v[None], device="cpu")
    M = tbs.merge(K, V)
    assert M.tiles.dtype == torch.float32
    np.testing.assert_allclose(_np(M.to_dense()).astype(np.float64), 1.0 + v,
                               rtol=1e-6)
    assert tbs.merge(K, K).tiles.dtype == torch.bfloat16
    assert tbs.merge(V, V).tiles.dtype == torch.float64
    # sub-float32 storage densifies to float32
    assert K.to_dense().dtype == torch.float32


def test_from_scipy_matches_jax():
    from scipy import sparse
    rng = np.random.default_rng(7)
    S = sparse.random(37, 29, density=0.15, random_state=7, format="csr")
    J = jbs.from_scipy(S, 8)
    T = tbs.from_scipy(S, 8, device="cpu")
    np.testing.assert_allclose(T.toarray(), S.toarray(), atol=ATOL)
    np.testing.assert_allclose(T.toarray(), J.toarray(), atol=ATOL)
    X = rng.standard_normal((29, 3))
    np.testing.assert_allclose(_np(T.matmat(torch.as_tensor(X))), S @ X,
                               atol=ATOL)
    assert T.nnz == J.nnz


def test_block_diagonals_and_coarse_matrix_match_jax():
    J, T, dense = _pair(n=45, B=8, seed=9, frac=0.8)
    v = np.random.default_rng(9).uniform(0.5, 1.0, 45)
    Jd, Td = J.add_diagonal(jnp.asarray(v)), T.add_diagonal(
        torch.as_tensor(v))
    for a, b in ((T, J), (Td, Jd)):
        np.testing.assert_allclose(_np(a.diagonal_tiles()),
                                   np.asarray(b.diagonal_tiles()), atol=ATOL)
        np.testing.assert_allclose(_np(a.off_diagonal_tiles(1)),
                                   np.asarray(b.off_diagonal_tiles(1)),
                                   atol=ATOL)
        np.testing.assert_allclose(_np(a.coarse_matrix()),
                                   np.asarray(b.coarse_matrix()), atol=ATOL)


def test_pickle_round_trip_and_the_jax_state_dict():
    J, T, dense = _pair(seed=11)
    v = np.random.default_rng(11).uniform(0.5, 1.0, 50)
    Tkv = T.add_diagonal(torch.as_tensor(v))
    back = pickle.loads(pickle.dumps(Tkv))
    np.testing.assert_allclose(back.toarray(), dense + np.diag(v), atol=0)
    assert back.device.type == "cpu" and back.nnz == T.nnz
    state = Tkv.__getstate__()
    assert {"n", "n_cols", "block_size", "rows", "cols", "tiles",
            "diag"} <= set(state)
    assert all(isinstance(state[k], np.ndarray)
               for k in ("rows", "cols", "tiles", "diag"))
    # the JAX package's dict builds the port's matrix
    Jkv = J.add_diagonal(jnp.asarray(v))
    from_jax = tbs.from_numpy_state(Jkv.__getstate__(), device="cpu")
    np.testing.assert_allclose(from_jax.toarray(), dense + np.diag(v),
                               atol=ATOL)
    # bfloat16 storage survives the round trip
    Kb = tbs.BlockSparseMatrix(8, 8, 8, np.array([0]), np.array([0]),
                               torch.full((1, 8, 8), 0.3,
                                          dtype=torch.bfloat16))
    Kb2 = pickle.loads(pickle.dumps(Kb))
    assert Kb2.tiles.dtype == torch.bfloat16
    assert torch.equal(Kb2.tiles, Kb.tiles)


def test_an_unsorted_tile_list_is_row_sorted_once_for_the_kernel():
    """``merge`` concatenates; the kernel's operands are sorted by row on
    first use, shared by every view, and the product does not change."""
    _, A, dense = _pair(n=40, B=8, seed=3)
    M = tbs.merge(A, A)
    view = M.add_diagonal(torch.ones(40, dtype=torch.float64))
    assert not np.all(np.diff(M._store.rows_h) >= 0)
    rows, cols_c, tiles = view._store.kernel_operands()
    assert bool((rows[1:] >= rows[:-1]).all())
    assert M.rows is rows and M.tiles is tiles            # shared store
    assert view._store.kernel_operands()[0] is rows       # sorted once
    assert int(cols_c.max()) <= M.nb - 1
    X = np.random.default_rng(1).standard_normal((40, 3))
    np.testing.assert_allclose(_np(M.matmat(torch.as_tensor(X))),
                               2 * dense @ X, atol=1e-9)
    np.testing.assert_allclose(M.toarray(), 2 * dense, atol=1e-9)


def test_bsm_matvec_factory_applies_the_extra_diagonal():
    _, A, dense = _pair(seed=12)
    v = np.full(50, 0.7)
    Akv = A.add_diagonal(torch.as_tensor(v))
    X = torch.as_tensor(np.random.default_rng(12).standard_normal((50, 2)))
    mv = tbs.bsm_matvec_factory(Akv.nb, Akv.block_size, Akv.n, True)
    np.testing.assert_allclose(_np(mv(Akv, X)),
                               (dense + np.diag(v)) @ _np(X), atol=ATOL)
    mv0 = tbs.bsm_matvec_factory(A.nb, A.block_size, A.n, False)
    np.testing.assert_allclose(_np(mv0(A, X)), dense @ _np(X), atol=ATOL)


# ---------------------------------------------------------------------------
# distributed_covariance
# ---------------------------------------------------------------------------

def _sparse_dataset(n=500, span=40.0, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, span, (n, 2))
    return x, np.sin(x[:, 0]) + 0.05 * rng.standard_normal(n)


def _gp(cls, x, y, args, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if cls is GP:
            kw["compute_device"] = "cpu"
        return cls(x, y, init_hyperparameters=HPS, gp2Scale=True,
                   args=dict(args), **kw)


def _dense_wendland(x):
    xt = torch.as_tensor(np.asarray(x))
    return wendland_anisotropic(xt, xt, torch.as_tensor(HPS)).numpy()


@pytest.fixture(scope="module")
def stored():
    x, y = _sparse_dataset()
    args = {"gp2Scale_block_size": 64}
    return {"jax": _gp(JaxGP, x, y, args), "torch": _gp(GP, x, y, args),
            "x": x, "y": y}


def test_distributed_covariance_matches_dense_and_jax(stored):
    K = stored["torch"].K
    assert tbs.is_block_sparse(K) and K.tiles.dtype == torch.float64
    Kd = K.toarray()
    np.testing.assert_allclose(Kd, _dense_wendland(stored["torch"].x_data),
                               atol=1e-12)
    np.testing.assert_allclose(Kd, stored["jax"].K.toarray(), atol=ATOL)
    assert K.nnz == stored["jax"].K.nnz
    assert K.sparsity() < 1.0


def test_assembled_tile_list_is_row_sorted_with_zero_padding(stored):
    """The stored layout the K1 kernel needs: sorted by (row, column) block,
    the sentinels at the tail, their tiles exactly zero."""
    K = stored["torch"].K
    r, c = K._store.rows_h.astype(np.int64), K._store.cols_h
    key = r * (K.nb + 1) + c
    assert np.all(np.diff(key) >= 0)
    live = r < K.nb
    assert live.sum() * K.block_size ** 2 == K.nnz
    assert not live[live.sum():].any()
    assert float(K.tiles[int(live.sum()):].abs().max()) == 0.0


def test_zero_tile_filter_drops_tiles_and_keeps_the_matrix():
    x, y = _sparse_dataset(n=1200, span=90.0)
    on = _gp(GP, x, y, {"gp2Scale_block_size": 32}).K
    off = _gp(GP, x, y, {"gp2Scale_block_size": 32,
                         "gp2Scale_tile_filter": False}).K
    assert on.nnz < off.nnz
    np.testing.assert_allclose(on.toarray(), off.toarray(), atol=1e-12)


def test_rowwise_matches_blockwise(stored):
    gp2 = _gp(GP, stored["x"], stored["y"], {"gp2Scale_block_size": 64},
              gp2Scale_distribution="rowwise")
    np.testing.assert_allclose(gp2.K.toarray(), stored["torch"].K.toarray(),
                               atol=1e-12)


def test_storage_dtype_bfloat16(stored):
    gp = _gp(GP, stored["x"], stored["y"],
             {"gp2Scale_block_size": 64,
              "gp2Scale_storage_dtype": "bfloat16"})
    assert gp.K.tiles.dtype == torch.bfloat16
    # bfloat16 keeps 8 mantissa bits of covariances <= 1
    np.testing.assert_allclose(gp.K.toarray(), _dense_wendland(gp.x_data),
                               atol=1e-2)
    X = np.random.default_rng(0).standard_normal((500, 2))
    np.testing.assert_allclose(_np(gp.K.matmat(torch.as_tensor(X))),
                               gp.K.toarray() @ X, atol=ATOL)


def test_four_arg_kernel_closure_reads_the_current_args():
    x, y = _sparse_dataset(n=300, span=12.0, seed=4)

    def k4(a, b, h, args):
        return (args or {}).get("my_scale", 1.0) * wendland_anisotropic(a, b,
                                                                        h)

    gp = _gp(GP, x, y, {"gp2Scale_block_size": 32, "my_scale": 1.0,
                        "gp2Scale_lengthscales": lambda h: h[1:],
                        "gp2Scale_support_radius": 1.0}, kernel_function=k4)
    base = gp.K.toarray()
    np.testing.assert_allclose(base, _dense_wendland(gp.x_data), atol=1e-12)
    gp.set_args(dict(gp.args, my_scale=2.0))
    gp.set_hyperparameters(HPS)
    np.testing.assert_allclose(gp.K.toarray(), 2.0 * base, atol=1e-12)


def test_rectangular_cross_covariance_takes_the_device_filter(stored):
    gp = stored["torch"]
    xp = np.random.default_rng(8).uniform(0, 40, (70, 2))
    k = gp.prior._gp2Scale_covariance(gp.x_data, xp, HPS)
    kj = stored["jax"].prior._gp2Scale_covariance(
        np.asarray(stored["jax"].x_data), xp, HPS)
    xt = torch.as_tensor(np.asarray(gp.x_data))
    want = wendland_anisotropic(xt, torch.as_tensor(xp),
                                torch.as_tensor(HPS)).numpy()
    assert k.shape == (500, 70)
    np.testing.assert_allclose(k.toarray(), want, atol=1e-12)
    assert k.nnz == kj.nnz < 8 * 2 * 64 * 64


def test_host_kernel_takes_the_host_tile_loop(stored):
    def host_kernel(x1, x2, hps):
        d = np.linalg.norm(x1[:, None, :] / hps[1:] - x2[None, :, :]
                           / hps[1:], axis=-1)
        return hps[0] * np.maximum(1.0 - d, 0.0) ** 2

    args = {"gp2Scale_block_size": 64,
            "gp2Scale_lengthscales": lambda h: h[1:]}
    t = _gp(GP, stored["x"], stored["y"], args, kernel_function=host_kernel)
    j = _gp(JaxGP, stored["x"], stored["y"], args,
            kernel_function=host_kernel)
    assert not t.prior.kernel_traceable
    want = host_kernel(t.x_data, t.x_data, HPS)
    np.testing.assert_allclose(t.K.toarray(), want, atol=1e-12)
    np.testing.assert_allclose(t.K.toarray(), j.K.toarray(), atol=ATOL)
    assert t.K.nnz == j.K.nnz


def test_unserved_inputs_raise_with_their_roadmap_item(stored):
    gp = stored["torch"]
    x = np.asarray(gp.x_data)
    with pytest.raises(AssertionError, match="gp2Scale_distribution"):
        _gp(GP, stored["x"], stored["y"], {"gp2Scale_block_size": 64},
            gp2Scale_distribution="ringwise")
    with pytest.raises(NotImplementedError, match="ROADMAP item 1.8"):
        distributed_covariance(gp.prior, x, x, HPS, symmetric=True,
                               args=gp.args, mesh=object())
    with pytest.raises(NotImplementedError, match="ROADMAP item 1.6"):
        distributed_covariance(gp.prior, list(x), list(x), HPS,
                               symmetric=True, args=gp.args)


def test_jax_kernel_is_the_same_function():
    """The two packages' Wendland kernels agree, so their assembled K can."""
    x = np.random.default_rng(1).uniform(0, 5, (30, 2))
    np.testing.assert_allclose(_dense_wendland(x),
                               np.asarray(jax_wendland(x, x, HPS)),
                               atol=1e-14)
