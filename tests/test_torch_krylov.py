"""The stored-operator linear algebra of the port against the JAX package:
``ops/krylov`` (CG, MINRES), ``ops/slq`` (Lanczos, SLQ logdet) and
``ops/precond`` (block-Jacobi, Schwarz, two-level, the shift ladder).  The
same numpy operators and right-hand sides, made from a seed, go through
both (CPU, float64).

Tolerances: solutions 1e-8 with EQUAL iteration counts (the port keeps the
JAX package's exit rule), Lanczos coefficients and preconditioner applies
1e-10 (the same arithmetic in another summation order); the SLQ estimate is
held to 3 of its own reported standard errors around the exact logdet, in
both packages (their probes differ: each draws from its own generator)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fvgp_tpu.parallel.block_sparse as jbs
import fvgp_tpu_torch.parallel.block_sparse as tbs
from fvgp_tpu.ops import krylov as jkrylov
from fvgp_tpu.ops import precond as jprecond
from fvgp_tpu.ops import slq as jslq
from fvgp_tpu_torch.ops import krylov, precond, slq


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _spd(n, seed, cond=1e3):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (Q * np.geomspace(1.0, cond, n)) @ Q.T


def _banded_spd(n, seed):
    """A diagonally dominant banded SPD matrix (a compactly supported
    covariance in a good ordering plus noise)."""
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    A = np.exp(-0.5 * ((i[:, None] - i[None, :]) / 6.0) ** 2)
    A[np.abs(i[:, None] - i[None, :]) > 24] = 0.0
    return A + np.diag(rng.uniform(0.05, 0.2, n))


def _bsm_pair(A, B):
    """Both packages' BlockSparseMatrix of a dense matrix (all tiles)."""
    n = A.shape[0]
    nb = -(-n // B)
    Ap = np.zeros((nb * B, nb * B))
    Ap[:n, :n] = A
    rows, cols = np.divmod(np.arange(nb * nb), nb)
    tiles = Ap.reshape(nb, B, nb, B).transpose(0, 2, 1, 3).reshape(-1, B, B)
    keep = np.abs(tiles).max(axis=(1, 2)) > 0
    rows, cols, tiles = rows[keep], cols[keep], tiles[keep]
    return (jbs.BlockSparseMatrix(n, n, B, rows, cols, tiles),
            tbs.BlockSparseMatrix(n, n, B, rows, cols, tiles, device="cpu"))


# ---------------------------------------------------------------------------
# CG / MINRES
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["plain", "multi_rhs", "precond",
                                  "warm_start", "zero_column", "maxiter"])
def test_cg_matches_jax_with_equal_iteration_counts(case):
    n = 120
    A = _spd(n, seed=1, cond=30.0)     # ~50 iterations, far from stagnation
    rng = np.random.default_rng(2)
    b = rng.standard_normal((n, 3)) if case != "plain" \
        else rng.standard_normal(n)
    kw = {"tol": 1e-10}
    jkw, tkw = dict(kw), dict(kw)
    if case == "precond":
        Minv = np.diag(1.0 / np.diag(A))
        jkw.update(M=jkrylov.dense_matvec, m_operator=jnp.asarray(Minv))
        tkw.update(M=krylov.dense_matvec, m_operator=torch.as_tensor(Minv))
    if case == "warm_start":
        x0 = np.linalg.solve(A, b) + 1e-3 * rng.standard_normal(b.shape)
        jkw["x0"], tkw["x0"] = jnp.asarray(x0[:, :2]), torch.as_tensor(
            x0[:, :2])                  # a narrower start is zero-padded
    if case == "zero_column":
        b[:, 1] = 0.0
        x0 = rng.standard_normal(b.shape)
        jkw["x0"], tkw["x0"] = jnp.asarray(x0), torch.as_tensor(x0)
    if case == "maxiter":
        jkw["maxiter"] = tkw["maxiter"] = 7
    xj, ij = jkrylov.cg(jkrylov.dense_matvec, jnp.asarray(b),
                        operator=jnp.asarray(A), with_info=True, **jkw)
    xt, it = krylov.cg(krylov.dense_matvec, torch.as_tensor(b),
                       operator=torch.as_tensor(A), with_info=True, **tkw)
    assert it["iterations"] == ij["iterations"]
    assert xt.shape == b.shape
    np.testing.assert_allclose(_np(xt), np.asarray(xj), atol=1e-8)
    if case == "maxiter":
        assert it["iterations"] == 7
    else:
        np.testing.assert_allclose(_np(xt), np.linalg.solve(A, b), atol=1e-6)
    if case == "zero_column":
        assert np.all(_np(xt)[:, 1] == 0.0)
    # the closure convention gives the same solve
    At = torch.as_tensor(A)
    tkw.pop("M", None)
    tkw.pop("m_operator", None)
    if case != "precond":
        x2 = krylov.cg(lambda X: At @ X, torch.as_tensor(b), **tkw)
        np.testing.assert_allclose(_np(x2), _np(xt), atol=0)


@pytest.mark.parametrize("case", ["spd", "indefinite", "precond",
                                  "warm_start"])
def test_minres_matches_jax(case):
    n = 100
    rng = np.random.default_rng(3)
    A = _spd(n, seed=4, cond=200.0)
    if case == "indefinite":
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        A = (Q * np.concatenate([-np.geomspace(1, 20, 10),
                                 np.geomspace(1, 50, n - 10)])) @ Q.T
    b = rng.standard_normal((n, 2))
    jkw, tkw = {"tol": 1e-10}, {"tol": 1e-10}
    if case == "precond":
        Minv = np.diag(1.0 / np.diag(A))
        jkw.update(M=jkrylov.dense_matvec, m_operator=jnp.asarray(Minv))
        tkw.update(M=krylov.dense_matvec, m_operator=torch.as_tensor(Minv))
    if case == "warm_start":
        x0 = np.linalg.solve(A, b) + 1e-3 * rng.standard_normal(b.shape)
        jkw["x0"], tkw["x0"] = jnp.asarray(x0), torch.as_tensor(x0)
    xj = jkrylov.minres(jkrylov.dense_matvec, jnp.asarray(b),
                        operator=jnp.asarray(A), **jkw)
    xt = krylov.minres(krylov.dense_matvec, torch.as_tensor(b),
                       operator=torch.as_tensor(A), **tkw)
    np.testing.assert_allclose(_np(xt), np.asarray(xj), atol=1e-8)
    np.testing.assert_allclose(_np(xt), np.linalg.solve(A, b), atol=1e-6)
    x1 = krylov.minres(krylov.dense_matvec, torch.as_tensor(b[:, 0]),
                       operator=torch.as_tensor(A), **tkw)
    assert x1.shape == (n,)
    np.testing.assert_allclose(_np(x1), _np(xt)[:, 0], atol=1e-8)


def test_minres_poisons_a_column_under_an_indefinite_preconditioner():
    n = 30
    A = torch.as_tensor(_spd(n, seed=5, cond=10.0))
    b = torch.as_tensor(np.random.default_rng(5).standard_normal((n, 2)))
    x = krylov.minres(lambda X: A @ X, b, M=lambda X: -X, tol=1e-8)
    xj = jkrylov.minres(lambda X: jnp.asarray(_np(A)) @ X,
                        jnp.asarray(_np(b)), M=lambda X: -X, tol=1e-8)
    assert bool(torch.isnan(x).all()) and bool(np.isnan(np.asarray(xj)).all())


# ---------------------------------------------------------------------------
# Lanczos / SLQ
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("degree", [5, 20])
def test_lanczos_tridiag_matches_jax_at_an_injected_start(degree):
    n = 80
    A = _spd(n, seed=6, cond=100.0)
    v0 = np.random.default_rng(6).standard_normal(n)
    aj, bj = jslq.lanczos_tridiag(jkrylov.dense_matvec, jnp.asarray(v0),
                                  degree, operator=jnp.asarray(A))
    at, bt = slq.lanczos_tridiag(krylov.dense_matvec, torch.as_tensor(v0),
                                 degree, operator=torch.as_tensor(A))
    assert at.shape == (degree,) and bt.shape == (degree - 1,)
    np.testing.assert_allclose(_np(at), np.asarray(aj), atol=1e-10)
    np.testing.assert_allclose(_np(bt), np.asarray(bj), atol=1e-10)
    # the closure convention
    At = torch.as_tensor(A)
    a2, b2 = slq.lanczos_tridiag(lambda X: At @ X, torch.as_tensor(v0),
                                 degree)
    np.testing.assert_allclose(_np(a2), _np(at), atol=0)


def test_slq_logdet_within_three_standard_errors_in_both_packages():
    n = 300
    A = _banded_spd(n, seed=7)
    exact = np.linalg.slogdet(A)[1]
    kw = dict(degree=30, min_num_samples=64, max_num_samples=256,
              error_rtol=0.002)
    ij, it = {}, {}
    vj = jslq.slq_logdet(jkrylov.dense_matvec, n, operator=jnp.asarray(A),
                         info_out=ij, **kw)
    vt = slq.slq_logdet(krylov.dense_matvec, n, operator=torch.as_tensor(A),
                        info_out=it, **kw)
    for val, info in ((vj, ij), (vt, it)):
        assert info["num_samples"] >= 64 and info["degree"] == 30
        assert info["logdet"] == val
        assert abs(val - exact) <= 3.0 * np.sqrt(info["variance"]) \
            + 1e-3 * abs(exact)
    # the same batch rule, so the same number of probes per round
    assert it["num_samples"] % 64 == 0 and ij["num_samples"] % 64 == 0
    # a second run from the default generator repeats the first
    assert slq.slq_logdet(krylov.dense_matvec, n,
                          operator=torch.as_tensor(A), **kw) == vt


def test_slq_batch_rule_and_breakdown_guard():
    """The default batch is bounded by the reorthogonalization basis's
    memory, and an operator with an exact-zero eigenvalue direction gives a
    finite value (eigenvalues are clamped at the dtype's tiny)."""
    info = {}
    A = torch.diag(torch.tensor([1.0, 2.0, 0.0, 4.0], dtype=torch.float64))
    val = slq.slq_logdet(lambda X: A @ X, 4, degree=4, min_num_samples=4,
                         max_num_samples=4, batch=4, info_out=info,
                         device="cpu")
    assert np.isfinite(val) and info["num_samples"] == 4
    calls = []

    def mv(X):
        calls.append(X.shape[1])
        return X

    slq.slq_logdet(mv, 50, degree=3, min_num_samples=10, max_num_samples=10,
                   device="cpu")
    assert set(calls) == {32}                 # max(min_num_samples, 32)
    calls.clear()
    slq.slq_logdet(mv, 50, degree=3, min_num_samples=300,
                   max_num_samples=300, device="cpu")
    assert set(calls) == {256}


# ---------------------------------------------------------------------------
# preconditioners
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ptype", ["block_jacobi", "schwarz", "amg"])
@pytest.mark.parametrize("kind", ["dense", "block_sparse"])
def test_preconditioner_apply_matches_jax(ptype, kind):
    n, B = 150, 32                                  # ragged: 150 = 4*32 + 22
    A = _banded_spd(n, seed=8)
    args = {"sparse_preconditioner_type": ptype,
            "sparse_preconditioner_block_size": B}
    if kind == "dense":
        KVj, KVt = jnp.asarray(A), torch.as_tensor(A)
    else:
        Kj, Kt = _bsm_pair(A - np.diag(np.diag(A)) * 0.5, B)
        d = np.diag(A) * 0.5
        KVj, KVt = Kj.add_diagonal(jnp.asarray(d)), Kt.add_diagonal(
            torch.as_tensor(d))
    X = np.random.default_rng(9).standard_normal((n, 5))
    fj, dj = jprecond.build_preconditioner_op(KVj, args)
    ft, dt = precond.build_preconditioner_op(KVt, args)
    got = _np(ft(dt, torch.as_tensor(X)))
    np.testing.assert_allclose(got, np.asarray(fj(dj, jnp.asarray(X))),
                               atol=1e-10)
    # symmetric positive definite as an operator, and it helps CG
    M = _np(ft(dt, torch.eye(n, dtype=torch.float64)))
    np.testing.assert_allclose(M, M.T, atol=1e-10)
    assert np.linalg.eigvalsh(0.5 * (M + M.T)).min() > 0
    At = torch.as_tensor(A)
    b = torch.as_tensor(X[:, :1])
    _, plain = krylov.cg(krylov.dense_matvec, b, operator=At, tol=1e-8,
                         with_info=True)
    _, pre = krylov.cg(krylov.dense_matvec, b, operator=At, M=ft,
                       m_operator=dt, tol=1e-8, with_info=True)
    assert pre["iterations"] < plain["iterations"]


def test_block_jacobi_closure_convention():
    A = _banded_spd(70, seed=10)
    args = {"sparse_preconditioner_block_size": 16}
    apply_t = precond.build_block_jacobi(torch.as_tensor(A), args)
    apply_j = jprecond.build_block_jacobi(jnp.asarray(A), args)
    x = np.random.default_rng(10).standard_normal(70)
    np.testing.assert_allclose(_np(apply_t(torch.as_tensor(x))),
                               np.asarray(apply_j(jnp.asarray(x))),
                               atol=1e-10)
    assert apply_t(torch.as_tensor(x)).shape == (70,)


def test_shift_ladder_repairs_and_gives_up_like_jax():
    rng = np.random.default_rng(11)
    good = _spd(6, seed=11, cond=10.0)
    # barely not positive definite: the least eigenvalue just below zero
    bad = good - 1.0001 * np.linalg.eigvalsh(good)[0] * np.eye(6)
    blocks = np.stack([good, bad])
    args = {"sparse_preconditioner_shift": 0.0,
            "sparse_preconditioner_shift_growth": 10.0,
            "sparse_preconditioner_shift_attempts": 12}
    Lt = precond._shifted_cholesky(torch.as_tensor(blocks), args)
    Lj = jprecond._shifted_cholesky(jnp.asarray(blocks), args)
    np.testing.assert_allclose(_np(Lt), np.asarray(Lj), atol=1e-10)
    assert bool(torch.isfinite(Lt).all())
    # positive definite blocks are factored unshifted
    L0 = precond._shifted_cholesky(torch.as_tensor(blocks[:1]), args)
    np.testing.assert_allclose(_np(L0 @ L0.transpose(1, 2)), blocks[:1],
                               atol=1e-12)
    hopeless = -np.eye(4)[None] * (1.0 + rng.uniform())
    for mod, arr in ((precond, torch.as_tensor(hopeless)),
                     (jprecond, jnp.asarray(hopeless))):
        with pytest.raises(RuntimeError, match="shift retries"):
            mod._shifted_cholesky(arr, {
                "sparse_preconditioner_shift_attempts": 3})


def test_preconditioner_names_normalize_and_unknown_names_raise():
    for name in ("ichol", "ILU", "native_ic", "additive_schwarz",
                 "legacy_incomplete_cholesky"):
        assert precond.normalize_type(name) == jprecond.normalize_type(
            name) == "schwarz"
    for name in ("amg", "pyamg", "AMG"):
        assert precond.normalize_type(name) == jprecond.normalize_type(
            name) == "amg"
    for name in ("block_jacobi", "jacobi", "bj", "diag"):
        assert precond.normalize_type(name) == "block_jacobi"
    A = torch.as_tensor(_banded_spd(20, seed=12))
    for name in ("schwartz", "cholesky"):
        with pytest.raises(Exception, match="Unknown sparse preconditioner"):
            precond.normalize_type(name)
        with pytest.raises(Exception, match="Unknown sparse preconditioner"):
            precond.build_preconditioner_op(
                A, {"sparse_preconditioner_type": name})
