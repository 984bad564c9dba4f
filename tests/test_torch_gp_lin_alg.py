"""The port's reference-name linear-algebra layer
(``fvgp_tpu_torch.gp_lin_alg``) against the JAX package's
(``fvgp_tpu.gp_lin_alg``): the twelve cases of ``test_gp_lin_alg_compat.py``
as parity cases on the CPU in float64, with that file's numpy/scipy oracles
kept beside the comparison.

The port honours ``compute_device`` (default: the card); these cases pass
``"cpu"``, and hand the functions without a ``compute_device`` CPU tensors
or CPU ``BlockSparseMatrix`` operands, which run where they live."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import sparse

import fvgp_tpu.gp_lin_alg as jgla
import fvgp_tpu_torch.gp_lin_alg as tgla
import fvgp_tpu_torch.ops.slq as tslq
from fvgp_tpu_torch.parallel.block_sparse import from_scipy

CPU = "cpu"
# float64 on both sides; iterative solves run to 1e-12 and agree to their
# own residual times the conditioning (these matrices: cond < 10)
TOL = 1e-8


@pytest.fixture(autouse=True)
def _two_threads():
    """Small problems of many short torch ops: with the suite's workers
    sharing the cores, a full-width intra-op pool mostly waits on itself."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _spd(n, seed=0, jitter=1e-3):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    return A @ A.T / n + jitter * np.eye(n)


def _sparse_spd(n, seed=1):
    rng = np.random.default_rng(seed)
    d = np.abs(rng.standard_normal(n)) + 1.0
    off = sparse.random(n, n, density=0.01, random_state=int(seed),
                        data_rvs=lambda k: 0.05 * rng.standard_normal(k))
    S = off + off.T + sparse.diags(d)
    return S.tocsr()


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=tol * max(1.0, float(np.abs(ref).max())))


def _cpu_bsm(S, block):
    """The scipy matrix on the tile grid the JAX layer builds for it."""
    return from_scipy(S, block, device=CPU)


def case_cholesky_family():
    A = _spd(40)
    L = tgla.calculate_Chol_factor(A, CPU)
    _close(L, jgla.calculate_Chol_factor(A))
    np.testing.assert_allclose(L @ L.T, A, atol=1e-10)
    b = np.arange(40, dtype=float)
    x = tgla.calculate_Chol_solve(L, b, CPU)
    assert x.shape == (40, 1)                       # 1-d rhs comes back 2-d
    _close(x, jgla.calculate_Chol_solve(L, b))
    ld = tgla.calculate_Chol_logdet(L, CPU)
    assert ld == pytest.approx(jgla.calculate_Chol_logdet(L), rel=TOL)
    assert ld == pytest.approx(np.linalg.slogdet(A)[1], rel=1e-10)
    _close(tgla.calculate_inv_from_chol(L, CPU),
           jgla.calculate_inv_from_chol(L))


def case_factor_update_family():
    big = _spd(30, seed=3)
    A, Bb, C = big[:22, :22], big[:22, 22:], big[22:, 22:]
    L = tgla.calculate_Chol_factor(A, CPU)
    L2 = tgla.update_Chol_factor(L, big, CPU)
    _close(L2, jgla.update_Chol_factor(L, big))
    np.testing.assert_allclose(L2 @ L2.T, big, atol=1e-9)
    L3 = tgla.cholesky_update_rank_n(L, Bb, C, CPU)
    _close(L3, jgla.cholesky_update_rank_n(L, Bb, C))
    ld = tgla.update_logdet(tgla.calculate_logdet(A, CPU), np.linalg.inv(A),
                            big, CPU)
    assert ld == pytest.approx(jgla.update_logdet(
        jgla.calculate_logdet(A), np.linalg.inv(A), big), rel=TOL)
    _close(tgla.update_inv(np.linalg.inv(A), big, CPU),
           jgla.update_inv(np.linalg.inv(A), big))


def case_dense_general_family():
    A = _spd(25, seed=4)
    assert tgla.calculate_logdet(A, CPU) == pytest.approx(
        jgla.calculate_logdet(A), rel=TOL)
    _close(tgla.calculate_inv(A, CPU), jgla.calculate_inv(A))
    b = np.ones(25)
    _close(tgla.solve(A, b, CPU), jgla.solve(A, b))
    B = np.arange(50, dtype=float).reshape(25, 2)
    _close(tgla.matmul(A, B), jgla.matmul(A, B))
    _close(tgla.matmul3(A, A, B), jgla.matmul3(A, A, B))
    assert not tgla.is_sparse(A) and not tgla.is_sparse(torch.as_tensor(A))
    S = sparse.diags(np.ones(200)).tocsr()          # 0.5% nonzero
    assert tgla.is_sparse(S.toarray()) and jgla.is_sparse(S.toarray())
    assert tgla.how_sparse_is(S) == jgla.how_sparse_is(S)
    assert tgla.how_sparse_is(_cpu_bsm(S, 50)) == pytest.approx(0.25)


def case_sparse_krylov_solvers():
    S = _sparse_spd(150)
    b = np.sin(np.arange(150, dtype=float))
    x_ref = np.linalg.solve(S.toarray(), b)
    args = {"sparse_cg_tol": 1e-12, "sparse_minres_tol": 1e-12}
    # the JAX layer tiles a 150 x 150 scipy matrix as one 150-block
    K = _cpu_bsm(S, 150)
    for name in ("calculate_sparse_conj_grad", "calculate_sparse_minres"):
        x = getattr(tgla, name)(K, b, args=args)
        assert x.shape == (150, 1)
        _close(x, getattr(jgla, name)(S, b, args=args))
        np.testing.assert_allclose(x[:, 0], x_ref, atol=1e-6)
    rhs = np.stack([b, 2 * b], axis=1)
    x2 = tgla.calculate_sparse_conj_grad(K, rhs, x0=np.zeros_like(rhs),
                                         args={"sparse_cg_tol": 1e-12})
    _close(x2, jgla.calculate_sparse_conj_grad(
        S, rhs, x0=np.zeros_like(rhs), args={"sparse_cg_tol": 1e-12}))
    # a dense CPU tensor is an operator too
    xd = tgla.calculate_sparse_conj_grad(torch.as_tensor(S.toarray()), b,
                                         args=args)
    np.testing.assert_allclose(xd[:, 0], x_ref, atol=1e-8)


def case_sparse_preconditioner_types():
    S = _sparse_spd(160, seed=7)
    b = np.cos(np.arange(160, dtype=float))
    x_ref = np.linalg.solve(S.toarray(), b)
    K = _cpu_bsm(S, 32)
    for ptype in ("block_jacobi", "ichol0", "ilu", "amg"):
        pargs = {"sparse_preconditioner_type": ptype,
                 "gp2Scale_block_size": 32}
        cargs = {"sparse_cg_tol": 1e-12, "gp2Scale_block_size": 32}
        _, M = tgla.calculate_sparse_preconditioner(K, pargs)
        x = tgla.calculate_sparse_conj_grad(K, b, M=M, args=cargs)
        _, jM = jgla.calculate_sparse_preconditioner(S, pargs)
        _close(x, jgla.calculate_sparse_conj_grad(S, b, M=jM, args=cargs))
        np.testing.assert_allclose(x[:, 0], x_ref, atol=1e-6)
    for name in ("ichol0", "jacobi", "AMG"):
        assert tgla.normalize_sparse_preconditioner_type(name) \
            == jgla.normalize_sparse_preconditioner_type(name)
    with pytest.raises(Exception, match="Unknown sparse preconditioner"):
        tgla.normalize_sparse_preconditioner_type("nonsense")


def case_sparse_direct_semantics():
    S = _sparse_spd(120, seed=9)
    b = np.arange(120, dtype=float)
    exact = np.linalg.solve(S.toarray(), b)
    for K in (_cpu_bsm(S, 40), torch.as_tensor(S.toarray())):
        x = tgla.calculate_sparse_solve(K, b)
        _close(x, jgla.calculate_sparse_solve(S, b))
        np.testing.assert_allclose(x[:, 0], exact, atol=1e-7)
        LU = tgla.calculate_sparse_LU_factor(K)
        _close(LU, jgla.calculate_sparse_LU_factor(S))
        LU_t = torch.as_tensor(LU)                  # the factor on the CPU
        _close(tgla.calculate_LU_solve(LU_t, b),
               jgla.calculate_LU_solve(LU, b))
        assert tgla.calculate_LU_logdet(LU_t) == pytest.approx(
            np.linalg.slogdet(S.toarray())[1], rel=1e-9)
    # above the dense cutoff: tight preconditioned CG
    tight = {"sparse_direct_dense_cutoff": 100, "gp2Scale_block_size": 40}
    _close(tgla.calculate_sparse_solve(_cpu_bsm(S, 40), b, args=tight),
           jgla.calculate_sparse_solve(S, b, args=tight))


def case_random_logdet_contract(monkeypatch):
    """Both packages on the same injected probes: the JAX layer bakes its
    (traced) probe draw into its compiled round, so every round sees the
    same probes; the port's draw is patched to give those same probes."""
    n, num = 220, 40
    S = _sparse_spd(n, seed=11)
    Z = np.random.default_rng(12).choice([-1.0, 1.0], size=(n, num))
    monkeypatch.setattr(jax.random, "rademacher",
                        lambda key, shape, dtype=jnp.float64:
                        jnp.asarray(Z.T, dtype))
    monkeypatch.setattr(tslq, "rademacher_probes",
                        lambda n_, p, dtype, device, generator:
                        torch.as_tensor(Z, dtype=dtype).to(device))
    args = {"random_logdet_lanczos_degree": 30,
            "random_logdet_min_num_samples": 40,
            "random_logdet_max_num_samples": 400,
            "random_logdet_error_rtol": 1e-3}
    info, jinfo = {}, {}
    ld = tgla.calculate_random_logdet(_cpu_bsm(S, n), CPU, args=args,
                                      info_out=info)
    jld = jgla.calculate_random_logdet(S, args=args, info_out=jinfo)
    assert ld == pytest.approx(jld, rel=TOL)
    assert info["num_samples_used"] == jinfo["num_samples_used"] >= 40
    assert info["variance"] == pytest.approx(jinfo["variance"], rel=1e-6)
    exact = np.linalg.slogdet(S.toarray())[1]
    assert abs(ld - exact) / abs(exact) < 0.05
    assert info["absolute_error"] == pytest.approx(np.sqrt(info["variance"]))


def case_rank_1_update_and_engine_aliases():
    A = _spd(30, seed=13)
    rng = np.random.default_rng(13)
    b = rng.standard_normal(30) * 0.05
    c = 2.0
    L = tgla.calculate_Chol_factor(A, CPU)
    big = np.block([[A, b[:, None]], [b[None, :], np.array([[c]])]])
    ref = jgla.cholesky_update_rank_1(L, b, c)
    for fn in (tgla.cholesky_update_rank_1, tgla.cholesky_update_rank_1_numpy,
               tgla.cholesky_update_rank_1_torch,
               tgla.cholesky_update_rank_1_cupy):
        L1 = fn(L, b, c, CPU)
        _close(L1, ref)
        np.testing.assert_allclose(np.tril(L1) @ np.tril(L1).T, big,
                                   atol=1e-8)


def case_gpu_engine_stubs():
    assert tgla.get_gpu_engine({"GPU_engine": "torch"}) is None
    assert jgla.get_gpu_engine({"GPU_engine": "torch"}) is None
    msg = tgla.gpu_engine_unavailable_reason("torch")
    assert "torch" in msg and "compute_device" in msg
    # compute_device is honoured, and the default is the card
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tgla.calculate_Chol_factor(_spd(8))
        with pytest.raises(RuntimeError, match="CUDA"):
            tgla.calculate_sparse_conj_grad(_sparse_spd(64), np.ones(64))


def case_spai():
    S = _sparse_spd(150, seed=17)
    eye = sparse.identity(150, format="csr")
    M1 = tgla.spai(S, 1)
    M8 = tgla.spai(S, 8)
    np.testing.assert_allclose(M8.toarray(), jgla.spai(S, 8).toarray(),
                               rtol=0, atol=1e-12)
    r1 = sparse.linalg.norm(eye - S @ M1)
    r8 = sparse.linalg.norm(eye - S @ M8)
    assert r8 < r1 < sparse.linalg.norm(eye)
    assert sparse.issparse(M8)


def case_failure_guidance_and_mode_resolution():
    for args in ({"sparse_preconditioner_type": "ichol"},
                 {"sparse_preconditioner_type": "amg"}, {}, "junk"):
        assert tgla.sparse_preconditioner_failure_guidance(args) \
            == jgla.sparse_preconditioner_failure_guidance(args)
    mode, args = tgla.resolve_gp2scale_linalg_mode("sparseCGpre_amg", {})
    assert (mode, args) == jgla.resolve_gp2scale_linalg_mode(
        "sparseCGpre_amg", {})
    assert mode == "sparseCGpre"
    assert args["sparse_preconditioner_type"] == "amg"
    assert issubclass(tgla.NonPositiveDefiniteError, np.linalg.LinAlgError)
    with pytest.raises(tgla.NonPositiveDefiniteError):
        tgla.calculate_Chol_factor(-np.eye(3), CPU)


def case_mode_resolution_reference_contract():
    for mode, args in (("sparsecgpre_AMG", {}),
                       ("sparseCGpre_ichol", {"sparse_preconditioner_type":
                                              "ic"}),
                       ("sparseMINRESpre_jacobi", {}), ("Chol", {})):
        assert tgla.resolve_gp2scale_linalg_mode(mode, args) \
            == jgla.resolve_gp2scale_linalg_mode(mode, args)
    with pytest.raises(ValueError, match="Conflicting"):
        tgla.resolve_gp2scale_linalg_mode(
            "sparseCGpre_amg", {"sparse_preconditioner_type": "schwarz"})
    assert isinstance(tgla.sparse_preconditioner_failure_guidance("junk"),
                      str)


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


def test_same_names_as_the_jax_layer():
    assert tgla.__all__ == jgla.__all__
    assert all(callable(getattr(tgla, name)) for name in tgla.__all__)


@pytest.mark.parametrize("name", sorted(CASES))
def test_gp_lin_alg_case_matches_jax(name, monkeypatch):
    fn = CASES[name]
    fn(monkeypatch) if fn.__code__.co_argcount else fn()
