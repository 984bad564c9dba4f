"""The port's SLQ training solver and two-level committed solver
(fvgp_tpu_torch/ops/sparse_lml.py) held against the JAX package on the CPU
in float64, with the same probes ``Z`` (drawn with numpy and given to
both)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvgp_tpu.kernels import wendland_anisotropic
from fvgp_tpu.ops import sparse_lml as SL
from fvgp_tpu.parallel.ordering import morton_order
from fvgp_tpu.parallel.sharded_cov import _candidate_pairs
from fvgp_tpu_torch.kernels import wendland_anisotropic as t_wendland
from fvgp_tpu_torch.ops import hopper_kernels as HK
from fvgp_tpu_torch.ops import sparse_lml as TSL

# float64 on both sides: the same CG exits, the same recursion; only the
# order of float64 sums differs (segment sum against index_add, einsum
# against bmm), which CG and Lanczos carry at a few 1e-12 over these sizes
RTOL = 1e-8


@pytest.fixture(autouse=True)
def _two_threads():
    """Small problems of many short torch ops: with the suite's workers
    sharing the cores, a full-width intra-op pool mostly waits on itself."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _setup(N=320, B=32, seed=1, probes=8, pad=9):
    """A mirrored tile schedule (every tile and its mirror) with ``pad``
    sentinel (index == nb) entries of bucket padding, numpy probes."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 12, (N, 2))
    x = x[morton_order(x)]
    y = np.sin(x[:, 0])
    hps = np.array([1.0, 2.0, 2.0])
    rows, cols = _candidate_pairs(x, None, hps[1:], 1.0, B, symmetric=True)
    off = rows < cols
    nb = -(-N // B)
    rows_f = np.concatenate([rows, cols[off], np.full(pad, nb)])
    cols_f = np.concatenate([cols, rows[off], np.full(pad, nb)])
    Z = rng.choice([-1.0, 1.0], size=(nb * B, probes))
    Z[N:] = 0.0
    return (x, y, hps, nb, B, rows_f.astype(np.int32),
            cols_f.astype(np.int32), Z)


def _padded(x, y, B):
    noise = np.full(len(x), 1e-2)
    return (SL.make_padded_inputs(x, y, noise, B, dtype=jnp.float64),
            TSL.make_padded_inputs(x, y, noise, B, dtype=torch.float64,
                                   device="cpu"))


@pytest.fixture(scope="module")
def case():
    x, y, hps, nb, B, rows, cols, Z = _setup()
    jx, tx = _padded(x, y, B)
    return x, hps, nb, B, rows, cols, Z, jx, tx


@pytest.mark.parametrize("precondition,width", [(True, 1), (False, 1),
                                                (True, 2)])
def test_slq_lml_value_and_gradient_match_jax(case, precondition, width):
    _, hps, nb, B, rows, cols, Z, jx, tx = case
    kw = dict(cg_iters=200, slq_degree=25, solver="slq", with_variance=True,
              precondition=precondition, precond_width=width)
    lml = SL.make_sparse_lml(wendland_anisotropic, nb, B, **kw)
    (jv, jvar), jg = jax.jit(jax.value_and_grad(lml, has_aux=True))(
        jnp.asarray(hps), jnp.asarray(rows), jnp.asarray(cols), *jx,
        jnp.asarray(Z))
    tlml = TSL.make_sparse_lml(t_wendland, nb, B, **kw)
    h = torch.tensor(hps, requires_grad=True)
    tv, tvar = tlml(h, torch.as_tensor(rows), torch.as_tensor(cols), *tx,
                    torch.as_tensor(Z))
    tg, = torch.autograd.grad(tv, h)
    tv = float(tv.detach())
    np.testing.assert_allclose(tv, float(jv), rtol=RTOL)
    np.testing.assert_allclose(float(tvar), float(jvar), rtol=RTOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=RTOL)
    # the SLQ solver is another estimator than mBCG at the same probes
    mb = TSL.make_sparse_lml(t_wendland, nb, B, cg_iters=200,
                             precond_width=width)
    assert abs(float(mb(h.detach(), torch.as_tensor(rows),
                        torch.as_tensor(cols), *tx, torch.as_tensor(Z)))
               - tv) > 1e-6 * abs(tv)


def test_prior_mean_mode_and_unknown_solver(case):
    _, hps, nb, B, rows, cols, Z, jx, tx = case
    kw = dict(cg_iters=200, slq_degree=25, solver="slq",
              mean_mode="prior")
    lml = SL.make_sparse_lml(wendland_anisotropic, nb, B,
                             prior_mean_fn=lambda h: 0.1 * h[0], **kw)
    jv, jg = jax.jit(jax.value_and_grad(lml))(
        jnp.asarray(hps), jnp.asarray(rows), jnp.asarray(cols), *jx,
        jnp.asarray(Z))
    tlml = TSL.make_sparse_lml(t_wendland, nb, B,
                               prior_mean_fn=lambda h: 0.1 * h[0], **kw)
    h = torch.tensor(hps, requires_grad=True)
    tv = tlml(h, torch.as_tensor(rows), torch.as_tensor(cols), *tx,
              torch.as_tensor(Z))
    tg, = torch.autograd.grad(tv, h)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=RTOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=RTOL)
    with pytest.raises(ValueError, match="unknown sparse-LML solver"):
        TSL.make_sparse_lml(t_wendland, nb, B, solver="lanczos")


@pytest.mark.parametrize("precond", [True, False])
def test_implicit_cg_gradient_matches_jax_custom_vjp(case, precond):
    """The implicit-function backward against the JAX custom VJP: tile,
    noise and right-hand-side cotangents for one cotangent of the
    solution.  Sentinel tiles are left out: JAX scatters their cotangent
    into the clamped last row block, the port drops it; both are zeroed by
    the assembly's live mask before they reach a hyperparameter."""
    x, hps, nb, B, rows, cols, _, jx, tx = case
    rng = np.random.default_rng(8)
    rows_c = np.minimum(rows, nb - 1)
    cols_c = np.minimum(cols, nb - 1)
    live = rows < nb
    tiles = np.asarray(SL._assemble_chunked_tiles(
        wendland_anisotropic, B, None, jnp.asarray(hps), jnp.asarray(rows_c),
        jnp.asarray(cols_c), jnp.asarray(live), jx[0], jx[1]))
    noise = np.asarray(jx[4])
    Bv = rng.standard_normal((nb * B, 2))
    Bv[len(x):] = 0.0
    cot = rng.standard_normal((nb * B, 2))
    cot[len(x):] = 0.0
    Minv = np.asarray(SL._diag_precond_blocks(
        wendland_anisotropic, B, 1, jnp.asarray(hps), jx[0], jx[1],
        jnp.asarray(noise), 0)[0])
    iters = 200
    solve = SL._implicit_cg_factory(nb, B, iters, precond)
    od = (jnp.asarray(rows_c), jnp.asarray(cols_c), jnp.asarray(tiles),
          jnp.asarray(noise)) + ((jnp.asarray(Minv),) if precond else ())
    jX, vjp = jax.vjp(solve, od, jnp.asarray(Bv))
    od_bar, jB_bar = vjp(jnp.asarray(cot))
    t_tiles = torch.tensor(tiles, requires_grad=True)
    t_noise = torch.tensor(noise, requires_grad=True)
    t_B = torch.tensor(Bv, requires_grad=True)
    tX = TSL._ImplicitCG.apply(t_tiles, t_noise,
                               torch.as_tensor(Minv) if precond else None,
                               t_B, torch.as_tensor(rows),
                               torch.as_tensor(cols_c), nb, B, iters,
                               None, None)
    g_tiles, g_noise, g_B = torch.autograd.grad(
        tX, (t_tiles, t_noise, t_B), grad_outputs=torch.as_tensor(cot))
    scale = float(np.abs(np.asarray(jX)).max())
    np.testing.assert_allclose(tX.detach().numpy(), np.asarray(jX),
                               rtol=0, atol=RTOL * scale)
    for got, ref in ((g_tiles.numpy()[live], np.asarray(od_bar[2])[live]),
                     (g_noise.numpy(), np.asarray(od_bar[3])),
                     (g_B.numpy(), np.asarray(jB_bar))):
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=RTOL * float(np.abs(ref).max()))


def test_symmetric_route_matches_general_vjp(case):
    """``Aᵀ Ȳ = A Ȳ`` on a mirrored schedule: the SLQ step's backward
    against the general VJP of the K1 product (``chunked_spmm_vjp``)."""
    x, hps, nb, B, rows, cols, Z, jx, tx = case
    rng = np.random.default_rng(4)
    rows_t = torch.as_tensor(rows)
    cols_c = torch.clamp(torch.as_tensor(cols), max=nb - 1)
    tiles = TSL._assemble_chunked_tiles(
        t_wendland, B, None, torch.as_tensor(hps), torch.clamp(rows_t,
                                                               max=nb - 1),
        cols_c, rows_t < nb, tx[0], tx[1])
    X = torch.as_tensor(rng.standard_normal((nb * B, 3)))
    Ybar = torch.as_tensor(rng.standard_normal((nb * B, 3)))
    t_req = tiles.clone().requires_grad_(True)
    X_req = X.clone().requires_grad_(True)
    Y = TSL._SymmetricSpmm.apply(t_req, X_req, rows_t, cols_c, nb, B, None)
    g_tiles, g_X = torch.autograd.grad(Y, (t_req, X_req), grad_outputs=Ybar)
    ref_tiles, ref_X = HK.chunked_spmm_vjp(rows_t, cols_c, tiles, X, Ybar, nb,
                                           B, need_x=True)
    np.testing.assert_allclose(Y.detach().numpy(), HK.chunked_spmm_reference(
        rows_t, cols_c, tiles, X, nb, B).numpy(), rtol=0, atol=1e-13)
    np.testing.assert_array_equal(g_tiles.numpy(), ref_tiles.numpy())
    np.testing.assert_allclose(g_X.numpy(), ref_X.numpy(), rtol=0,
                               atol=1e-12 * float(ref_X.abs().max()))


@pytest.fixture(scope="module")
def committed_case():
    """Row-sorted schedule, 11 point blocks (odd: the last coarse group of
    width 2 is short), a tight exit so both solves converge fully."""
    x, y, hps, nb, B, rows, cols, _ = _setup(N=340, B=32, pad=5)
    order = np.argsort(rows, kind="stable")
    rows, cols = rows[order], cols[order]
    jx, tx = _padded(x, y, B)
    RHS = np.random.default_rng(5).standard_normal((nb * B, 4))
    RHS[len(x):] = 0.0
    return hps, nb, B, rows, cols, jx, tx, RHS


@pytest.mark.parametrize("cw", [1, 2])
def test_two_level_committed_solve_matches_jax(committed_case, cw):
    hps, nb, B, rows, cols, jx, tx, RHS = committed_case
    kw = dict(cg_iters=300, cg_tol=1e-12, precond_type="two_level",
              coarse_width=cw)
    ja, js = SL.make_committed_solver(wendland_anisotropic, nb, B, **kw)
    tiles, pdata = jax.jit(ja)(jnp.asarray(hps), jnp.asarray(rows),
                               jnp.asarray(cols), jx[0], jx[1], jx[4])
    jX, jit_ = jax.jit(js)(tiles, pdata, jnp.asarray(rows),
                           jnp.asarray(cols), jx[4], jnp.asarray(RHS))
    ta, ts = TSL.make_committed_solver(t_wendland, nb, B, **kw)
    r, c = torch.as_tensor(rows), torch.as_tensor(cols)
    ttiles, tp = ta(torch.as_tensor(hps), r, c, tx[0], tx[1], tx[4])
    assert tp[1].shape == (-(-nb // cw),) * 2 and tp[1].dtype == torch.float32
    # the solve on the same preconditioner data: the same CG, 1e-8
    same = (tp[0], torch.as_tensor(np.asarray(pdata[1])))
    tX, tit = ts(ttiles, same, r, c, tx[4], torch.as_tensor(RHS))
    assert tit == int(jit_)
    scale = float(np.abs(np.asarray(jX)).max())
    np.testing.assert_allclose(tX.numpy(), np.asarray(jX), rtol=0,
                               atol=RTOL * scale)
    # on its own coarse inverse (float32, last bits apart from JAX's): the
    # exit may move by a trip and the columns freeze at a relative
    # preconditioned residual of 1e-7 (_tight_floor_sq), so the solutions
    # agree to that floor
    tX, tit = ts(ttiles, tp, r, c, tx[4], torch.as_tensor(RHS))
    assert abs(tit - int(jit_)) <= 1
    np.testing.assert_allclose(tX.numpy(), np.asarray(jX), rtol=0,
                               atol=1e-6 * scale)
    # the preconditioner itself on one block of columns
    V = torch.as_tensor(RHS[:, :2])
    ref = SL._two_level_apply(pdata, jnp.asarray(RHS[:, :2]), B, cw)
    got = TSL._two_level_apply(tp, V, B, cw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5 * float(np.abs(ref).max()))


def test_coarse_inverse_matches_jax_and_float64(committed_case):
    """``_coarse_inverse`` is float32 by design in both packages (it only
    steers CG), so the two agree to float32 rounding, amplified by the
    coarse matrix's conditioning — and both to the float64 formula."""
    hps, nb, B, rows, cols, jx, tx, _ = committed_case
    ta, _ = TSL.make_committed_solver(t_wendland, nb, B)
    r, c = torch.as_tensor(rows), torch.as_tensor(cols)
    tiles, _ = ta(torch.as_tensor(hps), r, c, tx[0], tx[1], tx[4])
    cw = 2
    got = TSL._coarse_inverse(tiles, r, c, tx[4], nb, B, cw).numpy()
    ref = np.asarray(SL._coarse_inverse(jnp.asarray(tiles.numpy()),
                                        jnp.asarray(rows), jnp.asarray(cols),
                                        jx[4], nb, B, cw))
    nbg = -(-nb // cw)
    Ac = np.zeros((nbg, nbg))
    ts = tiles.numpy().sum(axis=(1, 2))
    np.add.at(Ac, (np.minimum(rows // cw, nbg - 1),
                   np.minimum(cols // cw, nbg - 1)), ts)
    ns = tx[4].numpy().reshape(nb, B).sum(1)
    g = np.minimum(np.arange(nb) // cw, nbg - 1)
    np.add.at(Ac, (g, g), ns)
    Ac = 0.5 * (Ac + Ac.T)
    exact = np.linalg.inv(Ac + 1e-6 * np.mean(np.diag(Ac)) * np.eye(nbg))
    tol = 50 * np.finfo(np.float32).eps * np.linalg.cond(Ac) \
        * np.abs(exact).max()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
    np.testing.assert_allclose(got, exact, rtol=0, atol=tol)
    assert TSL._normalize_committed_precond("AMG") == "two_level"
    assert TSL._normalize_committed_precond("jacobi") == "block_jacobi"
    with pytest.raises(Exception, match="Unknown committed-solver"):
        TSL._normalize_committed_precond("ilu")
