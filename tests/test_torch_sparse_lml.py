"""The port's sparse LML and committed solver (fvgp_tpu_torch/ops/
sparse_lml.py) held against the JAX package on the CPU in float64, with the
same probes ``Z`` (drawn with numpy and given to both)."""

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
from fvgp_tpu_torch.ops import sparse_lml as TSL


def _setup(N=600, D=2, B=64, seed=1, probes=32, pad=17):
    """The _setup of test_sparse_lml.py, with numpy probes and 17 sentinel
    (index == nb) entries of bucket padding."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 18, (N, D))
    x = x[morton_order(x)]
    y = np.sin(x[:, 0])
    hps = np.array([1.0, 2.0, 2.0])
    rows, cols = _candidate_pairs(x, None, hps[1:], 1.0, B, symmetric=True)
    off = rows < cols
    nb = -(-N // B)
    rows_f = np.concatenate([rows, cols[off], np.full(pad, nb)])
    cols_f = np.concatenate([cols, rows[off], np.full(pad, nb)])
    n_pad = nb * B
    Z = rng.choice([-1.0, 1.0], size=(n_pad, probes))
    Z[N:] = 0.0
    return x, y, hps, nb, B, rows_f.astype(np.int32), \
        cols_f.astype(np.int32), Z


def _both_inputs(x, y, B):
    jx = SL.make_padded_inputs(x, y, np.full(len(x), 1e-2), B,
                               dtype=jnp.float64)
    tx = TSL.make_padded_inputs(x, y, np.full(len(x), 1e-2), B,
                                dtype=torch.float64, device="cpu")
    return jx, tx


@pytest.fixture(scope="module")
def lml_pair():
    x, y, hps, nb, B, rows, cols, Z = _setup()
    jx, tx = _both_inputs(x, y, B)
    lml = SL.make_sparse_lml(wendland_anisotropic, nb, B, cg_iters=100,
                             slq_degree=1, solver="mbcg", with_variance=True)
    (jv, jvar), jg = jax.jit(jax.value_and_grad(lml, has_aux=True))(
        jnp.asarray(hps), jnp.asarray(rows), jnp.asarray(cols), *jx,
        jnp.asarray(Z))
    tlml = TSL.make_sparse_lml(t_wendland, nb, B, cg_iters=100,
                               with_variance=True)
    h = torch.tensor(hps, requires_grad=True)
    tv, tvar = tlml(h, torch.as_tensor(rows), torch.as_tensor(cols), *tx,
                    torch.as_tensor(Z))
    tg, = torch.autograd.grad(tv, h)
    return ((float(jv), float(jvar), np.asarray(jg)),
            (float(tv.detach()), float(tvar.detach()), tg.numpy()))


# rtol 1e-7: both run the same float64 CG with the same exit decisions and
# the same quadrature; what differs is the order of float64 sums (segment
# sum vs index_add, einsum vs bmm), which CG and the Lanczos quadrature
# amplify by far less than 1e-7 over <= 100 iterations.
def test_sparse_lml_value_matches_jax(lml_pair):
    (jv, jvar, _), (tv, tvar, _) = lml_pair
    np.testing.assert_allclose(tv, jv, rtol=1e-7)
    np.testing.assert_allclose(tvar, jvar, rtol=1e-7)


def test_sparse_lml_gradient_matches_jax(lml_pair):
    (_, _, jg), (_, _, tg) = lml_pair
    np.testing.assert_allclose(tg, jg, rtol=1e-7)


@pytest.fixture(scope="module")
def committed_pair():
    x, y, hps, nb, B, rows, cols, _ = _setup(N=500, B=32)
    order = np.argsort(rows, kind="stable")        # row-sorted schedule
    rows, cols = rows[order], cols[order]
    jx, tx = _both_inputs(x, y, B)
    RHS = np.random.default_rng(5).standard_normal((nb * B, 6))
    RHS[len(x):] = 0.0
    ja, js = SL.make_committed_solver(wendland_anisotropic, nb, B,
                                      cg_iters=200)
    tiles, Minv = jax.jit(ja)(jnp.asarray(hps), jnp.asarray(rows),
                              jnp.asarray(cols), jx[0], jx[1], jx[4])
    jX, jit_ = jax.jit(js)(tiles, Minv, jnp.asarray(rows), jnp.asarray(cols),
                           jx[4], jnp.asarray(RHS))
    ta, ts = TSL.make_committed_solver(t_wendland, nb, B, cg_iters=200)
    r, c = torch.as_tensor(rows), torch.as_tensor(cols)
    ttiles, tMinv = ta(torch.as_tensor(hps), r, c, tx[0], tx[1], tx[4])
    tX, tit = ts(ttiles, tMinv, r, c, tx[4], torch.as_tensor(RHS))
    return (np.asarray(jX), int(jit_)), (tX.numpy(), tit)


def test_committed_solver_matches_jax(committed_pair):
    (jX, jit_), (tX, tit) = committed_pair
    assert tit == jit_
    np.testing.assert_allclose(tX, jX, rtol=0, atol=1e-8)


def test_spmv_scan_matches_jax():
    """The tile-streaming wide SpMM, with unclamped sentinel rows
    (dropped) and sentinel columns (clamped, zero tiles)."""
    rng = np.random.default_rng(2)
    nb, B, T, c = 7, 16, 64, 9
    rows = np.sort(rng.integers(0, nb, T)).astype(np.int32)
    cols = rng.integers(0, nb, T).astype(np.int32)
    tiles = rng.standard_normal((T, B, B))
    rows[-5:] = nb
    cols[-5:] = nb
    tiles[-5:] = 0.0
    X = rng.standard_normal((nb * B, c))
    ref = np.asarray(SL._spmv_scan(jnp.asarray(rows), jnp.asarray(cols),
                                   jnp.asarray(tiles), jnp.asarray(X), nb, B))
    got = TSL._spmv_scan(torch.as_tensor(rows), torch.as_tensor(cols),
                         torch.as_tensor(tiles), torch.as_tensor(X), nb, B)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-10)


# bfloat16 tile streaming, as the benchmark's gp2scale-wendland-1m-bf16
# runs it: tiles and SpMM operands in bfloat16, vectors in float32, the
# 32-trip cap and the per-dtype exit floor.  The signal variance sits just
# short of a bfloat16 rounding midpoint, where rounding moves the answer
# most (~5e-3 of the LML), so the float32 port lands outside the bound.
BF16_ULP = 2.0 ** -8      # bfloat16's relative spacing at 1


@pytest.mark.parametrize("seed", [1, 3])
def test_sparse_lml_bf16_matches_jax(seed):
    """The port's bfloat16 LML and gradient against the JAX package's at
    the same points, hyperparameters and probes: the value and each
    gradient entry within half a bfloat16 ulp of the JAX answer."""
    N, B = 1500, 64
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, (N * 4.19 * 8 / 40) ** (1 / 3), (N, 3))
    x = x[morton_order(x)]
    y = np.sin(0.2 * x[:, 0]) + 0.05 * rng.standard_normal(N)
    hps = np.array([1.0 + BF16_ULP * 0.999, 2.0, 2.0, 2.0])
    rows, cols = _candidate_pairs(x, None, hps[1:], 1.0, B, symmetric=True)
    off = rows < cols
    rows, cols = (np.concatenate([rows, cols[off]]).astype(np.int32),
                  np.concatenate([cols, rows[off]]).astype(np.int32))
    nb = -(-N // B)
    Z = rng.choice([-1.0, 1.0], size=(nb * B, 16))
    Z[N:] = 0.0
    noise = np.full(N, 1e-2)
    jx = SL.make_padded_inputs(x, y, noise, B, dtype=jnp.float32)
    tx = TSL.make_padded_inputs(x, y, noise, B, dtype=torch.float32,
                                device="cpu")
    lml = SL.make_sparse_lml(wendland_anisotropic, nb, B, cg_iters=32,
                             slq_degree=1, solver="mbcg", with_variance=True,
                             solver_dtype=jnp.bfloat16)
    (jv, _), jg = jax.jit(jax.value_and_grad(lml, has_aux=True))(
        jnp.asarray(hps, jnp.float32), jnp.asarray(rows), jnp.asarray(cols),
        *jx, jnp.asarray(Z, jnp.float32))
    jv, jg = float(jv), np.asarray(jg, np.float64)

    def port(solver_dtype):
        tlml = TSL.make_sparse_lml(t_wendland, nb, B, cg_iters=32,
                                   with_variance=True,
                                   solver_dtype=solver_dtype)
        h = torch.tensor(hps, dtype=torch.float32, requires_grad=True)
        tv, _ = tlml(h, torch.as_tensor(rows), torch.as_tensor(cols), *tx,
                     torch.as_tensor(Z, dtype=torch.float32))
        tg, = torch.autograd.grad(tv, h)
        return float(tv.detach()), tg.numpy().astype(np.float64)

    def within(answer):
        v, g = answer
        return (abs(v - jv) <= BF16_ULP / 2 * abs(jv)
                and bool(np.all(np.abs(g - jg) <= BF16_ULP / 2 * np.abs(jg))))

    bf16 = port(torch.bfloat16)
    assert within(bf16), (bf16, (jv, jg))
    assert not within(port(None))
