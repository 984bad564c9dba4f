"""The port's Hopper-kernel module (fvgp_tpu_torch/ops/hopper_kernels.py)
held against the JAX package on the CPU: K1's plain version against the
JAX ``_spmv`` (value and VJP), K2's plain version inside the port's
``_spmv_scan_fused`` against the JAX one (Pallas in interpret mode), the
host schedule, and the dispatch rule that CPU tensors never launch a
kernel.  The kernels themselves run only on a card
(tests/test_torch_kernels_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvgp_tpu.ops import pallas_kernels as PK
from fvgp_tpu.ops import sparse_lml as SL
from fvgp_tpu_torch.ops import hopper_kernels as HK
from fvgp_tpu_torch.ops import sparse_lml as TSL


def _k1_case(rng, T=96, B=16, nb=10, k=5):
    """Row-sorted tile list whose last 8 entries are clamped sentinels with
    zero tiles (the training path's contract)."""
    rows = np.sort(rng.integers(0, nb, T)).astype(np.int32)
    cols = rng.integers(0, nb, T).astype(np.int32)
    tiles = rng.standard_normal((T, B, B))
    tiles[-8:] = 0.0
    rows[-8:] = nb - 1
    cols[-8:] = nb - 1
    X = rng.standard_normal((nb * B, k))
    return rows, cols, tiles, X, nb, B


def test_k1_plain_matches_jax_spmv():
    rows, cols, tiles, X, nb, B = _k1_case(np.random.default_rng(0))
    ref = np.asarray(SL._spmv(jnp.asarray(rows), jnp.asarray(cols),
                              jnp.asarray(tiles), jnp.asarray(X), nb, B))
    got = HK.chunked_spmm(torch.as_tensor(rows), torch.as_tensor(cols),
                          torch.as_tensor(tiles), torch.as_tensor(X), nb, B)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-10)


def test_k1_plain_drops_unclamped_sentinel_rows():
    """Rows == nb contribute nothing (the JAX segment_sum drops them)."""
    rows, cols, tiles, X, nb, B = _k1_case(np.random.default_rng(1))
    rows_u = rows.copy()
    rows_u[-8:] = nb
    tiles_g = tiles.copy()
    tiles_g[-8:] = 7.0                       # garbage on the dropped rows
    ref = np.asarray(SL._spmv(jnp.asarray(rows_u), jnp.asarray(cols),
                              jnp.asarray(tiles_g), jnp.asarray(X), nb, B))
    got = HK.chunked_spmm_reference(
        torch.as_tensor(rows_u), torch.as_tensor(cols),
        torch.as_tensor(tiles_g), torch.as_tensor(X), nb, B)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-10)


@pytest.fixture(scope="module")
def k1_vjp_case():
    rows, cols, tiles, X, nb, B = _k1_case(np.random.default_rng(2))

    def loss(t, x):
        return jnp.sum(SL._spmv(jnp.asarray(rows), jnp.asarray(cols), t, x,
                                nb, B) ** 2)

    g_t, g_x = jax.grad(loss, argnums=(0, 1))(jnp.asarray(tiles),
                                              jnp.asarray(X))
    return rows, cols, tiles, X, nb, B, np.asarray(g_t), np.asarray(g_x)


def test_k1_autograd_matches_jax_grad(k1_vjp_case):
    """The case of test_pallas_kernels.test_chunked_spmm_matches_xla:
    torch autograd through the plain version vs jax.grad of ``_spmv``."""
    rows, cols, tiles, X, nb, B, g_t, g_x = k1_vjp_case
    t = torch.as_tensor(tiles).requires_grad_(True)
    x = torch.as_tensor(X).requires_grad_(True)
    out = HK.chunked_spmm(torch.as_tensor(rows), torch.as_tensor(cols), t, x,
                          nb, B)
    torch.sum(out ** 2).backward()
    np.testing.assert_allclose(t.grad.numpy(), g_t, rtol=0, atol=1e-10)
    np.testing.assert_allclose(x.grad.numpy(), g_x, rtol=0, atol=1e-10)


def test_k1_explicit_vjp_matches_jax_grad(k1_vjp_case):
    """``chunked_spmm_vjp`` — the kernel's backward and the mBCG backward's
    tile cotangent — against jax.grad, in small tile slices."""
    rows, cols, tiles, X, nb, B, g_t, g_x = k1_vjp_case
    Xt = torch.as_tensor(X)
    Y = HK.chunked_spmm_reference(torch.as_tensor(rows),
                                  torch.as_tensor(cols),
                                  torch.as_tensor(tiles), Xt, nb, B)
    t_bar, x_bar = HK.chunked_spmm_vjp(
        torch.as_tensor(rows), torch.as_tensor(cols), torch.as_tensor(tiles),
        Xt, 2.0 * Y, nb, B, chunk=7)
    np.testing.assert_allclose(t_bar.numpy(), g_t, rtol=0, atol=1e-10)
    np.testing.assert_allclose(x_bar.numpy(), g_x, rtol=0, atol=1e-10)


def test_row_aligned_schedule_identical_to_jax():
    rng = np.random.default_rng(0)
    nb, C = 9, 4
    pairs = sorted({(int(rng.integers(0, nb)), int(rng.integers(0, nb)))
                    for _ in range(30)})
    rows = np.array([p[0] for p in pairs], np.int32)
    cols = np.array([p[1] for p in pairs], np.int32)
    for bucket in (4, 256):
        ref = PK.row_aligned_schedule(rows, cols, nb, C=C,
                                      chunk_bucket=bucket)
        got = HK.row_aligned_schedule(rows, cols, nb, C=C,
                                      chunk_bucket=bucket)
        for a, b in zip(got[:3], ref[:3]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert got[3] == ref[3]


def test_k2_plain_in_fused_scan_matches_jax():
    """The sizes of test_pallas_kernels.test_fused_spmv_scan_matches_dense;
    JAX runs its Pallas row_chunk_sums in interpret mode here."""
    rng = np.random.default_rng(1)
    nb, B, C = 6, 8, 4
    pairs = sorted({(int(rng.integers(0, nb)), int(rng.integers(0, nb)))
                    for _ in range(18)})
    rows = np.array([p[0] for p in pairs], np.int32)
    cols = np.array([p[1] for p in pairs], np.int32)
    rows_p, cols_p, rowsc, _ = HK.row_aligned_schedule(rows, cols, nb, C=C,
                                                       chunk_bucket=4)
    tiles = np.zeros((len(rows_p), B, B), np.float32)
    live = cols_p < nb
    tiles[live] = rng.standard_normal((int(live.sum()), B, B))
    X = rng.standard_normal((nb * B, 5)).astype(np.float32)
    ref = np.asarray(SL._spmv_scan_fused(
        jnp.asarray(rowsc), jnp.asarray(cols_p), jnp.asarray(tiles),
        jnp.asarray(X), nb, B, C=C))
    got = TSL._spmv_scan_fused(torch.as_tensor(rowsc),
                               torch.as_tensor(cols_p),
                               torch.as_tensor(tiles), torch.as_tensor(X),
                               nb, B, C=C)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_cpu_tensors_never_launch_a_kernel():
    HK.reset_launch_counts()
    rows, cols, tiles, X, nb, B = _k1_case(np.random.default_rng(3), B=32,
                                           nb=4)
    t32 = torch.as_tensor(tiles, dtype=torch.float32)
    X32 = torch.as_tensor(X, dtype=torch.float32)
    HK.chunked_spmm(torch.as_tensor(rows), torch.as_tensor(cols), t32, X32,
                    nb, B, mv_dtype=torch.bfloat16)
    HK.row_chunk_sums(t32[:8], torch.as_tensor(cols[:8]),
                      X32.reshape(nb, B, -1), B, C=8)
    assert HK.chunked_spmm.launches == 0
    assert HK.row_chunk_sums.launches == 0
