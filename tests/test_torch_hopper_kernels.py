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


@pytest.mark.parametrize("B", [16, 32])
@pytest.mark.parametrize("k", [1, 5, 17, 33])
def test_k1_plain_matches_jax_spmv(k, B):
    """Widths the kernel's n8 column fragments treat apart: one column, a
    ragged 5 and 17 (3 fragments, the training path's 1 + 16 probes) and
    33 (a second column tile)."""
    rows, cols, tiles, X, nb, B = _k1_case(np.random.default_rng(0), B=B,
                                           k=k)
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


@pytest.mark.parametrize("C", [1, 4])
@pytest.mark.parametrize("c", [5, 40, 128])
def test_k2_plain_in_fused_scan_matches_jax(c, C):
    """The sizes of test_pallas_kernels.test_fused_spmv_scan_matches_dense
    at the widths the kernels treat apart (ragged 5 and 40, the wgmma
    width 128) and chunk lengths 1 and 4; JAX runs its Pallas
    row_chunk_sums in interpret mode here."""
    rng = np.random.default_rng(1)
    nb, B = 6, 8
    pairs = sorted({(int(rng.integers(0, nb)), int(rng.integers(0, nb)))
                    for _ in range(18)})
    rows = np.array([p[0] for p in pairs], np.int32)
    cols = np.array([p[1] for p in pairs], np.int32)
    rows_p, cols_p, rowsc, _ = HK.row_aligned_schedule(rows, cols, nb, C=C,
                                                       chunk_bucket=4)
    tiles = np.zeros((len(rows_p), B, B), np.float32)
    live = cols_p < nb
    tiles[live] = rng.standard_normal((int(live.sum()), B, B))
    X = rng.standard_normal((nb * B, c)).astype(np.float32)
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


def _tf32(x):
    """Round float32 to TF32 (10-bit mantissa, nearest, ties away from
    zero): the kernels' ``cvt.rna.tf32.f32``."""
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _matmul_3xtf32(a, b):
    """The float32 kernels' arithmetic: a = a_hi + a_lo and b = b_hi + b_lo
    rounded to TF32, lo·hi + hi·lo + hi·hi summed in float32 (the TF32
    products are exact in float32)."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


@pytest.mark.parametrize("depth", [1024, 5376])
def test_3xtf32_split_holds_float32_accuracy(depth):
    """The error budget behind the card's 1e-4 check of float32 K1, K2 and
    K4: at K2's contraction depth (C·B = 8·128) and K1's (~21 tiles of 256
    per row at N = 50k) the 3×TF32 product stays within 1e-5 of the
    float64 product, of the output scale; one TF32 pass does not."""
    rng = np.random.default_rng(13)
    a = rng.uniform(0.0, 1.0, (64, depth))          # covariance tiles
    b = rng.standard_normal((depth, 24))            # X columns
    exact = torch.as_tensor(a) @ torch.as_tensor(b)
    a32 = torch.as_tensor(a, dtype=torch.float32)
    b32 = torch.as_tensor(b, dtype=torch.float32)
    scale = float(exact.abs().max())
    err = float((_matmul_3xtf32(a32, b32).double() - exact).abs().max())
    assert err <= 1e-5 * scale, err / scale
    one_pass = float(((_tf32(a32) @ _tf32(b32)).double() - exact).abs()
                     .max())
    assert one_pass > 1e-4 * scale, one_pass / scale


def test_row_segments_offsets_order_and_refusal():
    """The K1/K4 wrappers' row segments: CSR offsets with unclamped
    sentinels (row == nb) past the last offset, the launch order by
    descending tile count, an unsorted list refused, and the kept result
    dropped when the rows tensor is written in place."""
    nb = 4
    rows = torch.tensor([0, 0, 2, 2, 2, 3, 4, 4], dtype=torch.int32)
    row_ptr, order = HK._row_segments("t", rows, nb)
    assert row_ptr.tolist() == [0, 2, 2, 5, 6]
    assert order.tolist() == [2, 0, 3, 1]
    assert HK._row_segments("t", rows, nb)[0] is row_ptr
    rows[1] = 3                                   # now unsorted
    with pytest.raises(ValueError, match="row-sorted"):
        HK._row_segments("t", rows, nb)
    with pytest.raises(ValueError, match="row-sorted"):
        HK._row_segments("t", torch.tensor([1, 0], dtype=torch.int32), nb)


def test_row_segments_are_found_again_on_the_callers_rows_tensor():
    """K1's and K4's wrappers build the schedule from the caller's rows
    tensor and keep it there: the second call returns the kept tensors (no
    sortedness check, no host sync), another ``nb`` or an in-place write of
    ``rows`` — even one that leaves it sorted — drops them."""
    nb = 5
    rows = torch.tensor([0, 0, 1, 3, 3, 3, 5, 5], dtype=torch.int32)
    row_ptr, order = HK._row_segments("t", rows, nb)
    assert row_ptr.tolist() == [0, 2, 3, 3, 6, 6]     # sentinels past the end
    assert order.tolist() == [3, 0, 1, 2, 4]
    kept = rows._fvgp_row_segments
    again = HK._row_segments("t", rows, nb)
    assert again[0] is row_ptr and again[1] is order
    assert rows._fvgp_row_segments is kept
    wider = HK._row_segments("t", rows, nb + 1)       # another nb: rebuilt
    assert wider[0].tolist() == [0, 2, 3, 3, 6, 6, 8]
    rows[2] = 2                                       # in place, still sorted
    fresh = HK._row_segments("t", rows, nb)
    assert fresh[0] is not row_ptr
    assert fresh[0].tolist() == [0, 2, 2, 3, 6, 6]
    assert HK._row_segments("t", rows, nb)[0] is fresh[0]


def test_row_segments_of_int64_rows_are_kept_on_the_original():
    """An int64 rows tensor is cast for the kernel, but the schedule stays
    on the tensor the caller holds."""
    rows = torch.tensor([0, 1, 1, 2], dtype=torch.int64)
    row_ptr, _ = HK._row_segments("t", rows, 3)
    assert row_ptr.dtype == torch.int32 and row_ptr.tolist() == [0, 1, 3, 4]
    assert HK._row_segments("t", rows, 3)[0] is row_ptr
