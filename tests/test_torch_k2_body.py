"""K2's float32 body on wgmma (``segment_mma_kernel_wgmma_tf32``): the
arithmetic that it keeps, and the zero padding tiles that it skips.

On the CPU: a plain emulation of the body's 3×TF32 arithmetic (hi and lo
rounded to TF32 to nearest, ties away, as ``cvt.rna.tf32.f32``; the lo·lo
term dropped; a fresh float32 partial for each 32-deep stage, added to the
sum in float32) stays as close to float64 as a float32 product does at the
committed solver's depth, and the committed solver's assembly leaves the
padding tiles of a row-aligned schedule exactly zero.  On a card (``cuda``
marker; skipped here): the body against float64 and the plain version,
padding chunks zero, and the counter of its launches.  Imports neither JAX
nor the JAX package, so the card tests run with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_k2_body.py
"""

import numpy as np
import pytest
import torch

from fvgp_tpu_torch.kernels import wendland_anisotropic
from fvgp_tpu_torch.ops import hopper_kernels as HK
from fvgp_tpu_torch.ops import sparse_lml as SL
from fvgp_tpu_torch.utils import trace


def _tf32_rna(x):
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero: ``cvt.rna.tf32.f32``."""
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


def _three_tf32(A, X, depth=32):
    """A @ X as the wgmma body sums it: per stage of ``depth`` contraction
    indices a fresh float32 partial of lo·hi + hi·lo + hi·hi."""
    acc = torch.zeros((A.shape[0], X.shape[1]), dtype=torch.float32)
    for k0 in range(0, A.shape[1], depth):
        ah, al = _split(A[:, k0:k0 + depth])
        xh, xl = _split(X[k0:k0 + depth])
        acc += al @ xh + ah @ xl + ah @ xh
    return acc


def test_tf32_rounding_is_to_nearest_ties_away():
    one = torch.tensor([1.0], dtype=torch.float32)
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0 ** -20,
                      1 + ulp / 4, 3.0], dtype=torch.float32)
    got = _tf32_rna(x.clone())
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1.0, 3.0])
    assert torch.equal(got, want)
    # hi + lo keeps 21 of float32's 24 bits
    third = torch.tensor([1 / 3], dtype=torch.float32)
    hi, lo = _split(third.clone())
    assert 0 < abs(float(third.double() - hi.double() - lo.double())) \
        <= 2.0 ** -22 / 3
    assert _tf32_rna(one) == one


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_three_tf32_stages_keep_float32_accuracy(seed):
    """At the committed solver's depth, C·B = 8·128 = 1,024 (one chunk),
    the emulated body's error against float64 is within twice a float32
    product's, where one TF32 pass is ~1,000 times worse."""
    gen = torch.Generator().manual_seed(seed)
    # covariance-like tiles (nonnegative, O(1)) against standard-normal X
    A = torch.rand((128, 1024), generator=gen, dtype=torch.float64) ** 4
    X = torch.randn((1024, 64), generator=gen, dtype=torch.float64)
    ref = A @ X
    A32, X32 = A.float(), X.float()
    scale = float(ref.abs().max())
    err_f32 = float((A32 @ X32 - ref).abs().max()) / scale
    err_3tf32 = float((_three_tf32(A32, X32).double() - ref).abs().max()) \
        / scale
    err_1tf32 = float((_tf32_rna(A32.clone()) @ _tf32_rna(X32.clone())
                       - ref).abs().max()) / scale
    assert err_3tf32 <= 2.0 * err_f32
    assert err_1tf32 > 100.0 * err_f32


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_committed_assembly_zeroes_its_padding_tiles(dtype):
    """The float32 body skips the tiles whose column is the sentinel nb;
    the committed solver's ``assemble`` must make them exactly zero, on a
    row-aligned schedule with padding inside rows and padding chunks."""
    rng = np.random.default_rng(11)
    N, B = 300, 32
    x = np.sort(rng.uniform(0, 30, N))[:, None]
    nb = -(-N // B)
    rows = np.repeat(np.arange(nb), 3)
    cols = rows + np.tile([-1, 0, 1], nb)
    keep = (cols >= 0) & (cols < nb)
    rows_p, cols_p, _, _ = HK.row_aligned_schedule(
        rows[keep].astype(np.int32), cols[keep].astype(np.int32), nb, C=8,
        chunk_bucket=4)
    xb, mask, _, _, noise = SL.make_padded_inputs(
        x, np.sin(x[:, 0]), np.full(N, 1e-2), B, dtype=dtype, device="cpu")
    assemble, _ = SL.make_committed_solver(wendland_anisotropic, nb, B,
                                           row_chunk=8)
    r, c = torch.as_tensor(rows_p), torch.as_tensor(cols_p)
    tiles, _ = assemble(torch.tensor([1.0, 2.0], dtype=dtype), r, c, xb,
                        mask, noise)
    pad = c >= nb
    assert tiles.dtype == dtype and tiles.shape == (len(rows_p), B, B)
    assert int(pad.sum()) >= 2 * nb and bool((r[pad] < nb).any())
    assert torch.count_nonzero(tiles[pad]) == 0
    assert bool((tiles[~pad].abs().amax(dim=(1, 2)) > 0).all())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _k2_case(rng, B, C, c, nb=6, n_chunks=7):
    """Float32 tiles with two all-padding chunks and a padding tile at the
    end (zero tiles, cols == nb)."""
    cols = rng.integers(0, nb, n_chunks * C).astype(np.int32)
    tiles = rng.standard_normal((n_chunks * C, B, B))
    cols[-1] = nb
    tiles[-1] = 0.0
    for s in (1, 4):
        cols[s * C:(s + 1) * C] = nb
        tiles[s * C:(s + 1) * C] = 0.0
    Xb = rng.standard_normal((nb, B, c))
    return tiles, cols, Xb


@pytest.mark.cuda
@pytest.mark.parametrize("B", [32, 64, 96, 128, 256])
@pytest.mark.parametrize("c", [1, 8, 24, 40, 100, 128, 300, 512])
def test_float32_body_matches_plain_on_card(cuda_device, B, c):
    tiles, cols, Xb = _k2_case(np.random.default_rng(B * 1000 + c), B, 8, c)
    t = torch.as_tensor(tiles, dtype=torch.float32).to(cuda_device)
    cc = torch.as_tensor(cols).to(cuda_device)
    x = torch.as_tensor(Xb, dtype=torch.float32).to(cuda_device)
    got = HK.row_chunk_sums(t, cc, x, B, C=8)
    # float64 sums of the same products (padding tiles are zero)
    xg = x[cc.long().clamp(max=x.shape[0] - 1)].double()
    ref = torch.bmm(t.double(), xg).reshape(-1, 8, B, c).sum(1)
    plain = HK.row_chunk_sums_reference(t, cc, x, B, 8)
    assert got.shape == ref.shape and got.dtype == torch.float32
    scale = float(ref.abs().max())
    err = float((got.double() - ref).abs().max())
    # float32's own accuracy: within twice the plain version's error, or a
    # millionth of the output's scale where that error is smaller
    assert err <= max(2.0 * float((plain.double() - ref).abs().max()),
                      1e-6 * scale)
    assert torch.all(got[1] == 0) and torch.all(got[4] == 0)


@pytest.mark.cuda
def test_wgmma_body_is_counted_on_card(cuda_device):
    tiles, cols, Xb = _k2_case(np.random.default_rng(3), 128, 8, 1024)
    t = torch.as_tensor(tiles, dtype=torch.float32).to(cuda_device)
    cc = torch.as_tensor(cols).to(cuda_device)
    launches = HK.row_chunk_sums.launches
    wgmma = trace.counters().get("k2_wgmma_launches", 0)
    widths = (1, 9, 512, 1024)
    for c in widths:
        x = torch.as_tensor(Xb[..., :c], dtype=torch.float32).to(cuda_device)
        HK.row_chunk_sums(t, cc, x, 128, C=8)
        HK.row_chunk_sums(t.bfloat16(), cc, x.bfloat16(), 128, C=8)
    assert HK.row_chunk_sums.launches == launches + 2 * len(widths)
    assert trace.counters().get("k2_wgmma_launches", 0) \
        == wgmma + len(widths)
