"""The Hopper kernels against their plain PyTorch versions on a CUDA card
(``cuda`` marker; every test skips without a card).  Imports neither JAX
nor the JAX package, so it runs without the suite's JAX setup:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from fvgp_tpu_torch.ops import hopper_kernels as HK


def _k1_case(rng, T, B, nb, k):
    """Row-sorted tile list whose last 8 entries are clamped sentinels with
    zero tiles."""
    rows = np.sort(rng.integers(0, nb, T)).astype(np.int32)
    cols = rng.integers(0, nb, T).astype(np.int32)
    tiles = rng.standard_normal((T, B, B))
    tiles[-8:] = 0.0
    rows[-8:] = nb - 1
    cols[-8:] = nb - 1
    X = rng.standard_normal((nb * B, k))
    return rows, cols, tiles, X, nb, B


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sentinel_row", ["clamped", "unclamped"])
def test_k1_kernel_matches_plain_on_card(cuda_device, dtype, sentinel_row):
    rows, cols, tiles, X, nb, B = _k1_case(np.random.default_rng(4), T=256,
                                           B=64, nb=12, k=17)
    if sentinel_row == "unclamped":
        rows[-8:] = nb                    # skipped past the last offset
    args = [torch.as_tensor(a).to(cuda_device) for a in (rows, cols)]
    t = torch.as_tensor(tiles, dtype=dtype).to(cuda_device)
    x = torch.as_tensor(X, dtype=torch.float32).to(cuda_device)
    mvd = None if dtype == torch.float32 else dtype
    before = HK.chunked_spmm.launches
    got = HK.chunked_spmm(*args, t, x, nb, B, mv_dtype=mvd)
    ref = HK.chunked_spmm_reference(*args, t, x, nb, B, mv_dtype=mvd)
    assert HK.chunked_spmm.launches == before + 1
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=1e-4 * float(ref.abs().max()))


@pytest.mark.cuda
def test_k2_kernel_matches_plain_on_card(cuda_device):
    rng = np.random.default_rng(5)
    nb, B, C, c = 7, 64, 8, 40
    tiles = torch.as_tensor(rng.standard_normal((4 * C, B, B)),
                            dtype=torch.bfloat16).to(cuda_device)
    cols = torch.as_tensor(rng.integers(0, nb + 1, 4 * C).astype(np.int32))
    Xb = torch.as_tensor(rng.standard_normal((nb, B, c)),
                         dtype=torch.bfloat16).to(cuda_device)
    cols = cols.to(cuda_device)
    before = HK.row_chunk_sums.launches
    got = HK.row_chunk_sums(tiles, cols, Xb, B, C=C)
    ref = HK.row_chunk_sums_reference(tiles, cols, Xb, B, C=C)
    assert HK.row_chunk_sums.launches == before + 1
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=1e-4 * float(ref.abs().max()))


def _close_to_plain(got, ref, rtol=1e-4):
    """Kernel against plain version: ``rtol`` of the output scale (both
    read the same inputs and sum in float32, in another order)."""
    scale = float(ref.float().abs().max())
    torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                               atol=rtol * max(scale, 1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [64, 128, 256])
@pytest.mark.parametrize("k", [1, 17, 40])
def test_k1_k4_pipeline_edges_on_card(cuda_device, dtype, B, k):
    """Where the pipelined segment body breaks: row block 0 owns more tiles
    than the ring has stages, row block 1 owns none (K4 writes it as zero),
    one- and 40-column X (ragged against the n8 fragments), unclamped
    sentinels at the tail."""
    rng = np.random.default_rng(11)
    nb = 5
    rows = np.concatenate([np.zeros(9), np.full(4, 2), np.full(3, 3),
                           np.full(2, 4), np.full(3, nb)]).astype(np.int32)
    cols = rng.integers(0, nb, len(rows)).astype(np.int32)
    cols[-3:] = nb
    tiles = rng.standard_normal((len(rows), B, B))
    tiles[-3:] = 0.0
    r, c = (torch.as_tensor(a).to(cuda_device) for a in (rows, cols))
    cc = c.clamp(max=nb - 1)
    t = torch.as_tensor(tiles, dtype=dtype).to(cuda_device)
    x = torch.as_tensor(rng.standard_normal((nb * B, k)),
                        dtype=torch.float32).to(cuda_device)
    mvd = None if dtype == torch.float32 else dtype
    before = HK.chunked_spmm.launches
    got = HK.chunked_spmm(r, cc, t, x, nb, B, mv_dtype=mvd)
    assert HK.chunked_spmm.launches == before + 1
    _close_to_plain(got, HK.chunked_spmm_reference(r, cc, t, x, nb, B,
                                                   mv_dtype=mvd))
    assert torch.all(got[B:2 * B] == 0)
    xk = x.to(dtype)
    before = HK.block_spmv.launches
    got = HK.block_spmv(r, c, t, xk, nb, B)
    assert HK.block_spmv.launches == before + 1
    ref = HK.block_spmv_reference(r, c, t, xk, nb, B)
    assert got.dtype == dtype and got.shape == ref.shape
    _close_to_plain(got, ref, 1e-4 if dtype == torch.float32 else 1e-2)
    assert torch.all(got[B:2 * B] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [64, 128, 256])
@pytest.mark.parametrize("C", [1, 8])
@pytest.mark.parametrize("c", [1, 40, 128, 200, 300])
def test_k2_shapes_on_card(cuda_device, dtype, B, C, c):
    """K2 at ragged widths (1, 40, 200), at the wgmma widths (128) and past
    256 (300: two column tiles), with all-sentinel chunks (zero tiles,
    cols == nb) among live ones."""
    rng = np.random.default_rng(12)
    nb, n_chunks = 6, 7
    cols = rng.integers(0, nb, n_chunks * C).astype(np.int32)
    tiles = rng.standard_normal((n_chunks * C, B, B))
    for s in (1, 4):                              # all-sentinel chunks
        cols[s * C:(s + 1) * C] = nb
        tiles[s * C:(s + 1) * C] = 0.0
    t = torch.as_tensor(tiles, dtype=dtype).to(cuda_device)
    cc = torch.as_tensor(cols).to(cuda_device)
    Xb = torch.as_tensor(rng.standard_normal((nb, B, c)),
                         dtype=dtype).to(cuda_device)
    before = HK.row_chunk_sums.launches
    got = HK.row_chunk_sums(t, cc, Xb, B, C=C)
    assert HK.row_chunk_sums.launches == before + 1
    ref = HK.row_chunk_sums_reference(t, cc, Xb, B, C=C)
    assert got.shape == (n_chunks, B, c) and got.dtype == torch.float32
    _close_to_plain(got, ref)
    assert torch.all(got[1] == 0) and torch.all(got[4] == 0)


@pytest.mark.cuda
def test_journey_on_card_matches_cpu(cuda_device):
    """The public journey at a small size: CUDA float32 (kernels launched)
    against the CPU in float64, same probes; bounds as in chip_smoke.py."""
    import warnings

    from fvgp_tpu_torch import GP
    rng = np.random.default_rng(9)
    n = 3000
    x = rng.uniform(0, 20, (n, 3))
    y = np.sin(0.3 * x[:, 0]) + 0.05 * rng.standard_normal(n)
    xp = rng.uniform(0, 20, (20, 3))
    hps = np.array([1.0, 2.0, 2.0, 2.0])
    out = {}
    HK.reset_launch_counts()
    for device in ("cpu", "cuda"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            gp = GP(x, y, init_hyperparameters=hps,
                    noise_variances=np.full(n, 1e-2), gp2Scale=True,
                    compute_device=device, linalg_mode="sparseCGpre",
                    args={"gp2Scale_block_size": 64,
                          "gp2Scale_structure_cache_dir": False})
            val, grad = gp.marginal_likelihood \
                .log_likelihood_value_and_gradient(hps)
            out[device] = (val, grad, gp.posterior_mean(xp)["m(x)"],
                           gp.posterior_covariance(xp,
                                                   variance_only=True)["v(x)"])
    assert HK.chunked_spmm.launches > 0 and HK.row_chunk_sums.launches > 0
    (v0, g0, m0, s0), (v1, g1, m1, s1) = out["cpu"], out["cuda"]
    assert abs(v1 - v0) / abs(v0) < 1e-4
    assert np.linalg.norm(g1 - g0) / np.linalg.norm(g0) < 1e-3
    np.testing.assert_allclose(m1, m0, rtol=0, atol=1e-3)
    np.testing.assert_allclose(s1, s0, rtol=0, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["matern32", "wendland"])
def test_k3_kernel_matches_plain_on_card(cuda_device, kind, dtype):
    """Ragged (not a multiple of 32) shapes; the diagonal of k(x, x) is
    exactly the signal variance (d = 0 exactly)."""
    rng = np.random.default_rng(6)
    x1 = torch.as_tensor(rng.uniform(0, 6, (301, 3)), dtype=dtype) \
        .to(cuda_device)
    x2 = torch.as_tensor(rng.uniform(0, 6, (77, 3)), dtype=dtype) \
        .to(cuda_device)
    hps = torch.as_tensor([1.3, 1.5, 2.0, 2.5], dtype=dtype).to(cuda_device)
    before = HK.dense_covariance.launches
    got = HK.dense_covariance(x1, x2, hps, kind=kind)
    self_cov = HK.dense_covariance(x1, x1, hps, kind=kind)
    assert HK.dense_covariance.launches == before + 2
    ref = HK.dense_covariance_reference(x1, x2, hps, kind=kind)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(got, ref, rtol=0, atol=tol)
    assert torch.all(torch.diagonal(self_cov) == hps[0])


@pytest.mark.cuda
def test_k3_refuses_autograd_and_default_kernel_routes_around_it(
        cuda_device):
    from fvgp_tpu_torch.kernels import default_matern_ard
    x = torch.rand((40, 2), device=cuda_device, dtype=torch.float64)
    h = torch.tensor([1.0, 0.7, 0.9], device=cuda_device,
                     dtype=torch.float64, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        HK.dense_covariance(x, x, h)
    before = HK.dense_covariance.launches
    default_matern_ard(x, x, h).sum().backward()     # the plain formula
    assert HK.dense_covariance.launches == before
    with torch.no_grad():
        default_matern_ard(x, x, h)
    assert HK.dense_covariance.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_kernel_matches_plain_on_card(cuda_device, dtype):
    """Rows without tiles come back zero, sentinels are clamped, ragged n,
    1-D X squeezed."""
    rng = np.random.default_rng(7)
    nb, B, k = 9, 64, 17
    rows = np.sort(rng.integers(0, nb, 40)).astype(np.int32)
    rows[rows == 4] = 5                       # row block 4 owns no tile
    cols = rng.integers(0, nb, 40).astype(np.int32)
    rows = np.concatenate([rows, [nb, nb]]).astype(np.int32)
    cols = np.concatenate([cols, [nb, nb]]).astype(np.int32)
    tiles = rng.standard_normal((42, B, B))
    tiles[-2:] = 0.0
    args = [torch.as_tensor(a).to(cuda_device) for a in (rows, cols)]
    t = torch.as_tensor(tiles, dtype=dtype).to(cuda_device)
    n = nb * B - 13
    for X in (rng.standard_normal((n, k)), rng.standard_normal(n)):
        x = torch.as_tensor(X, dtype=dtype).to(cuda_device)
        before = HK.block_spmv.launches
        got = HK.block_spmv(*args, t, x, nb, B)
        assert HK.block_spmv.launches == before + 1
        ref = HK.block_spmv_reference(*args, t, x, nb, B)
        assert got.shape == ref.shape and got.dtype == dtype
        scale = float(ref.float().abs().max())
        tol = 1e-4 * scale if dtype == torch.float32 else 1e-2 * scale
        torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                                   atol=tol)
        assert torch.all(got[4 * B:5 * B] == 0)


@pytest.mark.cuda
def test_dense_journey_on_card_matches_cpu(cuda_device):
    """The dense GP at a small size: CUDA float32 (K3 launched for the
    committed covariances) against the CPU in float64; bounds as in
    chip_smoke.py."""
    import warnings

    from fvgp_tpu_torch import GP
    rng = np.random.default_rng(10)
    n = 600
    x = rng.uniform(0, 10, (n, 3))
    y = np.sin(x[:, 0]) + 0.05 * rng.standard_normal(n)
    xp = rng.uniform(0, 10, (25, 3))
    hps = np.array([1.0, 1.5, 1.5, 1.5])
    out = {}
    HK.reset_launch_counts()
    for device in ("cpu", "cuda"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            gp = GP(x, y, init_hyperparameters=hps,
                    noise_variances=np.full(n, 1e-2), compute_device=device)
            val, grad = gp.marginal_likelihood \
                .log_likelihood_value_and_gradient(hps)
            out[device] = (val, grad, gp.posterior_mean(xp)["m(x)"],
                           gp.posterior_covariance(xp,
                                                   variance_only=True)["v(x)"])
    assert HK.dense_covariance.launches > 0
    (v0, g0, m0, s0), (v1, g1, m1, s1) = out["cpu"], out["cuda"]
    assert abs(v1 - v0) / abs(v0) < 1e-4
    assert np.linalg.norm(g1 - g0) / np.linalg.norm(g0) < 1e-3
    np.testing.assert_allclose(m1, m0, rtol=0, atol=1e-3)
    np.testing.assert_allclose(s1, s0, rtol=0, atol=1e-3)


def _k3_inputs(rng, n1, n2, D, dtype, device):
    x1 = torch.as_tensor(rng.uniform(0, 4, (n1, D)), dtype=dtype).to(device)
    x2 = torch.as_tensor(rng.uniform(0, 4, (n2, D)), dtype=dtype).to(device)
    hps = torch.as_tensor(np.concatenate([[1.3], rng.uniform(1.0, 3.0, D)]),
                          dtype=dtype).to(device)
    return x1, x2, hps


_K3_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["matern32", "wendland"])
@pytest.mark.parametrize("D", [1, 2, 3, 4, 8, 17, 32])
@pytest.mark.parametrize("n1,n2", [(1, 1), (33, 1000), (129, 33), (1000, 129),
                                   (129, 130), (301, 6), (1000, 1000)])
def test_k3_shapes_on_card(cuda_device, n1, n2, D, kind, dtype):
    """Where the tiled body breaks: one element, tile edges (33, 129), an
    n2 whose rows are not 16-byte aligned (odd, and n2 % 4 == 2: the
    scalar-store instance in float32, the vector one in float64), every
    templated D and the run-time loop (8, 17, 32)."""
    x1, x2, hps = _k3_inputs(np.random.default_rng(21), n1, n2, D, dtype,
                             cuda_device)
    before = HK.dense_covariance.launches
    got = HK.dense_covariance(x1, x2, hps, kind=kind)
    assert HK.dense_covariance.launches == before + 1
    ref = HK.dense_covariance_reference(x1, x2, hps, kind=kind)
    assert got.shape == (n1, n2) and got.dtype == dtype
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=_K3_TOL[dtype] * float(hps[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["matern32", "wendland"])
@pytest.mark.parametrize("D", [1, 3, 8, 32])
@pytest.mark.parametrize("n", [1, 33, 129, 130, 1000, 1024])
def test_k3_symmetric_route_on_card(cuda_device, n, D, kind, dtype):
    """k(X, X) by the symmetric route (tiles on and above the diagonal,
    mirrored): exactly symmetric, the diagonal exactly the signal variance,
    and bit for bit the full route's result — whichever of the two the
    wrapper picks for one tensor, a view of it, or a copy of it."""
    x, _, hps = _k3_inputs(np.random.default_rng(22), n, 1, D, dtype,
                           cuda_device)
    sym = HK._launch_dense_covariance(x, x, hps, kind, True)
    full = HK._launch_dense_covariance(x, x, hps, kind, False)
    assert torch.equal(sym, full)
    for x2 in (x, x[:], x.clone()):
        assert torch.equal(sym, HK.dense_covariance(x, x2, hps, kind=kind))
    assert torch.equal(sym, sym.T)
    assert torch.all(torch.diagonal(sym) == hps[0])
    ref = HK.dense_covariance_reference(x, x, hps, kind=kind)
    torch.testing.assert_close(sym, ref, rtol=0,
                               atol=_K3_TOL[dtype] * float(hps[0]))


@pytest.mark.cuda
def test_k3_takes_non_contiguous_inputs_and_host_hyperparameters(cuda_device):
    rng = np.random.default_rng(23)
    wide = torch.as_tensor(rng.uniform(0, 4, (200, 6))).to(cuda_device)
    x = wide[:, ::2]                                 # strided columns
    hps = np.array([0.9, 1.5, 2.0, 2.5])
    got = HK.dense_covariance(x, x, hps)
    ref = HK.dense_covariance_reference(x.contiguous(), x.contiguous(), hps)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-12)
    assert torch.equal(got, got.T)
    with pytest.raises(ValueError, match="lengthscales"):
        HK.dense_covariance(x, x, hps[:3])


def _k4_case(rng, nb, B, dtype, device):
    """Row-sorted tiles with an empty row block (2) and three unclamped
    sentinels (row == col == nb, zero tiles) at the tail."""
    rows = np.sort(rng.integers(0, nb, 30)).astype(np.int32)
    rows[rows == 2] = 3
    cols = rng.integers(0, nb, 30).astype(np.int32)
    rows = np.concatenate([rows, [nb] * 3]).astype(np.int32)
    cols = np.concatenate([cols, [nb] * 3]).astype(np.int32)
    tiles = rng.standard_normal((33, B, B))
    tiles[-3:] = 0.0
    t = torch.as_tensor(tiles, dtype=dtype).to(device)
    return rows, cols, t


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ["full-k16", "full-k17", "ragged-k16",
                                   "ragged-k17", "ragged-1d", "full-1d",
                                   "short-n"])
def test_k4_launch_path_on_card(cuda_device, dtype, shape):
    """K4's own launch path: X with nb·B rows and k % 8 == 0 (no copy at
    all), a k that needs the column padding, an X that ends inside its last
    block (read as zero past its end, the output cut there), 1-D X, and
    ``n`` shorter than X."""
    rng = np.random.default_rng(31)
    nb, B = 6, 64
    rows, cols, t = _k4_case(rng, nb, B, dtype, cuda_device)
    r, c = (torch.as_tensor(a).to(cuda_device) for a in (rows, cols))
    n_x = nb * B if shape.startswith("full") else nb * B - 45
    k = {"k16": 16, "k17": 17, "1d": None, "n": 5}[shape.split("-")[1]]
    X = rng.standard_normal(n_x if k is None else (n_x, k))
    x = torch.as_tensor(X, dtype=dtype).to(cuda_device)
    n = n_x - 70 if shape == "short-n" else None
    before = HK.block_spmv.launches
    got = HK.block_spmv(r, c, t, x, nb, B, n=n)
    assert HK.block_spmv.launches == before + 1
    ref = HK.block_spmv_reference(r, c, t, x, nb, B, n=n)
    assert got.shape == ref.shape and got.dtype == dtype
    _close_to_plain(got, ref, 1e-4 if dtype == torch.float32 else 1e-2)
    assert torch.all(got[2 * B:3 * B] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("index_type", ["int32 tensor", "int64 tensor",
                                        "numpy", "cpu tensor"])
def test_k4_keeps_its_schedule_on_the_callers_rows_on_card(cuda_device,
                                                           index_type):
    """The row offsets are kept on the caller's rows tensor: a second call
    finds them (no new entry), an in-place write drops them; rows that are
    not a tensor on the card make a new tensor each call and still give the
    right product."""
    rng = np.random.default_rng(32)
    nb, B = 6, 64
    rows, cols, t = _k4_case(rng, nb, B, torch.float32, cuda_device)
    x = torch.as_tensor(rng.standard_normal((nb * B - 9, 17)),
                        dtype=torch.float32).to(cuda_device)
    if index_type == "numpy":
        r, c = rows, cols
    elif index_type == "cpu tensor":
        r, c = torch.as_tensor(rows), torch.as_tensor(cols)
    else:
        dt = torch.int32 if index_type.startswith("int32") else torch.int64
        r, c = (torch.as_tensor(a).to(dt).to(cuda_device)
                for a in (rows, cols))
    ref = HK.block_spmv_reference(r, c, t, x, nb, B)
    got = HK.block_spmv(r, c, t, x, nb, B)
    _close_to_plain(got, ref)
    if index_type.endswith("tensor") and index_type != "cpu tensor":
        kept = r._fvgp_row_segments
        again = HK.block_spmv(r, c, t, x, nb, B)
        assert r._fvgp_row_segments is kept
        assert torch.equal(again, got)
        r[-1] = nb                    # in place, same values: a new version
        HK.block_spmv(r, c, t, x, nb, B)
        assert r._fvgp_row_segments is not kept
    else:
        assert not hasattr(r, "_fvgp_row_segments")
        assert torch.equal(HK.block_spmv(r, c, t, x, nb, B), got)


@pytest.mark.cuda
def test_k4_skips_a_sentinel_rows_tile_on_card(cuda_device):
    """A sentinel row's tile is skipped, not multiplied: a non-finite value
    in X's last block stays out of the last row block (the plain version,
    like the JAX wrapper, clamps and multiplies: 0 * inf)."""
    rng = np.random.default_rng(33)
    nb, B = 6, 64
    rows, cols, t = _k4_case(rng, nb, B, torch.float32, cuda_device)
    cols[:30] = np.minimum(cols[:30], nb - 2)    # no live tile reads block 5
    r, c = (torch.as_tensor(a).to(cuda_device) for a in (rows, cols))
    X = rng.standard_normal((nb * B, 8))
    X[-1, 0] = np.inf
    x = torch.as_tensor(X, dtype=torch.float32).to(cuda_device)
    got = HK.block_spmv(r, c, t, x, nb, B)
    assert bool(torch.isfinite(got).all())
    ref = HK.block_spmv_reference(r, c, t, x, nb, B)
    assert not bool(torch.isfinite(ref).all())
    x[-1, 0] = 0.0
    _close_to_plain(got, HK.block_spmv_reference(r, c, t, x, nb, B))


# ---------------------------------------------------------------------------
# K1's second caller: BlockSparseMatrix.matmat
# ---------------------------------------------------------------------------

def _symmetric_bsm(rng, n, B, dtype, device, frac=0.5):
    """A symmetric tile set in row-sorted order with zeroed padding, as the
    assembler stores it, plus two sentinel tiles."""
    from fvgp_tpu_torch.parallel.block_sparse import BlockSparseMatrix
    nb = -(-n // B)
    valid = (np.arange(nb * B) < n).reshape(nb, B)
    entries = {}
    for i in range(nb):
        for j in range(i, nb):
            if i != j and rng.uniform() > frac:
                continue
            t = rng.standard_normal((B, B)) * (valid[i][:, None]
                                               * valid[j][None, :])
            entries[(i, j)] = t + t.T if i == j else t
            if i != j:
                entries[(j, i)] = t.T
    keys = sorted(entries)
    rows = np.array([k[0] for k in keys] + [nb, nb], np.int32)
    cols = np.array([k[1] for k in keys] + [nb, nb], np.int32)
    tiles = np.stack([entries[k] for k in keys]
                     + [np.zeros((B, B))] * 2)
    return BlockSparseMatrix(n, n, B, rows, cols,
                             torch.as_tensor(tiles).to(dtype), device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 4, 17, 40])
def test_bsm_matmat_on_k1_matches_plain_on_card(cuda_device, dtype, k):
    """The stored product on the card launches K1 and agrees with the plain
    ``matmat``: 1e-4 of the output scale in float32 (the same products,
    summed in another order).  Under bfloat16 storage X goes in as two
    bfloat16 halves, whose sum keeps 16 mantissa bits of the float32 X
    (2^-17 relative per element, below the float32 summation error), so the
    same 1e-4 holds against the plain product of the SAME stored tiles."""
    from fvgp_tpu_torch.parallel import block_sparse as bs
    rng = np.random.default_rng(21)
    n, B = 5 * 64 - 7, 64
    A = _symmetric_bsm(rng, n, B, dtype, cuda_device)
    v = torch.as_tensor(rng.uniform(0.5, 1.0, n), dtype=torch.float32) \
        .to(cuda_device)
    KV = A.add_diagonal(v)
    X = torch.as_tensor(rng.standard_normal((n, k)),
                        dtype=torch.float32).to(cuda_device)
    before = HK.chunked_spmm.launches
    got = KV.matmat(X)
    assert HK.chunked_spmm.launches == before + 1
    s = A._store
    ref = bs._bsm_matmat_plain(s.rows, s.cols, s.tiles, X, A.nb, B) \
        + v[:, None] * X
    assert got.shape == ref.shape == (n, k) and got.dtype == torch.float32
    _close_to_plain(got, ref)
    # a 1-d X, and the operator convention the solvers use
    before = HK.chunked_spmm.launches
    x1 = KV @ X[:, 0]
    mv = bs.bsm_matvec_factory(KV.nb, B, n, True)
    assert HK.chunked_spmm.launches == before + 1 and x1.shape == (n,)
    _close_to_plain(mv(KV, X), ref)
    _close_to_plain(x1, ref[:, 0])
    # the rows tensor is the same object: its row offsets are kept
    assert getattr(KV.rows, "_fvgp_row_segments", None) is not None
    assert KV.rows is A.rows


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_matmat_on_k1_is_one_launch_on_card(cuda_device, dtype,
                                                 monkeypatch):
    """The plain product's per-tile memory bound does not split a wide X on
    the kernel route (every launch streams the whole tile set): 64 columns
    are one K1 launch where ``_col_chunk`` allows one column a pass; only
    the (n, c) arrays' own size bounds a pass."""
    from fvgp_tpu_torch.parallel import block_sparse as bs
    rng = np.random.default_rng(24)
    n, B, k = 5 * 64 - 7, 64, 64
    A = _symmetric_bsm(rng, n, B, dtype, cuda_device, frac=1.0)
    X = torch.as_tensor(rng.standard_normal((n, k)),
                        dtype=torch.float32).to(cuda_device)
    s = A._store
    ref = bs._bsm_matmat_plain(s.rows, s.cols, s.tiles, X, A.nb, B)
    monkeypatch.setattr(bs, "_MATMAT_BUDGET", 8 * n * 4 * k)
    assert A._col_chunk(k, 4) < k
    assert A.square_col_chunk(k, torch.float32) == k
    assert A.square_col_chunk(k, torch.float64) == A._col_chunk(k, 8)
    before = HK.chunked_spmm.launches
    got = A.matmat(X)
    assert HK.chunked_spmm.launches == before + 1
    _close_to_plain(got, ref)
    monkeypatch.setattr(bs, "_MATMAT_BUDGET", 8 * n * 4 * 16)
    before = HK.chunked_spmm.launches
    _close_to_plain(A.matmat(X), ref)
    assert HK.chunked_spmm.launches == before + 4


@pytest.mark.cuda
def test_unsorted_merge_result_is_sorted_not_refused_on_card(cuda_device):
    from fvgp_tpu_torch.parallel import block_sparse as bs
    rng = np.random.default_rng(22)
    n, B = 4 * 64, 64
    A = _symmetric_bsm(rng, n, B, torch.float32, cuda_device)
    M = bs.merge(A, A)
    assert not np.all(np.diff(M._store.rows_h) >= 0)
    X = torch.as_tensor(rng.standard_normal((n, 3)),
                        dtype=torch.float32).to(cuda_device)
    before = HK.chunked_spmm.launches
    got = M.matmat(X)
    assert HK.chunked_spmm.launches == before + 1
    assert bool((M.rows[1:] >= M.rows[:-1]).all())
    _close_to_plain(got, 2.0 * A.matmat(X))
    _close_to_plain(got, M.to_dense() @ X)


@pytest.mark.cuda
def test_float64_and_rectangular_products_take_the_plain_path(cuda_device):
    from fvgp_tpu_torch.parallel.block_sparse import BlockSparseMatrix
    rng = np.random.default_rng(23)
    n, B = 3 * 64, 64
    A = _symmetric_bsm(rng, n, B, torch.float64, cuda_device)
    X = torch.as_tensor(rng.standard_normal((n, 2))).to(cuda_device)
    before = HK.chunked_spmm.launches
    got = A.matmat(X)
    A32 = _symmetric_bsm(np.random.default_rng(23), n, B, torch.float32,
                         cuda_device)
    got64 = A32.matmat(X)                 # a float64 X keeps float64
    R = BlockSparseMatrix(2 * B, B, B, np.array([0, 1]), np.array([0, 0]),
                          torch.as_tensor(rng.standard_normal((2, B, B)),
                                          dtype=torch.float32),
                          device=cuda_device)
    Xr = torch.as_tensor(rng.standard_normal((B, 2)),
                         dtype=torch.float32).to(cuda_device)
    rect, back = R.matmat(Xr), R.rmatmat(R.matmat(Xr))
    assert HK.chunked_spmm.launches == before
    assert got.dtype == got64.dtype == torch.float64
    torch.testing.assert_close(got, A.to_dense() @ X, rtol=0, atol=1e-10)
    torch.testing.assert_close(got64, A32.to_dense().double() @ X, rtol=0,
                               atol=1e-10)
    _close_to_plain(rect, R.to_dense() @ Xr)
    _close_to_plain(back, R.to_dense().T @ rect)


@pytest.mark.cuda
def test_stored_k_solve_and_logdet_on_card_match_the_cpu(cuda_device):
    """The stored-K trial LML on the card (float32, and bfloat16 storage)
    against the CPU in float64, through the public GP: the exact quadratic
    term within the float32 bound, K1 launched by the CG and the SLQ."""
    import warnings

    from fvgp_tpu_torch import GP
    rng = np.random.default_rng(24)
    n = 1500
    x = rng.uniform(0, 25, (n, 3))
    y = np.sin(0.5 * x[:, 0]) + 0.05 * rng.standard_normal(n)
    hps = np.array([1.0, 2.0, 2.0, 2.0])
    out = {}
    for name, dev, extra in (
            ("cpu", "cpu", {}), ("f32", "cuda", {}),
            ("bf16", "cuda", {"gp2Scale_storage_dtype": "bfloat16"})):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            gp = GP(x, y, init_hyperparameters=hps,
                    noise_variances=np.full(n, 1e-2), gp2Scale=True,
                    compute_device=dev, linalg_mode="sparseCGpre",
                    args={"gp2Scale_block_size": 64,
                          "gp2Scale_traced_lml": False,
                          "sparse_cg_tol": 1e-6, **extra})
            before = HK.chunked_spmm.launches
            KV = gp.kv.addKV(gp.K, gp.V)
            sol = gp.kv.compute_new_KVinvY(KV, gp.m)
            quad = float(torch.sum(gp.kv._y_minus(gp.m) * sol))
            logdet = gp.kv._random_logdet(KV)
            out[name] = (quad, logdet, gp.kv.last_logdet_variance,
                         HK.chunked_spmm.launches - before)
    assert out["cpu"][3] == 0 and out["f32"][3] > 20 and out["bf16"][3] > 20
    for name, rtol in (("f32", 1e-4), ("bf16", 5e-3)):
        assert abs(out[name][0] - out["cpu"][0]) \
            <= rtol * abs(out["cpu"][0]), (name, out)
        sd = np.sqrt(out[name][2] + out["cpu"][2])
        # the same probes on both devices: well inside the estimator's noise
        assert abs(out[name][1] - out["cpu"][1]) <= sd, (name, out)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,extra", [
    ("sparseMINRESpre_ichol", {}), ("sparseCGpre_amg", {}),
    ("sparseMINRES", {}), ("sparseLU", {}),
    ("sparseSolve", {"sparse_direct_dense_cutoff": 0})])
def test_stored_k_modes_on_card_match_the_cpu(cuda_device, mode, extra):
    """Every stored-operator solver and preconditioner on the card against
    the CPU in float64, through the public GP: the trial solve, the full
    posterior covariance over the block-sparse cross path, and an aligned
    append (float32 bound 1e-3 of each quantity's scale)."""
    import warnings

    from fvgp_tpu_torch import GP
    rng = np.random.default_rng(25)
    n, n_new = 1280, 64
    x = rng.uniform(0, 24, (n + n_new, 3))
    y = np.sin(0.5 * x[:, 0]) + 0.05 * rng.standard_normal(n + n_new)
    xp = rng.uniform(0, 24, (12, 3))
    hps = np.array([1.0, 2.0, 2.0, 2.0])
    out = {}
    for dev in ("cpu", "cuda"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            gp = GP(x[:n], y[:n], init_hyperparameters=hps,
                    noise_variances=np.full(n, 1e-2), gp2Scale=True,
                    compute_device=dev, linalg_mode=mode,
                    gp2Scale_batch_size=64,
                    args={"gp2Scale_traced_lml": False,
                          "sparse_cg_tol": 1e-6, "sparse_minres_tol": 1e-6,
                          "gp2Scale_dense_cross_budget": 1, **extra})
            KV = gp.kv.addKV(gp.K, gp.V)
            sol = gp.kv.compute_new_KVinvY(KV, gp.m)
            quad = float(torch.sum(gp.kv._y_minus(gp.m) * sol))
            S = gp.posterior_covariance(xp)["S"]
            gp.update_gp_data(x[n:], y[n:], append=True,
                              noise_variances_new=np.full(n_new, 1e-2))
            rows = gp.K.matmat(torch.ones(n + n_new, dtype=gp.prior.dtype,
                                          device=gp.device))
            out[dev] = (quad, S, rows.double().cpu().numpy())
    ref, got = out["cpu"], out["cuda"]
    assert abs(got[0] - ref[0]) <= 1e-3 * abs(ref[0])
    np.testing.assert_allclose(got[1], ref[1], atol=1e-3)
    np.testing.assert_allclose(got[2], ref[2], atol=1e-3 * ref[2].max())


def _slice_case(device, N=1000, B=32, seed=6):
    """A mirrored, row-sorted covariance schedule (sentinel tail) with its
    padded inputs, for the gp2Scale solver options on the card."""
    from fvgp_tpu_torch.parallel.ordering import morton_order
    from fvgp_tpu_torch.parallel.sharded_cov import _candidate_pairs
    from fvgp_tpu_torch.ops.sparse_lml import make_padded_inputs
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 16, (N, 2))
    x = x[morton_order(x)]
    y = np.sin(x[:, 0])
    hps = np.array([1.0, 2.0, 2.0])
    rows, cols = _candidate_pairs(x, None, hps[1:], 1.0, B, symmetric=True)
    off = rows < cols
    nb = -(-N // B)
    rows_f = np.concatenate([rows, cols[off]])
    cols_f = np.concatenate([cols, rows[off]])
    order = np.argsort(rows_f, kind="stable")
    rows_f = np.concatenate([rows_f[order], np.full(7, nb)]).astype(np.int32)
    cols_f = np.concatenate([cols_f[order], np.full(7, nb)]).astype(np.int32)
    Z = rng.choice([-1.0, 1.0], size=(nb * B, 16))
    Z[N:] = 0.0
    inputs = {}
    for dt in (torch.float32, torch.float64):
        inputs[dt] = make_padded_inputs(x, y, np.full(N, 1e-2), B, dtype=dt,
                                        device=device)
    return hps, nb, B, rows_f, cols_f, Z, inputs


@pytest.mark.cuda
@pytest.mark.parametrize("sdt", [None, torch.bfloat16])
def test_slq_lml_gradient_on_k1_matches_the_plain_route(cuda_device, sdt):
    """``make_sparse_lml(solver="slq")`` on the card (K1 in every CG trip,
    Lanczos step and symmetric backward) against the same float32 program
    on the CPU, where ``chunked_spmm`` takes its plain version.  float32:
    the sums' order alone.  bf16 streaming: the iterates are cast to bf16
    before every product, so where the two float32 sums differ in their
    last bit a cast may round the other way (one bf16 ulp, 2^-8)."""
    from fvgp_tpu_torch.kernels import wendland_anisotropic
    from fvgp_tpu_torch.ops.sparse_lml import make_sparse_lml
    out = {}
    for dev in ("cpu", cuda_device):
        hps, nb, B, rows, cols, Z, inputs = _slice_case(dev)
        lml = make_sparse_lml(wendland_anisotropic, nb, B, cg_iters=200,
                              slq_degree=20, solver="slq", solver_dtype=sdt)
        h = torch.tensor(hps, dtype=torch.float32, device=dev,
                         requires_grad=True)
        before = HK.chunked_spmm.launches
        v = lml(h, torch.as_tensor(rows).to(dev),
                torch.as_tensor(cols).to(dev), *inputs[torch.float32],
                torch.as_tensor(Z, dtype=torch.float32).to(dev))
        g, = torch.autograd.grad(v, h)
        out[str(dev)] = (float(v.detach()), g.double().cpu().numpy(),
                         HK.chunked_spmm.launches - before)
    (vc, gc, nc), (vg, gg, ng) = out["cpu"], out[str(cuda_device)]
    assert nc == 0 and ng > 40        # CG fwd + bwd, 20 steps + 20 bwd
    lml_tol, grad_tol = (1e-5, 1e-4) if sdt is None else (1e-3, 1e-2)
    assert abs(vg - vc) <= lml_tol * abs(vc)
    assert np.linalg.norm(gg - gc) <= grad_tol * np.linalg.norm(gc)


@pytest.mark.cuda
def test_symmetric_route_on_k1_matches_general_vjp_on_card(cuda_device):
    """The SLQ step's backward ``Aᵀ Ȳ = A Ȳ`` (one K1 launch) against the
    general VJP's plain transposed scatter, on a mirrored schedule."""
    from fvgp_tpu_torch.kernels import wendland_anisotropic
    from fvgp_tpu_torch.ops.sparse_lml import (_assemble_chunked_tiles,
                                               _SymmetricSpmm)
    hps, nb, B, rows, cols, _, inputs = _slice_case(cuda_device)
    r = torch.as_tensor(rows).to(cuda_device)
    cc = torch.as_tensor(cols).to(cuda_device).clamp(max=nb - 1)
    xb, mask = inputs[torch.float32][:2]
    with torch.no_grad():
        tiles = _assemble_chunked_tiles(
            wendland_anisotropic, B, None,
            torch.tensor(hps, dtype=torch.float32, device=cuda_device),
            r.clamp(max=nb - 1), cc, r < nb, xb, mask)
    gen = torch.Generator().manual_seed(2)
    X = torch.randn((nb * B, 16), generator=gen).to(cuda_device)
    Ybar = torch.randn((nb * B, 16), generator=gen).to(cuda_device)
    Xr = X.clone().requires_grad_(True)
    Y = _SymmetricSpmm.apply(tiles, Xr, r, cc, nb, B, None)
    before = HK.chunked_spmm.launches
    g, = torch.autograd.grad(Y, Xr, grad_outputs=Ybar)
    assert HK.chunked_spmm.launches == before + 1
    _, ref = HK.chunked_spmm_vjp(r, cc, tiles, X, Ybar, nb, B, need_x=True)
    torch.testing.assert_close(g, ref, rtol=0,
                               atol=1e-4 * float(ref.abs().max()))


@pytest.mark.cuda
def test_two_level_committed_solve_on_k2_matches_the_plain_scan(cuda_device):
    """The two-level committed solve with the fused K2 SpMM on the card
    against the same solve on the CPU, where ``row_chunk_sums`` takes its
    plain version: float32 both, the same schedule and coarse grid."""
    from fvgp_tpu_torch.kernels import wendland_anisotropic
    from fvgp_tpu_torch.ops.sparse_lml import make_committed_solver
    hps, nb, B, rows, cols, _, _ = _slice_case(cuda_device)
    live = rows < nb
    rows_p, cols_p, rowsc, _ = HK.row_aligned_schedule(rows[live],
                                                       cols[live], nb, C=8)
    rng = np.random.default_rng(3)
    RHS = rng.standard_normal((nb * B, 24))
    RHS[1000:] = 0.0
    out = {}
    for dev in ("cpu", cuda_device):
        inputs = _slice_case(dev)[-1]
        xb, mask, _, _, noise = inputs[torch.float32]
        assemble, solve = make_committed_solver(
            wendland_anisotropic, nb, B, cg_iters=300, cg_tol=1e-5,
            row_chunk=8, precond_type="two_level", coarse_width=3)
        t = lambda a: torch.as_tensor(a).to(dev)              # noqa: E731
        tiles, pdata = assemble(t(hps).float(), t(rows_p), t(cols_p), xb,
                                mask, noise)
        before = HK.row_chunk_sums.launches
        X, it = solve(tiles, pdata, t(rowsc), t(cols_p), noise,
                      t(RHS).float())
        out[str(dev)] = (X.cpu().numpy(), it,
                         HK.row_chunk_sums.launches - before)
    (Xc, itc, nc), (Xg, itg, ng) = out["cpu"], out[str(cuda_device)]
    assert nc == 0 and ng >= itg > 0
    assert abs(itg - itc) <= 2
    np.testing.assert_allclose(Xg, Xc, rtol=0,
                               atol=1e-3 * float(np.abs(Xc).max()))


def _posterior_api_gp(device, **kw):
    """A dense GP of the posterior-API slice (N = 300, D = 3)."""
    from fvgp_tpu_torch import GP
    rng = np.random.default_rng(12)
    x = rng.uniform(0, 4, (300, 3))
    y = np.sin(x[:, 0]) + 0.05 * rng.standard_normal(300)
    return GP(x, y, init_hyperparameters=np.array([1.0, 1.5, 1.5, 1.5]),
              noise_variances=np.full(300, 1e-2), compute_device=device,
              **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_d_kernel_dx_on_card_matches_the_cpu(cuda_device, dtype):
    """The posterior gradients' ∂k/∂x is forward-mode AD through
    ``default_matern_ard``: K3 must refuse the dual input (a launch drops
    the tangent, and ∂k/∂x would come back zero), so the card's value is the
    CPU's and no K3 launch happens."""
    cpu = _posterior_api_gp("cpu")
    gpu = _posterior_api_gp(str(cuda_device), args={"dtype": dtype})
    xp = np.random.default_rng(13).uniform(0, 4, (40, 3))
    ref = cpu.prior.d_kernel_dx(xp, cpu.x_data, 1, cpu.hyperparameters)
    before = HK.dense_covariance.launches
    got = gpu.prior.d_kernel_dx(xp, gpu.x_data, 1, gpu.hyperparameters)
    assert HK.dense_covariance.launches == before
    tol = 1e-5 if dtype == "float32" else 1e-12
    np.testing.assert_allclose(got.cpu().double().numpy(), ref.numpy(),
                               rtol=0, atol=tol * float(ref.abs().max()))
    grad = gpu.posterior_mean_grad(xp)["dm/dx"]
    want = cpu.posterior_mean_grad(xp)["dm/dx"]
    np.testing.assert_allclose(grad, want, rtol=0,
                               atol=1e-3 * float(np.abs(want).max()))


@pytest.mark.cuda
def test_kernel_dtype_float32_runs_k3_on_card(cuda_device):
    """``kernel_dtype="float32"`` under float64 linear algebra: K is
    evaluated by K3 in float32 and held in float64."""
    gp64 = _posterior_api_gp(str(cuda_device), args={"dtype": "float64"})
    before = HK.dense_covariance.launches
    gp32 = _posterior_api_gp(str(cuda_device), args={
        "dtype": "float64", "kernel_dtype": "float32"})
    assert HK.dense_covariance.launches > before
    assert gp32.prior.K.dtype == torch.float64
    diff = float((gp32.prior.K - gp64.prior.K).abs().max())
    assert 0.0 < diff < 1e-5
    assert abs(gp32.log_likelihood() - gp64.log_likelihood()) < 1e-2


@pytest.mark.cuda
def test_custom_linalg_mode_on_card(cuda_device):
    """A custom [factor, solve, logdet] takes tensors on the card and gives
    the Chol mode's LML and posterior."""
    mode = [torch.linalg.cholesky,
            lambda L, b: torch.cholesky_solve(b.reshape(len(L), -1),
                                              L).reshape(b.shape),
            lambda L: 2.0 * torch.sum(torch.log(torch.diagonal(L)))]
    ref = _posterior_api_gp(str(cuda_device), args={"dtype": "float64"})
    gp = _posterior_api_gp(str(cuda_device), args={"dtype": "float64"},
                           linalg_mode=mode)
    xp = np.random.default_rng(14).uniform(0, 4, (20, 3))
    np.testing.assert_allclose(gp.log_likelihood(), ref.log_likelihood(),
                               rtol=1e-10)
    np.testing.assert_allclose(gp.posterior_covariance(xp)["S"],
                               ref.posterior_covariance(xp)["S"], rtol=0,
                               atol=1e-10)


# ---------------------------------------------------------------------------
# the training slice: the batched value-and-gradient, the gp2Scale Adam
# chain and the asynchronous actors on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_batched_value_and_grad_on_card_matches_single_members(cuda_device,
                                                               dtype):
    """Each member of the batched value-and-gradient (one chunk, and again
    one member per chunk) against its own single-member evaluation on the
    card; a member that is not positive definite is NaN alone."""
    gp = _posterior_api_gp(str(cuda_device), args={"dtype": dtype})
    ml = gp.marginal_likelihood
    P = np.array([[1.0, 1.5, 1.5, 1.5], [2.0, 1.0, 2.0, 0.7],
                  [-1.0, 1.5, 1.5, 1.5], [0.5, 3.0, 1.0, 2.0]])
    vals, grads = ml.batched_value_and_grad_device()(P)
    assert vals.device.type == "cuda" and ml._vg_member_bytes[1] > 0
    key = ml._vg_member_bytes[0]
    ml._vg_member_bytes = (key, 1 << 50)             # one member per chunk
    vals1, grads1 = ml.batched_value_and_grad_device()(P)
    tol = 1e-4 if dtype == "float32" else 1e-10
    for v, g in ((vals, grads), (vals1, grads1)):
        v = v.cpu().double().numpy()
        g = g.cpu().double().numpy()
        assert np.isnan(v[2]) and np.isfinite(np.delete(v, 2)).all()
        for i in (0, 1, 3):
            val, grad = ml.log_likelihood_value_and_gradient(P[i])
            np.testing.assert_allclose(-v[i], val, rtol=tol)
            np.testing.assert_allclose(-g[i], grad, rtol=0,
                                       atol=tol * np.abs(grad).max())


@pytest.mark.cuda
def test_sparse_adam_chain_on_card_matches_the_cpu(cuda_device):
    """Four chain steps at the same injected probes, float64 on the card
    against the CPU (1e-8), and float32 on the card launching K1 at every
    step."""
    from fvgp_tpu_torch import GP
    rng = np.random.default_rng(11)
    n = 2000
    x = rng.uniform(0, 18, (n, 3))
    y = np.sin(0.5 * x[:, 0]) + 0.05 * rng.standard_normal(n)
    hps = np.array([1.0, 2.0, 2.0, 2.0])
    bounds = np.array([[0.05, 5.0], [1.9, 2.1], [1.9, 2.1], [1.9, 2.1]])
    Zs = None
    out = {}
    for name, device, dtype in (("cpu", "cpu", "float64"),
                                ("f64", str(cuda_device), "float64"),
                                ("f32", str(cuda_device), "float32")):
        gp = GP(x, y, init_hyperparameters=hps,
                noise_variances=np.full(n, 1e-2), gp2Scale=True,
                compute_device=device,
                args={"gp2Scale_block_size": 64, "dtype": dtype,
                      "random_logdet_fixed_probes": 8,
                      "gp2Scale_structure_cache_dir": False})
        ml = gp.marginal_likelihood
        ml.log_likelihood_value_and_gradient(hps)
        if Zs is None:
            n_pad = next(iter(ml._sparse_cache.values()))["xb"].shape[0] * 64
            probes = np.random.default_rng(4)
            Zs = [probes.choice([-1.0, 1.0], (n_pad, 8)) for _ in range(4)]
        before = HK.chunked_spmm.launches
        out[name] = ml.sparse_adam_steps(hps, np.zeros(4), np.zeros(4), 0, 4,
                                         bounds=bounds,
                                         probe_source=lambda s: Zs[s])
        if name == "f32":
            assert HK.chunked_spmm.launches - before >= 4
    np.testing.assert_allclose(out["f64"][0], out["cpu"][0], rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(out["f64"][3], out["cpu"][3], rtol=1e-8)
    np.testing.assert_allclose(out["f32"][0], out["cpu"][0], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(out["f32"][3], out["cpu"][3], rtol=1e-4)


@pytest.mark.cuda
def test_k3_launches_from_an_actor_thread(cuda_device):
    """Grad mode is thread-local: an asynchronous mcmc's value-only LMLs,
    evaluated in the actor thread, still reach K3 — one launch each."""
    import threading
    gp = _posterior_api_gp(str(cuda_device))
    bounds = np.array([[0.1, 10.0]] + [[0.5, 5.0]] * 3)
    ml = gp.marginal_likelihood
    threads = []
    lml = ml.log_likelihood
    ml.log_likelihood = lambda h=None: threads.append(
        threading.current_thread()) or lml(h)
    before = HK.dense_covariance.launches
    opt = gp.train(hyperparameter_bounds=bounds, method="mcmc", max_iter=30,
                   asynchronous=True)
    opt.actor.join(timeout=120)
    assert opt.is_done() and "error" not in opt.actor.get_latest()
    assert len(threads) >= 5
    assert threading.main_thread() not in threads
    assert HK.dense_covariance.launches - before == len(threads)
    hps = gp.update_hyperparameters(opt)
    assert np.all(np.isfinite(hps))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_torch_func_transforms_of_the_default_kernel_take_the_plain_formula(
        cuda_device, dtype):
    """``torch.func.vmap`` hands the kernel a ``BatchedTensor`` (2-D, no
    grad, no tangent) and ``jacrev`` a grad-tracking wrapper: K3 reads raw
    pointers, so the gate refuses both, and each transform equals the plain
    formula's result with no K3 launch."""
    from fvgp_tpu_torch.kernels import (default_matern_ard,
                                        get_anisotropic_distance_matrix,
                                        matern_kernel_diff1)

    def plain(x1, x2, h):
        return h[0] * matern_kernel_diff1(
            get_anisotropic_distance_matrix(x1, x2, h[1:]), 1.0)

    rng = np.random.default_rng(21)
    x = torch.as_tensor(rng.uniform(0, 3, (6, 40, 3)), dtype=dtype,
                        device=cuda_device)
    xq = torch.as_tensor(rng.uniform(0, 3, (25, 3)), dtype=dtype,
                         device=cuda_device)
    h = torch.as_tensor([1.3, 0.8, 1.1, 1.6], dtype=dtype,
                        device=cuda_device)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    before = HK.dense_covariance.launches
    got = torch.func.vmap(lambda xi: default_matern_ard(xi, xq, h))(x)
    want = torch.stack([plain(xi, xq, h) for xi in x])
    torch.testing.assert_close(got, want, rtol=0, atol=tol)
    jac = torch.func.jacrev(lambda hh: default_matern_ard(x[0], xq, hh))(h)
    want_jac = torch.func.jacrev(lambda hh: plain(x[0], xq, hh))(h)
    torch.testing.assert_close(jac, want_jac, rtol=0, atol=tol)
    assert HK.dense_covariance.launches == before
    # the same call outside any transform still launches K3
    torch.testing.assert_close(default_matern_ard(x[0], xq, h),
                               plain(x[0], xq, h), rtol=0, atol=tol)
    assert HK.dense_covariance.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("D,hps", [(1, [1.3, 2.0, 1.7]), (3, [1.3, 0.8])])
def test_default_kernel_on_k3_follows_the_formulas_broadcast(cuda_device, D,
                                                             hps):
    """Trailing entries beyond D lengthscales (GGMP's constant mean on one
    input dimension) and one shared lengthscale: K3 launches with the
    broadcast's lengthscales and equals the plain formula."""
    from fvgp_tpu_torch.kernels import (default_matern_ard,
                                        get_anisotropic_distance_matrix,
                                        matern_kernel_diff1)
    rng = np.random.default_rng(22)
    x1 = torch.as_tensor(rng.uniform(0, 5, (300, D)), device=cuda_device)
    x2 = torch.as_tensor(rng.uniform(0, 5, (120, D)), device=cuda_device)
    h = torch.as_tensor(hps, dtype=torch.float64, device=cuda_device)
    want = h[0] * matern_kernel_diff1(
        get_anisotropic_distance_matrix(x1, x2, h[1:]), 1.0)
    before = HK.dense_covariance.launches
    got = default_matern_ard(x1, x2, h)
    assert HK.dense_covariance.launches == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
