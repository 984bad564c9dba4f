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
