"""K5 (``hopper_kernels.tile_covariance`` and ``tile_covariance_vjp``)
against their plain PyTorch versions on a CUDA card, on an N = 50,000
gp2Scale structure at D = 3 and on random block pairs at D = 1, 4 and 8
(``cuda`` marker; every test skips without a card).
Imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tile_covariance_cuda.py
"""

import numpy as np
import pytest
import torch

from fvgp_tpu_torch.kernels import wendland_anisotropic
from fvgp_tpu_torch.ops import hopper_kernels as HK
from fvgp_tpu_torch.ops import sparse_lml as SL

N, B = 50_000, 128
HPS = {"1+D": [1.3, 2.0, 1.8, 2.2], "2": [0.8, 2.0]}
TILES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def structure(card):
    """The training structure of a gp2Scale GP at N = 50,000 (about 40
    support neighbours a point at lengthscale 2, Morton order, every tile
    and its mirror, row-sorted, bucket padding of sentinel tiles) on the
    card: (xb, mask, clamped rows, clamped cols, live)."""
    from fvgp_tpu_torch.parallel.ordering import morton_order
    from fvgp_tpu_torch.parallel.sharded_cov import _bucket, _candidate_pairs
    rng = np.random.default_rng(0)
    x = rng.uniform(0, (N * 4.19 / 40.0) ** (1.0 / 3.0) * 2.0, (N, 3))
    x = x[morton_order(x)]
    rows, cols = _candidate_pairs(x, None, np.full(3, 2.2), 1.0, B,
                                  symmetric=True)
    off = rows < cols
    rows_f = np.concatenate([rows, cols[off]]).astype(np.int32)
    cols_f = np.concatenate([cols, rows[off]]).astype(np.int32)
    order = np.argsort(rows_f, kind="stable")
    nb = -(-N // B)
    rows_p = np.full(_bucket(len(rows_f)), nb, np.int32)
    cols_p = np.full(len(rows_p), nb, np.int32)
    rows_p[:len(order)] = rows_f[order]
    cols_p[:len(order)] = cols_f[order]
    xb, mask, _, _, _ = SL.make_padded_inputs(
        x, np.zeros(N), np.ones(N), B, dtype=torch.float32, device=card)
    r = torch.as_tensor(rows_p).to(card)
    c = torch.as_tensor(cols_p).to(card)
    return xb, mask, r.clamp(max=nb - 1), c.clamp(max=nb - 1), r < nb


def _hps(name, card):
    return torch.tensor(HPS[name], dtype=torch.float32, device=card)


@pytest.mark.cuda
@pytest.mark.parametrize("hps", list(HPS))
@pytest.mark.parametrize("tiles", list(TILES))
def test_k5_forward_matches_plain_on_card(card, structure, tiles, hps):
    """One launch; float32 values within a few float32 roundings of the
    signal variance (the plain version takes IEEE sqrt, the kernel the
    hardware's rsqrt, and sums the squares with fma); bfloat16 values the
    same float32 values rounded, so at most one bfloat16 step apart."""
    xb, mask, rows, cols, live = structure
    h = _hps(hps, card)
    assert bool((~live).any()) and bool(live.any())
    before = HK.tile_covariance.launches
    got = HK.tile_covariance(xb, mask, rows, cols, live, h, TILES[tiles])
    torch.cuda.synchronize()
    assert HK.tile_covariance.launches == before + 1
    assert got.dtype == TILES[tiles] and got.shape == (len(rows), B, B)
    ref = HK.tile_covariance_reference(xb, mask, rows, cols, live, h,
                                       TILES[tiles])
    var = float(h[0])
    rtol = 0.0 if tiles == "float32" else 2.0 ** -7
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol,
                               atol=1e-5 * var)
    assert not bool(got[~live].any())


@pytest.mark.cuda
@pytest.mark.parametrize("hps", list(HPS))
@pytest.mark.parametrize("tiles", list(TILES))
def test_k5_vjp_matches_plain_on_card(card, structure, tiles, hps):
    """One launch; the hyperparameter cotangent within 1e-4 of the plain
    version's norm: both sum float32 products, in another order, then
    the tiles' sums in float64."""
    xb, mask, rows, cols, live = structure
    h = _hps(hps, card)
    gen = torch.Generator(device=card).manual_seed(1)
    tiles_bar = torch.randn((len(rows), B, B), generator=gen, device=card,
                            dtype=torch.float32).to(TILES[tiles])
    before = HK.tile_covariance_vjp.launches
    got = HK.tile_covariance_vjp(xb, mask, rows, cols, live, h, tiles_bar)
    torch.cuda.synchronize()
    assert HK.tile_covariance_vjp.launches == before + 1
    assert got.dtype == h.dtype and got.shape == h.shape
    ref = HK.tile_covariance_vjp_reference(xb, mask, rows, cols, live, h,
                                           tiles_bar)
    err = float(torch.linalg.norm((got - ref).double()))
    assert err <= 1e-4 * float(torch.linalg.norm(ref.double()))


@pytest.mark.cuda
@pytest.mark.parametrize("tiles", list(TILES))
def test_sparse_lml_assembly_takes_k5_on_card(card, structure, tiles):
    """The assembly of ``ops/sparse_lml`` with the library's Wendland
    object: one forward and one VJP launch, and the gradient of a tile
    functional within 1e-4 of autograd through the generic chunked path on
    the card (itself plain torch)."""
    xb, mask, rows, cols, live = structure
    h0 = _hps("1+D", card)
    gen = torch.Generator(device=card).manual_seed(2)
    weights = torch.randn((len(rows), B, B), generator=gen, device=card)
    weights = weights.to(TILES[tiles])

    def grad(assemble):
        h = h0.clone().requires_grad_(True)
        g, = torch.autograd.grad(assemble(h), h, grad_outputs=weights)
        return g.double()

    before = (HK.tile_covariance.launches, HK.tile_covariance_vjp.launches)
    got = grad(lambda h: SL._assemble_chunked_tiles(
        wendland_anisotropic, B, TILES[tiles], h, rows, cols, live, xb,
        mask))
    assert (HK.tile_covariance.launches, HK.tile_covariance_vjp.launches) \
        == (before[0] + 1, before[1] + 1)
    ref = grad(lambda h: SL._AssembleTiles.apply(
        h, wendland_anisotropic, B, TILES[tiles], rows, cols, live, xb,
        mask))
    assert float(torch.linalg.norm(got - ref)) \
        <= 1e-4 * float(torch.linalg.norm(ref))


def _blocks_of_dim(D, card, nb=24, T=600):
    """Point blocks of dimension D on the card, whitened distances of
    about 0-2 (so pairs inside and past the support), some padding rows,
    T tiles of random block pairs: every diagonal block, then random
    ones, every fifth dead: (xb, mask, rows, cols, live)."""
    gen = torch.Generator().manual_seed(D)
    xb = torch.rand((nb, B, D), generator=gen) * (2.0 / D ** 0.5)
    xb += torch.arange(nb, dtype=torch.float32)[:, None, None] \
        * (0.5 / D ** 0.5)
    mask = torch.ones((nb, B))
    mask[-1, B - 37:] = 0.0
    rows = torch.cat([torch.arange(nb),
                      torch.randint(0, nb, (T - nb,), generator=gen)])
    cols = torch.cat([torch.arange(nb),
                      torch.randint(0, nb, (T - nb,), generator=gen)])
    live = torch.arange(T) % 5 != 4
    return tuple(t.to(card) for t in (xb, mask, rows, cols, live))


@pytest.mark.cuda
@pytest.mark.parametrize("n_ls", ["1+D", "2"])
@pytest.mark.parametrize("tiles", list(TILES))
@pytest.mark.parametrize("D", [1, 4, 8])
def test_k5_other_dimensions_match_plain_on_card(card, D, tiles, n_ls):
    """D other than the configuration's 3 (the kernel's run-time-D body):
    the forward and the VJP, one launch each, against their plain
    versions at the bounds of the D = 3 tests above."""
    xb, mask, rows, cols, live = _blocks_of_dim(D, card)
    h = torch.tensor([1.3] + ([2.0] if n_ls == "2" else
                              list(np.linspace(1.6, 2.4, D))),
                     dtype=torch.float32, device=card)
    before = (HK.tile_covariance.launches, HK.tile_covariance_vjp.launches)
    got = HK.tile_covariance(xb, mask, rows, cols, live, h, TILES[tiles])
    ref = HK.tile_covariance_reference(xb, mask, rows, cols, live, h,
                                       TILES[tiles])
    rtol = 0.0 if tiles == "float32" else 2.0 ** -7
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol,
                               atol=1e-5 * float(h[0]))
    assert not bool(got[~live].any())
    assert bool((ref.float() == 0.0)[live].any()) \
        and bool((ref.float() > 0.5 * float(h[0]))[live].any())
    gen = torch.Generator(device=card).manual_seed(D)
    tiles_bar = torch.randn(got.shape, generator=gen, device=card,
                            dtype=torch.float32).to(TILES[tiles])
    g = HK.tile_covariance_vjp(xb, mask, rows, cols, live, h, tiles_bar)
    g_ref = HK.tile_covariance_vjp_reference(xb, mask, rows, cols, live, h,
                                             tiles_bar)
    torch.cuda.synchronize()
    assert (HK.tile_covariance.launches, HK.tile_covariance_vjp.launches) \
        == (before[0] + 1, before[1] + 1)
    assert g.shape == h.shape
    assert float(torch.linalg.norm((g - g_ref).double())) \
        <= 1e-4 * float(torch.linalg.norm(g_ref.double()))


@pytest.mark.cuda
def test_k5_refuses_what_it_does_not_take(card, structure):
    """Float64 points on the card are not the kernel's: a raise, never the
    plain version."""
    xb, mask, rows, cols, live = structure
    h = _hps("1+D", card)
    with pytest.raises(TypeError):
        HK.tile_covariance(xb.double(), mask.double(), rows, cols, live,
                           h.double(), torch.float64)
    assert not HK.tile_covariance_takes(xb.double(), h.double(),
                                        torch.float32)
