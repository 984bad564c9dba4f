"""K5, the gp2Scale tile assembly of the library's anisotropic Wendland
kernel, on the CPU: its plain versions (``hopper_kernels.tile_covariance``
and ``tile_covariance_vjp``, which CPU tensors take) against the generic
chunked autograd path of ``ops/sparse_lml``, the routing between the two,
and a gp2Scale LML and gradient through the facade on either route.  The
kernels themselves are held against these plain versions on the card in
``tests/test_torch_tile_covariance_cuda.py``."""

import warnings

import numpy as np
import pytest
import torch

from fvgp_tpu_torch import GP
from fvgp_tpu_torch import kernels as K
from fvgp_tpu_torch.ops import hopper_kernels as HK
from fvgp_tpu_torch.ops import sparse_lml as SL


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (see
    ``tests/test_torch_gp2scale.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


NB, B, D = 6, 16, 3


def _case(dtype=torch.float64):
    """Point blocks in a box a little wider than the support (distances
    from 0 on the diagonal tiles to past 1), the last block's rows past 11
    padding (mask 0), and a schedule with diagonal, off-diagonal and dead
    tiles."""
    gen = torch.Generator().manual_seed(7)
    xb = (torch.rand((NB, B, D), generator=gen, dtype=torch.float64) * 4.0)
    xb[-1, 11:] = 0.0
    mask = torch.ones((NB, B), dtype=torch.float64)
    mask[-1, 11:] = 0.0
    rows = torch.tensor([0, 0, 1, 1, 2, 3, 4, 5, 5, 5, 2, 3])
    cols = torch.tensor([0, 1, 0, 1, 4, 2, 4, 5, 0, 3, 2, 3])
    live = torch.tensor([1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0],
                        dtype=torch.bool)
    return xb.to(dtype), mask.to(dtype), rows, cols, live


HPS = {"1+D": [1.3, 2.0, 1.5, 2.5], "2": [0.7, 1.8]}
OUT = {"float64": torch.float64, "float32": torch.float32,
       "bfloat16": torch.bfloat16}


def test_the_case_spans_the_support():
    """The schedule holds pairs at distance 0 (diagonal tiles), inside the
    support and past it, at both kinds of hyperparameters."""
    xb, _, rows, cols, _ = _case()
    for h in HPS.values():
        ls = torch.tensor(h[1:], dtype=torch.float64)
        d = K._safe_sqrt(K._sq_dist(xb[rows] / ls, xb[cols] / ls))
        assert float(d.min()) == 0.0
        assert bool(((d > 0.1) & (d < 0.9)).any()) and bool((d > 1.0).any())


@pytest.mark.parametrize("out", list(OUT))
@pytest.mark.parametrize("hps", list(HPS))
@pytest.mark.parametrize("points", ["float64", "float32"])
def test_plain_forward_equals_the_chunked_assembly(points, hps, out):
    """Bit for bit the generic chunk of ``_assemble_chunk`` with the
    library's Wendland object: the same operations on the same values."""
    xb, mask, rows, cols, live = _case(OUT[points])
    h = torch.tensor(HPS[hps], dtype=OUT[points])
    got = HK.tile_covariance_reference(xb, mask, rows, cols, live, h,
                                       OUT[out])
    ref = SL._assemble_chunk(K.wendland_anisotropic, h, rows, cols, live, xb,
                             mask, OUT[out])
    assert got.dtype == OUT[out] and torch.equal(got, ref)
    for padded in (got[~live], got[rows == NB - 1][:, 11:, :],
                   got[cols == NB - 1][:, :, 11:]):
        assert padded.numel() and not bool(padded.any())


def _grad(assemble, h, tiles_bar):
    h = h.clone().requires_grad_(True)
    g, = torch.autograd.grad(assemble(h), h, grad_outputs=tiles_bar)
    return g


@pytest.mark.parametrize("out", list(OUT))
@pytest.mark.parametrize("hps", list(HPS))
def test_closed_form_vjp_equals_autograd_through_the_generic_path(hps, out):
    """Float64 points: the K5 route's hyperparameter cotangent against
    autograd through ``_AssembleTiles`` (the chunked recompute), on the
    same cotangent of the tiles (in the tiles' dtype)."""
    xb, mask, rows, cols, live = _case()
    h = torch.tensor(HPS[hps], dtype=torch.float64)
    gen = torch.Generator().manual_seed(3)
    tiles_bar = torch.randn((len(rows), B, B), generator=gen,
                            dtype=torch.float64).to(OUT[out])
    args = (rows, cols, live, xb, mask)
    ref = _grad(lambda p: SL._AssembleTiles.apply(
        p, K.wendland_anisotropic, B, OUT[out], *args), h, tiles_bar)
    got = _grad(lambda p: SL._assemble_chunked_tiles(
        K.wendland_anisotropic, B, OUT[out], p, *args), h, tiles_bar)
    assert got.dtype == torch.float64 and got.shape == h.shape
    torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-12)
    direct = HK.tile_covariance_vjp(xb, mask, rows, cols, live, h,
                                    tiles_bar)
    torch.testing.assert_close(direct, ref, rtol=1e-12, atol=1e-12)


def test_vjp_of_dead_and_padded_tiles_is_zero():
    """A cotangent only on dead tiles and on padding rows leaves no
    gradient; on the diagonal pairs (d = 0) it reaches only the signal
    variance."""
    xb, mask, rows, cols, live = _case()
    h = torch.tensor(HPS["1+D"], dtype=torch.float64)
    tb = torch.zeros((len(rows), B, B), dtype=torch.float64)
    tb[~live] = 1.0
    tb[rows == NB - 1, 11:, :] = 1.0
    assert torch.equal(HK.tile_covariance_vjp(xb, mask, rows, cols, live, h,
                                              tb), torch.zeros(4, dtype=h.dtype))
    tb = torch.zeros_like(tb)
    diag = (rows == cols) & live
    tb[diag] = torch.eye(B, dtype=torch.float64)
    g = HK.tile_covariance_vjp(xb, mask, rows, cols, live, h, tb)
    valid = float(mask[rows[diag]].sum())
    torch.testing.assert_close(g, torch.tensor([valid, 0.0, 0.0, 0.0],
                                               dtype=torch.float64))


def test_float32_points_route_and_agree_with_autograd():
    """Float32 points with float32 hyperparameters take the K5 route; its
    float32 sums and float64 total agree with autograd's float32 gradient
    to float32 rounding."""
    xb, mask, rows, cols, live = _case(torch.float32)
    h = torch.tensor(HPS["1+D"], dtype=torch.float32)
    assert HK.tile_covariance_takes(xb, h, torch.float32)
    tb = torch.randn((len(rows), B, B), generator=torch.Generator()
                     .manual_seed(5))
    args = (rows, cols, live, xb, mask)
    ref = _grad(lambda p: SL._AssembleTiles.apply(
        p, K.wendland_anisotropic, B, torch.float32, *args), h, tb)
    got = _grad(lambda p: SL._assemble_chunked_tiles(
        K.wendland_anisotropic, B, None, p, *args), h, tb)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, ref, rtol=2e-5,
                               atol=2e-5 * float(ref.abs().max()))


@pytest.fixture
def routes(monkeypatch):
    """Every call of ``tile_covariance`` made through ``sparse_lml``."""
    calls = []
    real = SL.tile_covariance

    def spy(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(SL, "tile_covariance", spy)
    return calls


def test_only_the_library_object_takes_k5(routes):
    """The library's Wendland object (and its fvGP aliases, the same
    object) reaches K5; a user's function under the same name, and the
    library object under operands K5 does not take, keep the generic
    chunked path with the same tiles."""
    xb, mask, rows, cols, live = _case()
    h = torch.tensor(HPS["1+D"], dtype=torch.float64)
    assert K.wendland_anisotropic_gp2Scale_gpu is K.wendland_anisotropic

    def wendland_anisotropic(x1, x2, hps):
        return K.wendland_anisotropic(x1, x2, hps)

    args = (B, None, h, rows, cols, live, xb, mask)
    ref = SL._assemble_chunked_tiles(K.wendland_anisotropic_tpu, *args)
    assert len(routes) == 1
    got = SL._assemble_chunked_tiles(wendland_anisotropic, *args)
    assert len(routes) == 1 and torch.equal(got, ref)
    # a block size that is no multiple of 8, and hyperparameters of
    # another dtype than the points: the generic path
    SL._assemble_chunked_tiles(K.wendland_anisotropic, 12, None, h, rows,
                               cols, live, xb[:, :12], mask[:, :12])
    SL._assemble_chunked_tiles(K.wendland_anisotropic, B, None, h.float(),
                               rows, cols, live, xb, mask)
    assert len(routes) == 1


def test_takes_names_the_kernel_dtypes():
    """What the card's kernel takes and what only the plain versions
    take, decided from the operands' description alone."""
    xb = torch.zeros((2, 128, 3))
    h = torch.ones(4)
    assert HK.tile_covariance_takes(xb, h, torch.bfloat16)
    assert HK.tile_covariance_takes(xb, h[:2], torch.float32)
    assert not HK.tile_covariance_takes(xb, h[:3], torch.float32)
    assert HK.tile_covariance_takes(xb.double(), h.double(), torch.float64)
    assert not HK.tile_covariance_takes(torch.zeros((2, 128, 33)),
                                        torch.ones(34), torch.float32)
    meta = xb.to("meta")
    assert not HK.tile_covariance_takes(meta, h.to("meta"), torch.float64)
    assert HK.tile_covariance_takes(meta, h.to("meta"), torch.bfloat16)


N_FACADE = 2000


def _facade_lml(monkeypatch, generic):
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 18, (N_FACADE, 3))
    y = np.sin(0.4 * x[:, 0]) + 0.05 * rng.standard_normal(N_FACADE)
    hps = np.array([1.0, 2.0, 2.0, 2.0])
    with monkeypatch.context() as mp, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if generic:
            mp.setattr(SL, "tile_covariance_takes", lambda *a: False)
        gp = GP(x, y, init_hyperparameters=hps,
                noise_variances=np.full(N_FACADE, 1e-2), gp2Scale=True,
                compute_device="cpu", linalg_mode="sparseCGpre",
                args={"gp2Scale_block_size": 64,
                      "random_logdet_fixed_probes": 8,
                      "sparse_cg_maxiter": 64})
        return gp.marginal_likelihood.log_likelihood_value_and_gradient(
            hps * np.array([1.0, 1.02, 0.99, 1.01]))


def test_gp2scale_lml_and_gradient_through_the_facade(monkeypatch, routes):
    """N = 2,000 through ``GP(gp2Scale=True)`` on the CPU (float64): the
    K5 route and the generic route give the LML and gradient within the
    port's tolerance against the JAX package (``test_torch_gp2scale``:
    rtol 1e-7), at the same probes."""
    val_g, grad_g = _facade_lml(monkeypatch, generic=True)
    assert not routes
    val, grad = _facade_lml(monkeypatch, generic=False)
    assert len(routes) == 1
    np.testing.assert_allclose(val, val_g, rtol=1e-7)
    np.testing.assert_allclose(grad, grad_g, rtol=1e-7)
