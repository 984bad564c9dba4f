"""The Rademacher probe draw (``fvgp_tpu_torch.ops.slq.rademacher_probes``):
the native library's block MT19937 gives the bits ``torch.randint(0, 2,
...)`` draws from the same CPU generator, leaves the generator's state as
that call leaves it, and falls back to ``torch.randint`` where it cannot
run; a gp2Scale LML and gradient do not change with the route.  Imports
neither JAX nor the JAX package, so it also runs on a card alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_probes.py
"""

import warnings

import numpy as np
import pytest
import torch

import fvgp_tpu_torch.ops.slq as slq
from fvgp_tpu_torch import GP, native
from fvgp_tpu_torch.utils import trace

SHAPES = [(1, 1), (623, 1), (624, 1), (625, 3), (7, 5), (1000, 16)]
DTYPES = [torch.float32, torch.float64]
# the sparse Adam chain's seeding (GPMarginalLikelihood.sparse_adam_steps)
CHAIN_SEED = int(np.random.SeedSequence([7, 0, 3]).generate_state(1)[0])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (the suite's parallel
    workers would oversubscribe the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def lib():
    if native.get_lib() is None:
        pytest.skip("native toolchain unavailable")
    return native.get_lib()


def _pair(seed, prior):
    """Two generators seeded ``seed`` that have each drawn ``prior``
    values with ``torch.randint``."""
    pair = [torch.Generator().manual_seed(seed) for _ in range(2)]
    for g in pair:
        if prior:
            torch.randint(0, 2, (prior,), generator=g, dtype=torch.int8)
    return pair


def _randint_route(shape, dtype, generator):
    """The draw as ``torch.randint`` makes it."""
    bits = torch.randint(0, 2, shape, generator=generator, dtype=torch.int8)
    return 2.0 * bits.to(dtype) - 1.0


def _draws(name, fn):
    before = trace.counters().get(name, 0)
    out = fn()
    return out, trace.counters().get(name, 0) - before


def _assert_same(seed, prior, shape, dtype):
    mine, ref = _pair(seed, prior)
    Z, n = _draws("probe_draws_native", lambda: slq.rademacher_probes(
        *shape, dtype, "cpu", mine))
    assert n == 1
    want = _randint_route(shape, dtype, ref)
    assert Z.dtype == dtype and Z.shape == shape and Z.is_contiguous()
    assert torch.equal(Z, want)
    assert torch.equal(mine.get_state(), ref.get_state())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [0, 42, 43, 2 ** 32 - 1, CHAIN_SEED])
def test_fresh_generator_gives_randint_bits_and_state(lib, seed, shape,
                                                      dtype):
    _assert_same(seed, 0, shape, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("prior", [1, 623, 1000])
def test_used_generator_gives_randint_bits_and_state(lib, prior, shape,
                                                     dtype):
    _assert_same(42, prior, shape, dtype)


def test_generator_continues_as_randint_leaves_it(lib):
    """Draws in a row, as the SLQ solver's batches make them, then a
    ``torch.randint`` on the same generator: every value as if
    ``torch.randint`` had made each draw."""
    mine, ref = _pair(5, 0)
    for shape in [(300, 4), (1, 1), (2000, 3)]:
        assert torch.equal(slq.rademacher_probes(*shape, torch.float64,
                                                 "cpu", mine),
                           _randint_route(shape, torch.float64, ref))
    assert torch.equal(torch.randint(0, 2, (50,), generator=mine),
                       torch.randint(0, 2, (50,), generator=ref))


def test_other_float_dtype_and_empty_draw(lib):
    """A dtype the library does not write is widened from its int8 ±1; a
    draw of no values leaves the generator alone."""
    mine, ref = _pair(9, 10)
    Z = slq.rademacher_probes(33, 2, torch.bfloat16, "cpu", mine)
    assert torch.equal(Z, _randint_route((33, 2), torch.bfloat16, ref))
    state = mine.get_state()
    assert slq.rademacher_probes(0, 16, torch.float32, "cpu",
                                 mine).shape == (0, 16)
    assert torch.equal(mine.get_state(), state)


@pytest.mark.parametrize("route", ["env", "unavailable"])
def test_without_the_library_randint_draws(monkeypatch, route):
    """``FVGP_TPU_NATIVE=0``, or a library that did not load: the same
    tensor and state, counted as a fallback."""
    if route == "env":
        monkeypatch.setenv("FVGP_TPU_NATIVE", "0")
        monkeypatch.setattr(native, "_TRIED", False)
    else:
        monkeypatch.setattr(native, "_TRIED", True)
    monkeypatch.setattr(native, "_LIB", None)
    mine, ref = _pair(43, 0)
    Z, n = _draws("probe_draws_fallback", lambda: slq.rademacher_probes(
        625, 3, torch.float32, "cpu", mine))
    assert native.get_lib() is None and n == 1
    assert torch.equal(Z, _randint_route((625, 3), torch.float32, ref))
    assert torch.equal(mine.get_state(), ref.get_state())


def test_unknown_state_layout_falls_back(lib, monkeypatch):
    """A generator state of another size than the layout read here goes to
    ``torch.randint``, with the same result."""
    monkeypatch.setattr(slq, "_STATE_BYTES", slq._STATE_BYTES + 8)
    mine, ref = _pair(42, 7)
    Z, n = _draws("probe_draws_fallback", lambda: slq.rademacher_probes(
        7, 5, torch.float64, "cpu", mine))
    assert n == 1
    assert torch.equal(Z, _randint_route((7, 5), torch.float64, ref))
    assert torch.equal(mine.get_state(), ref.get_state())


def test_native_agrees_with_this_torch(lib):
    assert slq._native_agrees()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_card_tensor_equals_cpu_tensor(lib, dtype):
    """On the card the int8 ±1 are copied and widened there: the same
    values and generator state as the CPU draw."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    mine, ref = _pair(42, 0)
    Z, n = _draws("probe_draws_native", lambda: slq.rademacher_probes(
        1000, 16, dtype, "cuda", mine))
    assert n == 1 and Z.device.type == "cuda" and Z.dtype == dtype
    assert Z.shape == (1000, 16) and Z.is_contiguous()
    assert torch.equal(Z.cpu(), slq.rademacher_probes(1000, 16, dtype,
                                                       "cpu", ref))
    assert torch.equal(mine.get_state(), ref.get_state())


def _sparse_lml_and_grad():
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 14, (900, 3))
    h = np.array([1.0, 2.0, 2.0, 2.0])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        gp = GP(x, np.sin(0.5 * x[:, 0]), init_hyperparameters=h,
                gp2Scale=True, noise_variances=np.full(900, 1e-2),
                linalg_mode="sparseCGpre", compute_device="cpu",
                args={"gp2Scale_block_size": 64,
                      "random_logdet_fixed_probes": 16})
        ml = gp.marginal_likelihood
        return [ml.log_likelihood_value_and_gradient(h * s)
                for s in (1.0, 1.01)]


def test_gp2scale_lml_and_gradient_identical_by_either_route(lib,
                                                             monkeypatch):
    """Two evaluations (the probe generator seeded 42 and 43) of a small
    gp2Scale LML and gradient: bit for bit the same under the native draw
    and under ``torch.randint``."""
    before = trace.counters()
    native_out = _sparse_lml_and_grad()
    mid = trace.counters()
    monkeypatch.setattr(slq, "_native_agrees", lambda: False)
    fallback_out = _sparse_lml_and_grad()
    after = trace.counters()

    def delta(a, b, name):
        return b.get(name, 0) - a.get(name, 0)

    assert delta(before, mid, "probe_draws_native") == 2
    assert delta(before, mid, "probe_draws_fallback") == 0
    assert delta(mid, after, "probe_draws_native") == 0
    assert delta(mid, after, "probe_draws_fallback") == 2
    for (v1, g1), (v2, g2) in zip(native_out, fallback_out):
        assert v1 == v2
        np.testing.assert_array_equal(g1, g2)
