"""The host worker helpers of the port's ``parallel/sharded_cov.py`` (the
scipy CSR covariance for external solvers) against
``fvgp_tpu.parallel.sharded_cov``: the four cases of
``tests/test_scale.py``'s worker-helper tests, the same inputs through both
packages on the CPU in float64.  A host kernel (numpy out) and a port
kernel (tensors out, evaluated on ``compute_device="cpu"``) both go in."""

import numpy as np
import pytest
import torch
from scipy import sparse as sp

from fvgp_tpu.kernels import wendland_anisotropic as jax_wendland
from fvgp_tpu.parallel import sharded_cov as jsc
from fvgp_tpu_torch.kernels import wendland_anisotropic
from fvgp_tpu_torch.parallel import sharded_cov as tsc


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: under the suite's
    parallel workers torch's default of a thread per core oversubscribes
    the cores, and loops of small tensor ops slow down tenfold and more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = 1e-12


def _whost(x1, x2, hps):
    """A host (numpy) kernel."""
    return np.asarray(jax_wendland(x1, x2, hps))


def _csr_pair(kernel, *args, **kw):
    """The port's CSR (the host kernel, then the port's own kernel on the
    CPU) and the JAX package's."""
    jk = jsc.covariance_csr(_whost, *args, **kw)
    tk = tsc.covariance_csr(kernel, *args, compute_device="cpu", **kw)
    return tk, jk


@pytest.mark.parametrize("kernel", ["host", "port"])
def test_blockwise_matches_jax_and_the_dense_kernel(kernel):
    rng = np.random.default_rng(11)
    x = rng.uniform(0, 30, (237, 2))
    hps = np.array([1.0, 2.5, 2.5])
    K, JK = _csr_pair(_whost if kernel == "host" else wendland_anisotropic,
                      x, x, hps, batch_size=50)
    assert sp.isspmatrix_csr(K) and K.nnz == JK.nnz
    np.testing.assert_allclose(K.toarray(), JK.toarray(), rtol=0, atol=TOL)
    np.testing.assert_allclose(K.toarray(), _whost(x, x, hps), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("kernel", ["host", "port"])
def test_rowwise_matches_blockwise_and_jax(kernel):
    rng = np.random.default_rng(12)
    x1 = rng.uniform(0, 30, (120, 2))
    x2 = rng.uniform(0, 30, (85, 2))
    hps = np.array([1.0, 2.5, 2.5])
    fn = _whost if kernel == "host" else wendland_anisotropic
    Kb, JKb = _csr_pair(fn, x1, x2, hps, batch_size=40, symmetric=False)
    Kr, JKr = _csr_pair(fn, x1, x2, hps, batch_size=40, symmetric=False,
                        distribution="rowwise")
    for got, want in ((Kb, JKb), (Kr, JKr), (Kr, Kb)):
        np.testing.assert_allclose(got.toarray(), want.toarray(), rtol=0,
                                   atol=TOL)
    np.testing.assert_allclose(Kb.toarray(), _whost(x1, x2, hps), rtol=0,
                               atol=TOL)


def test_worker_helper_units_match_jax():
    for n, nb in ((10, 3), (7, 7), (100, 1), (5, 9)):
        assert tsc.ranges(n, nb) == jsc.ranges(n, nb)
    assert tsc.num_blocks(100, 30) == jsc.num_blocks(100, 30) == 3
    assert tsc.index_dtype_for(10, 10) is np.int32
    assert tsc.index_dtype_for(2 ** 31, 1) is np.int64
    # a scipy block passes through block_to_coo
    blk = sp.random(6, 6, density=0.3, random_state=0, format="csr")
    d, r, c = tsc.block_to_coo(blk)
    np.testing.assert_allclose(
        sp.coo_matrix((d, (r, c)), shape=(6, 6)).toarray(), blk.toarray())
    # a diagonal block of a symmetric matrix reports its upper triangle
    x = np.random.default_rng(13).uniform(0, 5, (8, 2))
    hps = np.array([1.0, 4.0, 4.0])
    got = tsc.block_triplets(((0, 8), (0, 8)), x, x, hps, _whost, 3, None,
                             True, compute_device="cpu")
    want = jsc.block_triplets(((0, 8), (0, 8)), x, x, hps, _whost, 3, None,
                              True)
    assert np.all(got[1] <= got[2])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    _, strip = tsc.row_strip_csr((2, 6), x, x, hps, _whost, 3, None, 8, 3,
                                 compute_device="cpu")
    _, jstrip = jsc.row_strip_csr((2, 6), x, x, hps, _whost, 3, None, 8, 3)
    np.testing.assert_array_equal(strip.toarray(), jstrip.toarray())
    # the 4-argument kernel dispatch; a port kernel comes back as numpy
    def k4(a, b, h, args):
        assert args == {"tag": 1}
        return _whost(a, b, h)

    out = tsc.evaluate_kernel(k4, x, x, hps, 4, {"tag": 1},
                              compute_device="cpu")
    np.testing.assert_allclose(out, _whost(x, x, hps), rtol=0, atol=TOL)
    port = tsc.evaluate_kernel(wendland_anisotropic, x, x[:5], hps, 3, None,
                               compute_device="cpu")
    assert isinstance(port, np.ndarray) and port.dtype == np.float64
    np.testing.assert_allclose(port, _whost(x, x[:5], hps), rtol=0, atol=TOL)
    with pytest.raises(Exception, match="signature"):
        tsc.evaluate_kernel(_whost, x, x, hps, 2, None, compute_device="cpu")
    empty = tsc.assemble_triplets([(np.zeros(0), np.zeros(0, np.int32),
                                    np.zeros(0, np.int32))], 4, 3, False)
    assert empty.shape == (4, 3) and empty.nnz == 0
    assert tsc.assemble_row_strips([], 4, 3).shape == (4, 3)


def test_arity_sniffing_and_the_default_device():
    """``covariance_csr`` sniffs a 4-argument kernel; like every entry
    point it evaluates a port kernel on the card unless asked for the
    CPU."""
    rng = np.random.default_rng(14)
    x = rng.uniform(0, 20, (60, 2))
    hps = np.array([1.0, 2.0, 2.0])
    seen = {}

    def k4(a, b, h, args):
        seen["args"] = args
        return _whost(a, b, h)

    K = tsc.covariance_csr(k4, x, x, hps, batch_size=25, args={"tag": 2},
                           compute_device="cpu")
    JK = jsc.covariance_csr(k4, x, x, hps, batch_size=25, args={"tag": 2})
    assert seen["args"] == {"tag": 2}
    np.testing.assert_allclose(K.toarray(), JK.toarray(), rtol=0, atol=TOL)
    np.testing.assert_allclose(K.toarray(), _whost(x, x, hps), rtol=0,
                               atol=TOL)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tsc.covariance_csr(wendland_anisotropic, x, x, hps)
