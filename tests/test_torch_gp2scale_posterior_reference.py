"""The gp2Scale posterior of the port against the benchmark's plain
reference (``gpbench/reference/gp2scale_predict.py``) and against a dense
float64 solve of the same Wendland K + V (CPU, seeded; float64 and the
benchmark cell's float32).

The port's ``GP(..., gp2Scale=True)`` above its batch size serves
``posterior_mean`` through the fused cross-covariance sweep and
``posterior_covariance(variance_only=True)`` through the committed-state
block-Jacobi PCG — the path of the benchmark's gp2scale-predict cell.  A
planted fault, one live tile pair dropped from the committed solver's
structure, must make the comparison fail."""

import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from fvgp_tpu_torch import GP
from fvgp_tpu_torch.parallel.tile_structure import TileStructure

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gpbench.reference import gp2scale_predict  # noqa: E402
from gpbench.reference.gp2scale import wendland  # noqa: E402

D, B = 3, 32
H0 = np.array([1.0, 2.0, 2.0, 2.0])
NOISE = 1e-2
# The port's float64 committed CG exits once every column's squared
# relative preconditioned residual is below 1e-14, a residual of 1e-7
# (``ops/sparse_lml._freeze_tol_sq``).  The mean's error is linear in that
# residual and reads up to 1.1e-7 of its scale in these cases; the
# variance's is quadratic (1e-13).  1e-6 holds the port with 9x room, and
# the planted fault reads 1.2e-3.  The reference's CG runs to a residual of
# 1e-11 and meets the dense LU solve to 3e-10 here; 1e-9 bounds that.
PORT_TOL = 1e-6
REF_TOL = 1e-9
# In float32 (the benchmark cell's precision) the committed CG exits at a
# relative residual of 1e-4.  The weights (K+V)⁻¹(y − m) are refined once
# past it, so the mean reads up to 2.6e-6 of its scale here, where
# unrefined weights read 3.8e-5 to 3.7e-4; the variance's error is
# quadratic in its residual (1e-8) and float32's rounding of
# k(x*, x*) − kᵀ(K+V)⁻¹k leaves up to 1.3e-6.  1e-5 holds both with ~4x
# room and fails the unrefined mean.
PORT32_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(N, n, seed):
    """Points uniform on a box with ~40 others inside each point's
    support at lengthscale 2, as the benchmark's configuration draws
    them; n query points on the same box."""
    rng = np.random.default_rng(seed)
    side = (N * 4.19 * 8 / 40) ** (1 / 3)
    x = rng.uniform(0.0, side, (N, D))
    y = np.sin(0.5 * x[:, 0]) + 0.05 * rng.standard_normal(N)
    return x, y, rng.uniform(0.0, side, (n, D))


def _port(x, y, xq, **args):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        gp = GP(x, y, init_hyperparameters=H0,
                noise_variances=np.full(len(x), NOISE), gp2Scale=True,
                gp2Scale_batch_size=len(x) // 2, compute_device="cpu",
                args={"gp2Scale_block_size": B,
                      "gp2Scale_structure_cache_dir": False, **args})
        mean = gp.posterior_mean(xq)["m(x)"]
        var = gp.posterior_covariance(xq, variance_only=True)["v(x)"]
    return gp, np.asarray(mean), np.asarray(var)


def _reference(x, y, xq):
    config = {"gp": {"init_hyperparameters": list(H0),
                     "args": {"gp2Scale_block_size": B,
                              "random_logdet_fixed_probes": 16,
                              "sparse_cg_maxiter": 32}}}
    data = {"x": x, "y": y, "noise": np.full(len(x), NOISE)}
    ref = gp2scale_predict.make(config, data, "cpu", "exact")
    (mean, var), = ref.predict([xq])
    return mean, var


def _dense(x, y, xq):
    """The posterior by one dense float64 solve of K + V."""
    h = torch.as_tensor(H0)
    X, Q = torch.as_tensor(x) / h[1:], torch.as_tensor(xq) / h[1:]
    K = h[0] * wendland(torch.cdist(X, X)) + NOISE * torch.eye(len(x))
    ks = h[0] * wendland(torch.cdist(X, Q))
    yt = torch.as_tensor(y)
    sol = torch.linalg.solve(K, torch.cat(
        [(yt - yt.mean())[:, None], ks], dim=1))
    mean = yt.mean() + ks.T @ sol[:, 0]
    var = torch.clamp(h[0] - torch.sum(ks * sol[:, 1:], dim=0), min=0.0)
    return mean.numpy(), var.numpy()


def _errors(a, b, ybar):
    """(mean_rel, var_rel) as the benchmark's check computes them."""
    (ma, va), (mb, vb) = a, b
    return (np.max(np.abs(ma - mb)) / np.max(np.abs(mb - ybar)),
            np.max(np.abs(va - vb)) / H0[0])


def _drop_heaviest_tile_pair(monkeypatch):
    """Plant a fault: the committed solver's structure loses the live
    off-diagonal tile pair holding the most covariance."""
    inner = TileStructure.exact

    def dropped(self, ls, radius, B_):
        rows, cols = inner(self, ls, radius, B_)
        xw = np.asarray(self.data.x_data, np.float64) / ls
        off = np.flatnonzero(rows < cols)

        def mass(t):
            a = xw[rows[t] * B_:(rows[t] + 1) * B_]
            b = xw[cols[t] * B_:(cols[t] + 1) * B_]
            d = np.sqrt(((a[:, None] - b[None]) ** 2).sum(-1))
            return float(wendland(torch.as_tensor(d)).sum())

        t = max(off, key=mass)
        keep = ~(((rows == rows[t]) & (cols == cols[t]))
                 | ((rows == cols[t]) & (cols == rows[t])))
        return rows[keep], cols[keep]

    monkeypatch.setattr(TileStructure, "exact", dropped)


@pytest.mark.parametrize("N,n,fault", [(2048, 1, False), (2048, 37, False),
                                       (4096, 64, False), (2048, 37, True)])
def test_posterior_matches_the_reference_and_a_dense_solve(N, n, fault,
                                                           monkeypatch):
    x, y, xq = _data(N, n, seed=N + n)
    if fault:
        _drop_heaviest_tile_pair(monkeypatch)
    gp, *port = _port(x, y, xq)
    assert gp.kv.last_solve_info["method"] == "committed_pcg"
    ref = _reference(x, y, xq)
    dense = _dense(x, y, xq)
    ybar = float(np.mean(y))
    assert max(_errors(ref, dense, ybar)) < REF_TOL
    worst = max(max(_errors(port, ref, ybar)),
                max(_errors(port, dense, ybar)))
    if fault:
        assert worst > 100 * PORT_TOL
    else:
        assert worst < PORT_TOL


@pytest.mark.parametrize("N,n", [(4096, 1), (4096, 64)])
def test_float32_posterior_matches_the_reference_and_a_dense_solve(N, n):
    """The cell's precision: refined weights for the mean, the compacting
    CG at its float32 exit floor for the variance."""
    x, y, xq = _data(N, n, seed=N + n)
    gp, *port = _port(x, y, xq, dtype="float32")
    assert gp.kv.last_solve_info["method"] == "committed_pcg"
    assert gp.kv.dtype == torch.float32
    ybar = float(np.mean(y))
    worst = max(max(_errors(port, _reference(x, y, xq), ybar)),
                max(_errors(port, _dense(x, y, xq), ybar)))
    assert worst < PORT32_TOL
