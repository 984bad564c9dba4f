"""The committed-state solver's CG on its own (CPU): with ``compact=True``
it drops the columns that meet the exit floor, in widths of multiples of 8,
and takes the trips and answers of the CG that keeps every column; the
committed weights of a float32 gp2Scale model are refined once past the
CG's exit floor (``ops/sparse_lml._refined``)."""

import warnings

import numpy as np
import pytest
import torch

import fvgp_tpu_torch.ops.sparse_lml as SL
from fvgp_tpu_torch import GP
from fvgp_tpu_torch.kernels import wendland_anisotropic
from fvgp_tpu_torch.utils import trace

TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _system(c=64, n=200, seed=0):
    """An SPD A with eigenvalues in [1, 1e3] and c right-hand sides, column
    j spanning only the first 2 + j // 2 eigenvectors: in exact arithmetic
    column j converges in at most that many trips, so the columns finish
    far apart.  Two columns are zero (a padded solve's columns)."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.geomspace(1.0, 1e3, n)
    A = torch.as_tensor((Q * lam) @ Q.T)
    B = np.zeros((n, c))
    for j in range(c - 2):
        k = 2 + j // 2
        B[:, j] = Q[:, :k] @ rng.standard_normal(k)
    return A, torch.as_tensor(B)


def _solve(A, B, compact):
    widths = []

    def matvec(P):
        widths.append(P.shape[1])
        return A @ P

    X, it = SL._cg_fixed(matvec, B, 200, tol=TOL, with_iters=True,
                         compact=compact)
    return X, it, widths


def test_compaction_takes_the_same_trips_and_meets_every_floor():
    A, B = _system()
    X0, it0, w0 = _solve(A, B, compact=False)
    X1, it1, w1 = _solve(A, B, compact=True)
    assert it0 == it1 and set(w0) == {64}
    # every column's residual below the exit floor, relative to its own
    # right-hand side (the zero columns stay exactly zero)
    res = torch.linalg.norm(B - A @ X1, dim=0)
    norm = torch.linalg.norm(B, dim=0)
    assert torch.all(res <= 1.5 * TOL * norm)
    assert torch.all(X1[:, -2:] == 0)
    # the same solution to the floor's accuracy (cond 1e3 × 1e-6)
    scale = torch.linalg.norm(X0, dim=0).clamp(min=1e-300)
    assert torch.all(torch.linalg.norm(X1 - X0, dim=0) <= 1e-3 * scale)


def test_compaction_shrinks_the_width_in_multiples_of_8():
    A, B = _system()
    _, it, widths = _solve(A, B, compact=True)
    assert len(widths) == it and widths[0] == 64
    assert widths == sorted(widths, reverse=True) and widths[-1] < 32
    for a, b in zip(widths, widths[1:]):
        assert b == a or (b % 8 == 0 and b <= 3 * a // 4)


def test_compaction_counts_one_sync_per_exit_test():
    A, B = _system()
    before = trace.counters()
    _, it, _ = _solve(A, B, compact=True)
    after = trace.counters()
    assert after["cg_iterations"] - before.get("cg_iterations", 0) == it
    assert after["host_syncs"] - before.get("host_syncs", 0) == it + 1


def test_refinement_adds_a_correction_solve():
    A, B = _system(c=8)
    calls = []

    def cg(R):
        calls.append(R.clone())
        return SL._cg_fixed(lambda P: A @ P, R, 200, tol=1e-2,
                            with_iters=True)

    X1, it1 = cg(B)
    X2, it2 = SL._refined(cg, lambda P: A @ P, B, 1)
    assert len(calls) == 3 and it2 > it1
    assert torch.allclose(calls[2], B - A @ X1)
    r1 = torch.linalg.norm(B - A @ X1)
    r2 = torch.linalg.norm(B - A @ X2)
    assert r2 < 0.05 * r1


def _float32_gp(n=1200, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 16, (n, 3))
    y = np.sin(x[:, 0]) + 0.03 * rng.standard_normal(n)
    hps = np.array([1.0, 2.0, 2.0, 2.0])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        gp = GP(x, y, init_hyperparameters=hps,
                noise_variances=np.full(n, 1e-2), gp2Scale=True,
                compute_device="cpu", linalg_mode="sparseCGpre",
                args={"gp2Scale_block_size": 64, "dtype": "float32",
                      "gp2Scale_structure_cache_dir": False})
    return gp, hps


def test_float32_committed_weights_are_refined_past_the_exit_floor():
    """The float32 CG exits at a relative residual of 1e-4; one round of
    refinement leaves the weights (K+V)⁻¹(y − m) a residual far below it,
    read against the dense float64 K + V; the variance's solves are not
    refined."""
    gp, hps = _float32_gp()
    w = gp.kv.KVinvY[:, 0].double()
    assert gp.kv.last_solve_info["method"] == "committed_pcg"
    xd = torch.as_tensor(gp.x_data)
    K = wendland_anisotropic(xd, xd, torch.as_tensor(hps)) \
        + 1e-2 * torch.eye(len(xd), dtype=torch.float64)
    yd = torch.as_tensor(gp.y_data[:, 0])
    b = yd - yd.mean()
    rel = float(torch.linalg.norm(b - K @ w) / torch.linalg.norm(b))
    assert rel < 1e-5

    gp.kv._KVinvY = None
    inner = SL._refined
    rounds = []

    def recording(cg, matvec, RHS, refine):
        rounds.append(refine)
        return inner(cg, matvec, RHS, refine)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(SL, "_refined", recording)
        gp.kv.KVinvY
        gp.posterior_covariance(np.zeros((3, 3)), variance_only=True)
    assert rounds == [1, 0]
