"""Each reference against float64 NumPy at tiny N, and (outside the
reference, which imports nothing of the program) against the program on
the CPU in float64, where both compute the same estimator."""

import numpy as np
import pytest
import torch
from gpbench_toy import REPO  # noqa: F401

from gpbench.reference import (dense_lml_grad, dense_predict, gp2scale,
                               gp2scale_lml_grad)
from gpbench.reference.precision import operand, round_tf32


def _matern(x1, x2, h):
    d = np.sqrt((((x1[:, None] - x2[None]) / h[1:]) ** 2).sum(-1))
    return h[0] * (1 + np.sqrt(3) * d) * np.exp(-np.sqrt(3) * d)


def _dense_lml(x, y, noise, h):
    A = _matern(x, x, h) + np.diag(noise)
    ym = y - y.mean()
    s, logdet = np.linalg.slogdet(A)
    return -0.5 * (ym @ np.linalg.solve(A, ym) + logdet
                   + len(x) * np.log(2 * np.pi))


def _dense_data(n=60, seed=0):
    r = np.random.default_rng(seed)
    x = r.uniform(0, 4, (n, 3))
    return {"x": x, "y": np.sin(x[:, 0]) + 0.05 * r.standard_normal(n),
            "noise": np.full(n, 1e-2)}


def test_dense_lml_and_gradient_against_numpy():
    data = _dense_data()
    h = np.array([1.2, 1.5, 1.1, 0.9])
    cfg = {"gp": {"init_hyperparameters": list(h)}}
    val, grad = dense_lml_grad.make(cfg, data, "cpu").lml_grad(h)
    assert val == pytest.approx(_dense_lml(data["x"], data["y"],
                                           data["noise"], h), rel=1e-12)
    for k in range(4):
        e = np.zeros(4)
        e[k] = 1e-6
        fd = (_dense_lml(data["x"], data["y"], data["noise"], h + e)
              - _dense_lml(data["x"], data["y"], data["noise"], h - e)) / 2e-6
        assert grad[k] == pytest.approx(fd, rel=1e-6, abs=1e-6)


def test_dense_prediction_against_numpy():
    data = _dense_data()
    h = np.array([1.2, 1.5, 1.1, 0.9])
    cfg = {"gp": {"init_hyperparameters": list(h)}}
    xq = np.random.default_rng(3).uniform(0, 4, (7, 3))
    mean, var = dense_predict.make(cfg, data, "cpu").predict(xq)
    A = _matern(data["x"], data["x"], h) + np.diag(data["noise"])
    ks = _matern(data["x"], xq, h)
    m = data["y"].mean()
    assert np.allclose(mean, m + ks.T @ np.linalg.solve(A, data["y"] - m),
                       rtol=1e-10, atol=1e-12)
    want = np.maximum(h[0] - np.einsum("ij,ij->j", ks,
                                       np.linalg.solve(A, ks)), 0)
    assert np.allclose(var, want, rtol=1e-8, atol=1e-12)


def _wendland(d):
    d = np.minimum(d, 1.0)
    return (1 - d) ** 8 * (32 * d ** 3 + 25 * d ** 2 + 8 * d + 1)


def _gp2_K(xs, h):
    d = np.sqrt((((xs[:, None] - xs[None]) / h[1:]) ** 2).sum(-1))
    return h[0] * _wendland(d)


def test_gp2scale_estimator_against_numpy():
    """At N = 300 (3 blocks of 128, the last padded) the converged
    estimator is, with the same probes u and M = blockdiag(K+V),
    L(h) = -½[yᵀA⁻¹y + log|M| + (1/P) Σ ‖u‖²-weighted e₁ quadrature of
    log(L⁻¹AL⁻ᵀ)], which converged equals (1/P) Σ uᵀ log(L⁻¹AL⁻ᵀ) u."""
    r = np.random.default_rng(1)
    n, B, P = 300, 128, 4
    x = r.uniform(0, 6, (n, 3))
    y = np.sin(x[:, 0]) + 0.05 * r.standard_normal(n)
    data = {"x": x, "y": y, "noise": np.full(n, 1e-2)}
    h = np.array([1.0, 2.0, 2.1, 1.9])
    cfg = {"gp": {"args": {"gp2Scale_block_size": B, "sparse_cg_maxiter": 32,
                           "random_logdet_fixed_probes": P}}}
    ref = gp2scale_lml_grad.make(cfg, data, "cpu")
    val, grad = ref.lml_grad(h, 5)

    perm = gp2scale.morton_order(x)
    nb = -(-n // B)
    npad = nb * B
    xs = np.zeros((npad, 3))
    xs[:n] = x[perm]
    mask = np.r_[np.ones(n), np.zeros(npad - n)]

    def A_of(h):
        return _gp2_K(xs, h) * np.outer(mask, mask) + np.diag(
            np.r_[np.full(n, 1e-2), np.ones(npad - n)])

    A = A_of(h)
    M = np.zeros_like(A)
    for b in range(nb):
        s = slice(b * B, (b + 1) * B)
        M[s, s] = A[s, s]
    L = np.linalg.cholesky(M)
    U = gp2scale.rademacher(npad, P, 5, torch.float64, "cpu").numpy() \
        * mask[:, None]
    C = np.linalg.solve(L, np.linalg.solve(L, A).T).T
    w, V = np.linalg.eigh((C + C.T) / 2)
    logC = (V * np.log(w)) @ V.T
    ym = np.r_[y[perm] - y.mean(), np.zeros(npad - n)]
    ld = np.linalg.slogdet(M)[1] + np.mean([u @ logC @ u for u in U.T])
    want = -0.5 * (ym @ np.linalg.solve(A, ym) + ld + n * np.log(2 * np.pi))
    assert val == pytest.approx(want, rel=1e-10)

    # G = ½ x xᵀ − (½/P) Σ_j s_j (M⁻¹ z_j)ᵀ, dL/dh = Σ G ∘ ∂K/∂h
    xsol = np.linalg.solve(A, ym)
    Z = L @ U
    S = np.linalg.solve(A, Z)
    G = 0.5 * np.outer(xsol, xsol) - 0.5 / P * S @ np.linalg.solve(M, Z).T
    for k in range(4):
        e = np.zeros(4)
        e[k] = 1e-6
        dK = (A_of(h + e) - A_of(h - e)) / 2e-6
        assert grad[k] == pytest.approx(np.sum(G * dK), rel=1e-6, abs=1e-8)


def test_gp2scale_reference_is_the_program_estimator_on_the_cpu():
    """The program in float64 on the CPU, run to convergence, computes the
    estimator the reference computes: same order, probes, preconditioner."""
    from fvgp_tpu_torch import GP
    r = np.random.default_rng(2)
    n = 1500
    x = r.uniform(0, (n * 4.19 * 8 / 40) ** (1 / 3), (n, 3))
    y = np.sin(0.2 * x[:, 0]) + 0.05 * r.standard_normal(n)
    args = {"gp2Scale_block_size": 128, "sparse_cg_maxiter": 2000,
            "random_logdet_fixed_probes": 16, "sparse_cg_tol": 1e-11,
            "gp2Scale_structure_cache_dir": False}
    h0 = np.array([1.0, 2.0, 2.0, 2.0])
    gp = GP(x, y, init_hyperparameters=h0, noise_variances=np.full(n, 1e-2),
            gp2Scale=True, compute_device="cpu", args=args)
    assert np.array_equal(np.asarray(gp.x_data), x[gp2scale.morton_order(x)])
    ref = gp2scale_lml_grad.make({"gp": {"args": args}},
                        {"x": x, "y": y, "noise": np.full(n, 1e-2)}, "cpu")
    hs = [h0, h0 * np.exp(r.uniform(-0.03, 0.03, 4))]
    got = [gp.marginal_likelihood.log_likelihood_value_and_gradient(h)
           for h in hs]
    for (v, g), (rv, rg) in zip(got, ref.lml_grads(hs, [0, 1])):
        assert abs(v - rv) <= 1e-10 * abs(rv)
        assert np.max(np.abs(g - rg)) <= 1e-7 * np.max(np.abs(rg))


def test_tf32_rounding():
    t = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12,
                      1.0 + 2 ** -23], dtype=torch.float32)
    got = round_tf32(t)
    # ties to even at 1 + 2^-11; 2^-12 above a representable value rounds
    # down; a last-bit change vanishes
    assert got.tolist() == [1.0, 1.0, 1.0 + 2 ** -10, 1.0]
    assert operand(t, "exact") is t
    g = torch.ones(3, requires_grad=True)
    operand(g * 1.0, "tf32").sum().backward()
    assert torch.equal(g.grad, torch.ones(3))
