"""Stochastic Lanczos quadrature log-determinant (counterpart of
``fvgp_tpu/ops/slq.py``).

Estimator: logdet(A) = tr(log A) = E_z[zᵀ log(A) z] for Rademacher z.  A
batch of probes runs the m-step Lanczos recursion together — one (n, k)
matvec per step, full reorthogonalization (m is ~20) — then the quadrature
goes through one batched ``eigh`` of the k m×m tridiagonals.  The
estimator's variance is reported through ``info_out``; the marginal
likelihood scales it into ``log_likelihood_variance``.

Probes are drawn on the CPU from a seeded ``torch.Generator``, so a CPU and
a CUDA run of the same model see the same probes.
"""

import numpy as np
import torch

from ..config import resolve_device

__all__ = ["slq_logdet", "lanczos_tridiag", "rademacher_probes"]


def rademacher_probes(n, p, dtype, device, generator):
    """(n, p) Rademacher probes (±1), drawn on the CPU from ``generator`` so
    a CPU and a CUDA run of the same model see the same probes."""
    bits = torch.randint(0, 2, (n, p), generator=generator, dtype=torch.int8)
    return (2.0 * bits.to(dtype) - 1.0).to(device)


def _as_closure(matvec, operator):
    return matvec if operator is None else (lambda X: matvec(operator, X))


def _lanczos_batch(mv, V0, degree):
    """m-step Lanczos with full reorthogonalization on the k columns of
    ``V0`` (n, k) at once; returns alphas (m, k), betas (m-1, k)."""
    n, k = V0.shape
    dt, dev = V0.dtype, V0.device
    v = V0 / torch.linalg.norm(V0, dim=0)
    basis = torch.zeros((degree, n, k), dtype=dt, device=dev)
    basis[0] = v
    v_prev = torch.zeros_like(v)
    beta_prev = torch.zeros(k, dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    alphas, betas = [], []
    for i in range(degree):
        w = mv(v)
        alpha = torch.sum(w * v, dim=0)
        w = w - alpha * v - beta_prev * v_prev
        # full reorthogonalization against the basis so far (later rows are
        # still zero)
        w = w - torch.einsum("dnk,dk->nk", basis,
                             torch.einsum("dnk,nk->dk", basis, w))
        beta = torch.linalg.norm(w, dim=0)
        v_next = torch.where(beta > 0, w / torch.where(beta == 0, one, beta),
                             w)
        if i + 1 < degree:
            basis[i + 1] = v_next
        v_prev, v, beta_prev = v, v_next, beta
        alphas.append(alpha)
        betas.append(beta)
    return torch.stack(alphas), torch.stack(betas[:-1])


def lanczos_tridiag(matvec, v0, degree, operator=None):
    """m-step Lanczos with full reorthogonalization.

    Parameters
    ----------
    matvec : (n, 1)-block matvec — a closure, or fn(data, X) with
        ``operator`` (see ``ops.krylov`` for the convention)
    v0 : (n,) start vector (need not be normalized)
    degree : number of Lanczos steps m

    Returns
    -------
    alphas (m,), betas (m-1,) of the tridiagonal T.
    """
    with torch.no_grad():
        a, b = _lanczos_batch(_as_closure(matvec, operator), v0[:, None],
                              int(degree))
    return a[:, 0], b[:, 0]


def _probe_quadrature(mv, Z, degree):
    """zᵀ log(A) z estimates for the Rademacher probes in the columns of
    ``Z``: one batched ``eigh`` of the tridiagonals."""
    n = Z.shape[0]
    alphas, betas = _lanczos_batch(mv, Z, degree)
    T = (torch.diag_embed(alphas.T) + torch.diag_embed(betas.T, offset=1)
         + torch.diag_embed(betas.T, offset=-1))
    theta, U = torch.linalg.eigh(T)
    theta = torch.clamp(theta, min=torch.finfo(Z.dtype).tiny)
    tau = U[:, 0, :] ** 2
    # ||z||² = n for Rademacher probes
    return n * torch.sum(tau * torch.log(theta), dim=1)


def slq_logdet(matvec, n, *, dtype=torch.float64, device=None, degree=20,
               min_num_samples=10, max_num_samples=5000, error_rtol=0.01,
               batch=None, generator=None, info_out=None, operator=None):
    """Stochastic Lanczos log-determinant with adaptive probe count.

    Draws at least ``min_num_samples`` Hutchinson probes, keeps drawing in
    batches until the relative standard error of the mean falls under
    ``error_rtol`` or ``max_num_samples`` is hit, and reports the achieved
    variance and sample count via ``info_out``.  ``matvec`` operates on
    (n, k) blocks: a closure, or fn(data, X) with ``operator``.
    ``device`` is where the probes are placed and the recursion runs: the
    operator's own device where it has one, else the card (``"cuda"``), or
    ``"cpu"`` where asked for.  ``generator`` is a CPU ``torch.Generator``
    (default: seed 0).
    """
    if device is None and getattr(operator, "device", None) is not None:
        device = operator.device
    else:
        device = resolve_device("cuda" if device is None else device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if batch is None:
        # wide batches mean fewer adaptive rounds and host syncs; capped by
        # memory: every probe carries a (degree, n) reorthogonalization
        # basis, bounded to 1 GiB
        per_probe = max(int(degree) * int(n) * torch.finfo(dtype).bits // 8,
                        1)
        batch = max(1, min(max(int(min_num_samples), 32), 256,
                           (1 << 30) // per_probe))
    mv = _as_closure(matvec, operator)
    samples = []
    total = 0
    while True:
        Z = rademacher_probes(n, int(batch), dtype, device, generator)
        with torch.no_grad():
            vals = _probe_quadrature(mv, Z, int(degree))
        samples.append(vals.double().cpu().numpy())
        total += int(batch)
        all_vals = np.concatenate(samples)
        mean = float(np.mean(all_vals))
        var_mean = (float(np.var(all_vals, ddof=1)) / total if total > 1
                    else np.inf)
        err = float(np.sqrt(var_mean) / max(abs(mean), 1e-300))
        if (total >= min_num_samples and err <= error_rtol) \
                or total >= max_num_samples:
            break
    if info_out is not None:
        info_out["logdet"] = mean
        info_out["variance"] = float(var_mean)
        info_out["num_samples"] = total
        info_out["relative_error"] = err
        info_out["degree"] = int(degree)
    return mean
