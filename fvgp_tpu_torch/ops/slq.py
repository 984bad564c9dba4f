"""Stochastic Lanczos quadrature log-determinant (counterpart of
``fvgp_tpu/ops/slq.py``).

Estimator: logdet(A) = tr(log A) = E_z[zᵀ log(A) z] for Rademacher z.  A
batch of probes runs the m-step Lanczos recursion together — one (n, k)
matvec per step, full reorthogonalization (m is ~20) — then the quadrature
goes through one batched ``eigh`` of the k m×m tridiagonals.  The
estimator's variance is reported through ``info_out``; the marginal
likelihood scales it into ``log_likelihood_variance``.

Probes are the bits ``torch.randint(0, 2, ...)`` draws from a seeded CPU
``torch.Generator``, so a CPU and a CUDA run of the same model see the same
probes.  The port's native host library (``native/structure.cpp``,
``rademacher_mt19937``) produces those bits from the generator's MT19937
state a block at a time and leaves the generator as ``torch.randint``
would; only the ±1 cross to the card, as int8.  ``torch.randint`` itself
draws them where the library is unavailable or the generator's state is
not the layout read here.
"""

import functools

import numpy as np
import torch

from .. import native
from ..config import resolve_device
from ..utils import trace

__all__ = ["slq_logdet", "lanczos_tridiag", "rademacher_probes"]


# torch's CPUGeneratorImplState: the_initial_seed u64, left i32, seeded
# i32, next u64, the 624 MT19937 words each as u64, then normal-sample
# caches that torch.randint leaves alone
_STATE_BYTES = 5056
_MT_N = 624


def rademacher_probes(n, p, dtype, device, generator):
    """(n, p) Rademacher probes (±1) in ``dtype`` on ``device``: the bits
    ``torch.randint(0, 2, (n, p), generator=generator)`` draws, so a CPU
    and a CUDA run of the same model see the same probes, with
    ``generator`` advanced as that call advances it.  Counted as
    ``probe_draws_native`` or ``probe_draws_fallback``."""
    device = torch.device(device)
    Z = None
    if native.get_lib() is not None and _native_agrees():
        Z = _native_probes(n, p, dtype, device, generator)
    if Z is not None:
        trace.count("probe_draws_native")
        return Z
    trace.count("probe_draws_fallback")
    bits = torch.randint(0, 2, (n, p), generator=generator, dtype=torch.int8)
    return (2.0 * bits.to(dtype) - 1.0).to(device)


def _native_probes(n, p, dtype, device, generator):
    """The probes by the native draw, or None where ``generator`` is not a
    CPU ``torch.Generator`` whose state has the layout above.  For the
    card they are written as int8 into pinned memory, copied, and widened
    to ``dtype`` there; for the CPU straight in float32 or float64."""
    if not (isinstance(generator, torch.Generator)
            and generator.device.type == "cpu"):
        return None
    raw = generator.get_state().numpy().copy()
    if raw.size != _STATE_BYTES:
        return None
    left = int(raw[8:12].view(np.int32)[0])
    nxt = int(raw[16:24].view(np.uint64)[0])
    words = raw[24:24 + 8 * _MT_N].view(np.uint64)
    if not (1 <= left <= _MT_N and nxt + left <= _MT_N + 1) \
            or int(words.max()) >> 32:
        return None
    state = words.astype(np.uint32)
    if device.type == "cuda":
        out = torch.empty((n, p), dtype=torch.int8, pin_memory=True)
    else:
        out = torch.empty((n, p), dtype=dtype if dtype in (
            torch.float32, torch.float64) else torch.int8)
    left, nxt = native.rademacher_mt19937(state, left, nxt, out.numpy())
    raw[8:12].view(np.int32)[0] = left
    raw[16:24].view(np.uint64)[0] = nxt
    words[:] = state
    generator.set_state(torch.from_numpy(raw))
    return out.to(device, non_blocking=True).to(dtype)


@functools.cache
def _native_agrees():
    """Whether this torch's ``randint`` is the draw the native library
    reproduces: the same bits and the same state after, on a generator
    taken past a twist, checked once a process."""
    a, b = (torch.Generator().manual_seed(20240611) for _ in range(2))
    for g in (a, b):
        torch.randint(0, 2, (700,), generator=g)
    got = _native_probes(1300, 1, torch.float64, torch.device("cpu"), a)
    want = torch.randint(0, 2, (1300, 1), generator=b, dtype=torch.int8)
    return (got is not None and torch.equal(got, 2.0 * want.double() - 1.0)
            and torch.equal(a.get_state(), b.get_state()))


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
