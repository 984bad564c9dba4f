"""Matrix-free Krylov solvers over an abstract matvec: multi-RHS CG and
MINRES (counterpart of ``fvgp_tpu/ops/krylov.py``).

Two calling conventions, as in the JAX package:

* ``cg(matvec, b)`` with a closure ``matvec(X)``;
* ``cg(matvec_fn, b, operator=data)`` with a function called as
  ``matvec_fn(data, X)`` — the form the linear-algebra state uses, so the
  operator's tensors travel beside the function.  The same for the
  preconditioner: ``M`` / ``m_operator``.

Both solvers iterate on an (n, k) block and track per-column convergence
with masks, so k solves cost one pipeline.  The loops are Python loops that
read the exit test on the host once per iteration and keep the JAX
package's exit rule, so iteration counts agree with it in float64.
"""

import torch

__all__ = ["cg", "minres", "make_dense_matvec", "dense_matvec"]


def make_dense_matvec(A):
    """The closure convention's matvec of a dense operator."""
    return lambda X: A @ X


def dense_matvec(A, X):
    """The matvec of a dense operator, for the operator convention."""
    return A @ X


def _normalize(matvec, operator, M, m_operator):
    """Both conventions reduced to closures ``mv(X)``, ``m(X)``."""
    mv = matvec if operator is None else (lambda X: matvec(operator, X))
    if M is None:
        m = None
    elif m_operator is None:
        m = M
    else:
        m = lambda X: M(m_operator, X)                      # noqa: E731
    return mv, m


def _prep_rhs(b, x0):
    """(B (n, k), X0 (n, k), squeeze): a 1-d ``b`` becomes one column; a warm
    start of another shape is zero-padded or truncated."""
    squeeze = b.dim() == 1
    B = b[:, None] if squeeze else b
    if x0 is None:
        return B, torch.zeros_like(B), squeeze
    X0 = torch.as_tensor(x0, dtype=B.dtype, device=B.device)
    if X0.dim() == 1:
        X0 = X0[:, None]
    if X0.shape != B.shape:
        Z = torch.zeros_like(B)
        r = min(X0.shape[0], B.shape[0])
        c = min(X0.shape[1], B.shape[1])
        Z[:r, :c] = X0[:r, :c]
        X0 = Z
    return B, X0, squeeze


def _col_norm(R):
    return torch.sqrt(torch.sum(R * R, dim=0))


def _cg_impl(mv, m, B, X0, tol, maxiter):
    """Preconditioned CG on a block of RHS columns with per-column
    masking; returns (X, iterations)."""
    bnorm = _col_norm(B)
    # a zero RHS column has solution 0 exactly; a warm start there would
    # leave rnorm = |A x0| > atol ~ 0 forever and drag the block to maxiter
    X = torch.where((bnorm == 0.0)[None, :], torch.zeros_like(X0), X0)
    R = B - mv(X)
    Z = R if m is None else m(R)
    P = Z
    rz = torch.sum(R * Z, dim=0)
    atol = tol * torch.clamp(bnorm, min=1e-300)
    one = torch.ones((), dtype=B.dtype, device=B.device)
    zero = torch.zeros((), dtype=B.dtype, device=B.device)
    i = 0
    while i < maxiter:
        active = _col_norm(R) > atol
        if not bool(active.any()):
            break
        Ap = mv(P)
        pAp = torch.sum(P * Ap, dim=0)
        alpha = torch.where(pAp > 0, rz / torch.where(pAp == 0, one, pAp),
                            zero)
        alpha = torch.where(active, alpha, zero)
        X = X + alpha[None, :] * P
        R = R - alpha[None, :] * Ap
        Z = R if m is None else m(R)
        rz_new = torch.sum(R * Z, dim=0)
        beta = torch.where(rz > 0, rz_new / torch.where(rz == 0, one, rz),
                           zero)
        beta = torch.where(active, beta, zero)
        P = Z + beta[None, :] * P
        rz = rz_new
        i += 1
    return X, i


def cg(matvec, b, x0=None, M=None, tol=1e-5, maxiter=None, operator=None,
       m_operator=None, with_info=False):
    """Conjugate gradients for SPD systems.

    Parameters
    ----------
    matvec : closure (n, k) -> (n, k), or fn(data, X) with ``operator``
    b : (n,) or (n, k) tensor of right-hand sides
    x0 : warm start
    M : preconditioner — closure or fn(data, X) with ``m_operator``
    with_info : also return ``{"iterations": n}``
    """
    B, X0, squeeze = _prep_rhs(b, x0)
    if maxiter is None:
        maxiter = 10 * B.shape[0]
    mv, m = _normalize(matvec, operator, M, m_operator)
    with torch.no_grad():
        X, iters = _cg_impl(mv, m, B, X0, float(tol), int(maxiter))
    X = X[:, 0] if squeeze else X
    if with_info:
        return X, {"iterations": int(iters)}
    return X


def _minres_impl(mv, m, B, X0, tol, maxiter):
    """MINRES on a block of RHS columns (symmetric, possibly indefinite):
    Lanczos + Givens rotations, vectorized over columns."""
    n, k = B.shape
    dt, dev = B.dtype, B.device
    bnorm = _col_norm(B)
    X = torch.where((bnorm == 0.0)[None, :], torch.zeros_like(X0), X0)
    R1 = B - mv(X)
    Y = R1 if m is None else m(R1)
    eps = torch.finfo(dt).eps
    ry = torch.sum(R1 * Y, dim=0)
    # a genuinely negative r·M⁻¹r means the preconditioner is indefinite and
    # the Lanczos process breaks down.  Clamping it to 0 would return the warm
    # start as "converged"; the column is poisoned with NaN instead
    neg_scale = torch.sum(R1.abs() * Y.abs(), dim=0)
    bad = ry < -1e3 * eps * neg_scale
    nan = torch.full((), float("nan"), dtype=dt, device=dev)
    beta1 = torch.where(bad, nan, torch.sqrt(torch.clamp(ry, min=0.0)))
    X = torch.where(bad[None, :], nan, X)
    atol = tol * torch.clamp(bnorm, min=1e-300)
    one = torch.ones((), dtype=dt, device=dev)

    R2 = R1
    beta = beta1
    oldb = torch.zeros(k, dtype=dt, device=dev)
    dbar = torch.zeros(k, dtype=dt, device=dev)
    epsln = torch.zeros(k, dtype=dt, device=dev)
    phibar = beta1
    cs = -torch.ones(k, dtype=dt, device=dev)
    sn = torch.zeros(k, dtype=dt, device=dev)
    W = torch.zeros((n, k), dtype=dt, device=dev)
    W2 = torch.zeros((n, k), dtype=dt, device=dev)
    i = 0
    while i < maxiter:
        active = phibar.abs() > atol
        if not bool(active.any()):
            break
        safe_beta = torch.where(beta == 0, one, beta)
        V = Y / safe_beta[None, :]
        Yv = mv(V)
        if i >= 1:
            Yv = Yv - (beta / torch.where(oldb == 0, one, oldb))[None, :] * R1
        alfa = torch.sum(V * Yv, dim=0)
        Yv = Yv - (alfa / safe_beta)[None, :] * R2
        R1, R2 = R2, Yv
        Y = Yv if m is None else m(Yv)
        oldb = beta
        beta = torch.sqrt(torch.clamp(torch.sum(R2 * Y, dim=0), min=0.0))

        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln = sn * beta
        dbar = -cs * beta
        gamma = torch.clamp(torch.sqrt(gbar ** 2 + beta ** 2), min=eps)
        cs = gbar / gamma
        sn = beta / gamma
        phi = cs * phibar
        phibar = sn * phibar

        W1, W2 = W2, W
        W = (V - oldeps[None, :] * W1 - delta[None, :] * W2) \
            * (1.0 / gamma)[None, :]
        X = X + (phi * active.to(dt))[None, :] * W
        i += 1
    return X


def minres(matvec, b, x0=None, M=None, tol=1e-5, maxiter=None, operator=None,
           m_operator=None):
    """MINRES for symmetric systems.  Calling conventions as :func:`cg`."""
    B, X0, squeeze = _prep_rhs(b, x0)
    if maxiter is None:
        maxiter = 10 * B.shape[0]
    mv, m = _normalize(matvec, operator, M, m_operator)
    with torch.no_grad():
        X = _minres_impl(mv, m, B, X0, float(tol), int(maxiter))
    return X[:, 0] if squeeze else X
