"""Covariance kernels on torch tensors (counterpart of
``fvgp_tpu/kernels.py``).

Kernels broadcast over leading batch dimensions: ``x1`` (..., n1, D) and
``x2`` (..., n2, D) give (..., n1, n2), so one call evaluates a whole chunk
of covariance tiles.  Distances use exact per-dimension differences for
D <= 32, never the ``|a|² + |b|² - 2ab`` matmul expansion: the expansion
loses the diagonal to cancellation (and to TF32 when a card runs float32
matmuls in it).  Above D = 32 (deep-kernel embeddings) the expansion is
used, as in the JAX package.

:func:`default_matern_ard`, the dense GP's default kernel, evaluates its
2-D CUDA covariances that no derivative follows with the hand-written K3
kernel (``ops/hopper_kernels.dense_covariance``); everything else — the
CPU, batched inputs, every evaluation that autograd records, and every
input that carries a forward-mode tangent (``torch.autograd.forward_ad``,
as the posterior gradients' ``d_kernel_dx`` uses) and every input wrapped by
a ``torch.func`` transform — takes the plain formula.
K3 is a launch with no derivative rule: a dual input would lose its
tangent there.
"""

import math

import torch
from torch.autograd import forward_ad

__all__ = [
    "squared_exponential_kernel", "squared_exponential_kernel_robust",
    "exponential_kernel", "exponential_kernel_robust",
    "matern_kernel_diff1", "matern_kernel_diff1_grad",
    "matern_kernel_diff1_robust", "matern_kernel_diff2",
    "matern_kernel_diff2_robust", "sparse_kernel", "periodic_kernel",
    "get_distance_matrix", "get_anisotropic_distance_matrix",
    "wendland_kernel", "wendland_anisotropic", "default_matern_ard"]

_EXACT_MAX_DIM = 32


def _sq_dist(x1, x2):
    """Squared Euclidean distances: exact per-dimension differences for
    D <= 32, the matmul expansion (clipped at 0) above."""
    if x1.shape[-1] <= _EXACT_MAX_DIM:
        diff = x1[..., :, None, :] - x2[..., None, :, :]
        return torch.sum(diff * diff, dim=-1)
    n1 = torch.sum(x1 * x1, dim=-1)[..., :, None]
    n2 = torch.sum(x2 * x2, dim=-1)[..., None, :]
    return torch.clamp(n1 + n2 - 2.0 * (x1 @ x2.transpose(-1, -2)), min=0.0)


def _safe_sqrt(d2):
    """sqrt with a zero (not NaN) gradient at d2 == 0, so the gradient of a
    stationary kernel is finite on the diagonal."""
    positive = d2 > 0.0
    return torch.where(positive,
                       torch.sqrt(torch.where(positive, d2,
                                              torch.ones_like(d2))),
                       torch.zeros_like(d2))


def get_distance_matrix(x1, x2):
    """Pairwise Euclidean distance matrix."""
    return _safe_sqrt(_sq_dist(x1, x2))


def get_anisotropic_distance_matrix(x1, x2, hps):
    """Axial-anisotropic distance: coordinates whitened by ``hps`` per axis."""
    return get_distance_matrix(x1 / hps, x2 / hps)


# ---------------------------------------------------------------------------
# stationary kernels of a distance matrix
# ---------------------------------------------------------------------------

_SQRT3 = 1.7320508075688772
_SQRT5 = 2.23606797749979


def squared_exponential_kernel(distance, length):
    """k = exp(-d²/(2 l²))."""
    return torch.exp(-(distance ** 2) / (2.0 * (length ** 2)))


def squared_exponential_kernel_robust(distance, phi):
    """k = exp(-d² φ²) — the 1/l² → φ² reparameterization."""
    return torch.exp(-(distance ** 2) * (phi ** 2))


def exponential_kernel(distance, length):
    """k = exp(-d/l)."""
    return torch.exp(-distance / length)


def exponential_kernel_robust(distance, phi):
    """k = exp(-d φ²)."""
    return torch.exp(-distance * (phi ** 2))


def matern_kernel_diff1(distance, length):
    """Matérn ν=3/2: (1+√3 d/l) exp(-√3 d/l)."""
    a = _SQRT3 * distance / length
    return (1.0 + a) * torch.exp(-a)


def matern_kernel_diff1_grad(distance, dist_der):
    """d/dl of Matérn-3/2 given d(distance)/d(hp): a catalog helper for
    user kernels that supply their own gradients (the port's own paths
    differentiate by autograd)."""
    a = _SQRT3 * distance
    dadl = _SQRT3 * dist_der
    ea = torch.exp(-a)
    return dadl * ea - (1.0 + a) * dadl * ea


def matern_kernel_diff1_robust(distance, phi):
    """Matérn-3/2 with 1/l → φ²."""
    a = _SQRT3 * distance * (phi ** 2)
    return (1.0 + a) * torch.exp(-a)


def matern_kernel_diff2(distance, length):
    """Matérn ν=5/2."""
    a = _SQRT5 * distance / length
    return (1.0 + a + (5.0 * distance ** 2) / (3.0 * length ** 2)) \
        * torch.exp(-a)


def matern_kernel_diff2_robust(distance, phi):
    """Matérn-5/2 robust form, with fvGP's published 5·3 φ⁴ coefficient."""
    a = _SQRT5 * distance * (phi ** 2)
    return (1.0 + a + (5.0 * distance ** 2) * (3.0 * phi ** 4)) \
        * torch.exp(-a)


def sparse_kernel(distance, radius):
    """Compactly supported spherical kernel."""
    d = torch.as_tensor(distance)
    if not d.is_floating_point():
        d = d.to(torch.get_default_dtype())
    d = torch.where(d == 0.0, torch.full_like(d, 1e-5), d)
    d = torch.minimum(d, torch.as_tensor(radius, dtype=d.dtype,
                                         device=d.device))
    u = d / radius
    root = torch.sqrt(torch.clamp(1.0 - u ** 2, min=0.0))
    return (math.sqrt(2.0) / (3.0 * math.sqrt(math.pi))) * (
        (3.0 * u ** 2 * torch.log(u / (1.0 + root)))
        + ((2.0 * u ** 2 + 1.0) * root))


def periodic_kernel(distance, length, p):
    """k = exp(-2 sin²(π d / p)/l²)."""
    return torch.exp(-(2.0 / length ** 2)
                     * (torch.sin(math.pi * distance / p) ** 2))


# ---------------------------------------------------------------------------
# Wendland (compact support — the gp2Scale default)
# ---------------------------------------------------------------------------

def _wendland_poly(d):
    """C⁴ Wendland polynomial on the clipped distance."""
    d = torch.clamp(d, max=1.0)
    return (1.0 - d) ** 8 * (32.0 * d ** 3 + 25.0 * d ** 2 + 8.0 * d + 1.0)


def wendland_kernel(d):
    """Wendland kernel of a pre-computed distance matrix."""
    return _wendland_poly(d)


def wendland_anisotropic(x1, x2, hyperparameters):
    """Anisotropic Wendland: hps = [signal variance, l_1..l_D]."""
    d = get_anisotropic_distance_matrix(x1, x2, hyperparameters[1:])
    return hyperparameters[0] * _wendland_poly(d)


# ---------------------------------------------------------------------------
# default GP kernel (anisotropic Matérn-3/2 ARD)
# ---------------------------------------------------------------------------

def _k3_applies(x1, x2, hps):
    """True when K3 computes this covariance: 2-D float32/float64 CUDA
    inputs of one dtype and device, D <= 32, autograd recording none of
    x1, x2, hps, none of them carrying a forward-mode tangent, and none
    of them wrapped by a ``torch.func`` transform (``vmap``, ``jacrev``,
    ``jvp``: K3 reads raw pointers, which a wrapper does not expose)."""
    if not (x1.is_cuda and x1.dim() == 2 and x2.dim() == 2
            and x1.dtype in (torch.float32, torch.float64)
            and x2.dtype == x1.dtype and x2.device == x1.device
            and x1.shape[1] <= _EXACT_MAX_DIM):
        return False
    if any(forward_ad.unpack_dual(t).tangent is not None
           or (torch.is_tensor(t)
               and torch._C._functorch.is_functorch_wrapped_tensor(t))
           for t in (x1, x2, hps)):
        return False
    return not (torch.is_grad_enabled()
                and (x1.requires_grad or x2.requires_grad
                     or hps.requires_grad))


def _k3_hyperparameters(hps, dim):
    """The ``[signal variance, l_1..l_D]`` vector that makes K3 compute the
    plain formula at ``hps``, or None.  The formula divides the points by
    ``hps[1:]`` with broadcasting, so besides D lengthscales it takes one
    lengthscale for every dimension, and, on one input dimension, several
    trailing entries that act as pseudo-dimensions (GGMP's constant mean
    puts its mean there): Σ_j ((x − x')/l_j)² = (x − x')² Σ_j l_j⁻², one
    lengthscale (Σ_j l_j⁻²)^(−1/2)."""
    if hps.dim() != 1 or hps.shape[0] < 2:
        return None
    ls = hps[1:]
    if ls.shape[0] == dim:
        return hps
    if ls.shape[0] == 1:
        return torch.cat([hps[:1], ls.expand(dim)])
    if dim == 1:
        return torch.stack([hps[0], torch.rsqrt(torch.sum(ls ** -2))])
    return None


def default_matern_ard(x1, x2, hyperparameters):
    """The default kernel: hps[0] · Matérn-3/2 of the anisotropic distance,
    one lengthscale per input dimension.

    Differentiable by autograd and forward-mode AD (the plain formula); a
    2-D CUDA covariance that no derivative follows runs the K3 kernel
    instead, with the lengthscales the formula's broadcast gives
    (:func:`_k3_hyperparameters`)."""
    hps = torch.as_tensor(hyperparameters, dtype=x1.dtype, device=x1.device)
    if _k3_applies(x1, x2, hps):
        k3_hps = _k3_hyperparameters(hps, x1.shape[1])
        if k3_hps is not None:
            from .ops.hopper_kernels import dense_covariance
            return dense_covariance(x1, x2, k3_hps, kind="matern32")
    d = get_anisotropic_distance_matrix(x1, x2, hps[1:])
    return hps[0] * matern_kernel_diff1(d, 1.0)
