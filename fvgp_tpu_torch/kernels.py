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

The rest of the JAX package's catalog is here with its signatures: the
dot-product family, fvGP's cpu / gpu / sparse names of the Wendland kernel
(``wendland_anisotropic_gp2Scale_cpu_sparse`` is a host callable returning a
``scipy.sparse.coo_matrix``), the non-stationary ``g(x1) g(x2)`` kernel and
its explicit gradient, the 1-d Wasserstein distances, ``bump`` and the
4-argument landmark kernel ``sle_kernel``.

Like the JAX catalog, every function takes host arrays: a numpy array or a
list becomes a tensor on the device and in the dtype of a tensor argument
(on the default backend, the card where there is one, where there is none),
and the result is a tensor.
"""

import functools
import math

import numpy as np
import torch
from torch.autograd import forward_ad

from . import config

__all__ = [
    "squared_exponential_kernel", "squared_exponential_kernel_robust",
    "exponential_kernel", "exponential_kernel_robust",
    "matern_kernel_diff1", "matern_kernel_diff1_grad",
    "matern_kernel_diff1_robust", "matern_kernel_diff2",
    "matern_kernel_diff2_robust", "sparse_kernel", "periodic_kernel",
    "linear_kernel", "dot_product_kernel", "polynomial_kernel",
    "get_distance_matrix", "get_anisotropic_distance_matrix",
    "wendland_kernel", "wendland_anisotropic", "default_matern_ard",
    "wendland_anisotropic_gp2Scale_cpu", "wendland_anisotropic_gp2Scale_gpu",
    "wendland_anisotropic_tpu", "wendland_anisotropic_gp2Scale_cpu_sparse",
    "wendland_anisotropic_gp2Scale_gpu_sparse", "non_stat_kernel",
    "non_stat_kernel_gradient", "wasserstein_1d", "wasserstein_1d_outer_vec",
    "bump", "sle_kernel"]

_EXACT_MAX_DIM = 32


def _host_inputs(fn):
    """``fn`` taking host arrays as the JAX catalog does: a host array
    (``config.HOST_ARRAYS``) becomes a tensor by ``config.tensor_operand``
    on the device and in the dtype of the first floating tensor argument
    (a tensor keeps its device, host arrays beside it follow it there), and
    where there is none on the default backend in numpy's dtype; tensors,
    numbers and other objects pass as they are.  The result is a tensor."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        values = (*args, *kwargs.values())
        if not any(isinstance(a, config.HOST_ARRAYS) for a in values):
            return fn(*args, **kwargs)
        like = next((a for a in values if torch.is_tensor(a)
                     and a.is_floating_point()), None)

        def tensor(a):
            return config.tensor_operand(a, like=like) \
                if isinstance(a, config.HOST_ARRAYS) else a
        return fn(*map(tensor, args),
                  **{k: tensor(v) for k, v in kwargs.items()})
    return wrapper


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


@_host_inputs
def get_distance_matrix(x1, x2):
    """Pairwise Euclidean distance matrix."""
    return _safe_sqrt(_sq_dist(x1, x2))


@_host_inputs
def get_anisotropic_distance_matrix(x1, x2, hps):
    """Axial-anisotropic distance: coordinates whitened by ``hps`` per axis."""
    return get_distance_matrix(x1 / hps, x2 / hps)


# ---------------------------------------------------------------------------
# stationary kernels of a distance matrix
# ---------------------------------------------------------------------------

_SQRT3 = 1.7320508075688772
_SQRT5 = 2.23606797749979


@_host_inputs
def squared_exponential_kernel(distance, length):
    """k = exp(-d²/(2 l²))."""
    return torch.exp(-(distance ** 2) / (2.0 * (length ** 2)))


@_host_inputs
def squared_exponential_kernel_robust(distance, phi):
    """k = exp(-d² φ²) — the 1/l² → φ² reparameterization."""
    return torch.exp(-(distance ** 2) * (phi ** 2))


@_host_inputs
def exponential_kernel(distance, length):
    """k = exp(-d/l)."""
    return torch.exp(-distance / length)


@_host_inputs
def exponential_kernel_robust(distance, phi):
    """k = exp(-d φ²)."""
    return torch.exp(-distance * (phi ** 2))


@_host_inputs
def matern_kernel_diff1(distance, length):
    """Matérn ν=3/2: (1+√3 d/l) exp(-√3 d/l)."""
    a = _SQRT3 * distance / length
    return (1.0 + a) * torch.exp(-a)


@_host_inputs
def matern_kernel_diff1_grad(distance, dist_der):
    """d/dl of Matérn-3/2 given d(distance)/d(hp): a catalog helper for
    user kernels that supply their own gradients (the port's own paths
    differentiate by autograd)."""
    a = _SQRT3 * distance
    dadl = _SQRT3 * dist_der
    ea = torch.exp(-a)
    return dadl * ea - (1.0 + a) * dadl * ea


@_host_inputs
def matern_kernel_diff1_robust(distance, phi):
    """Matérn-3/2 with 1/l → φ²."""
    a = _SQRT3 * distance * (phi ** 2)
    return (1.0 + a) * torch.exp(-a)


@_host_inputs
def matern_kernel_diff2(distance, length):
    """Matérn ν=5/2."""
    a = _SQRT5 * distance / length
    return (1.0 + a + (5.0 * distance ** 2) / (3.0 * length ** 2)) \
        * torch.exp(-a)


@_host_inputs
def matern_kernel_diff2_robust(distance, phi):
    """Matérn-5/2 robust form, with fvGP's published 5·3 φ⁴ coefficient."""
    a = _SQRT5 * distance * (phi ** 2)
    return (1.0 + a + (5.0 * distance ** 2) * (3.0 * phi ** 4)) \
        * torch.exp(-a)


@_host_inputs
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


@_host_inputs
def periodic_kernel(distance, length, p):
    """k = exp(-2 sin²(π d / p)/l²)."""
    return torch.exp(-(2.0 / length ** 2)
                     * (torch.sin(math.pi * distance / p) ** 2))


# ---------------------------------------------------------------------------
# dot-product family
# ---------------------------------------------------------------------------

def _reversed_axes(x):
    """numpy's ``x.T`` (every axis reversed) on a tensor."""
    return x.permute(*reversed(range(x.dim())))


@_host_inputs
def linear_kernel(x1, x2, hp1, hp2, hp3):
    """k = hp1 + hp2 (x1-hp3)(x2-hp3)."""
    return hp1 + (hp2 * (x1 - hp3) * (x2 - hp3))


@_host_inputs
def dot_product_kernel(x1, x2, hp, matrix):
    """k = hp + x1ᵀ M x2."""
    return hp + _reversed_axes(x1) @ matrix @ x2


@_host_inputs
def polynomial_kernel(x1, x2, p):
    """k = (1 + x1ᵀx2)^p."""
    return (1.0 + _reversed_axes(x1) @ x2) ** p


# ---------------------------------------------------------------------------
# Wendland (compact support — the gp2Scale default)
# ---------------------------------------------------------------------------

def _wendland_poly(d):
    """C⁴ Wendland polynomial on the clipped distance."""
    d = torch.clamp(d, max=1.0)
    return (1.0 - d) ** 8 * (32.0 * d ** 3 + 25.0 * d ** 2 + 8.0 * d + 1.0)


@_host_inputs
def wendland_kernel(d):
    """Wendland kernel of a pre-computed distance matrix."""
    return _wendland_poly(d)


@_host_inputs
def wendland_anisotropic(x1, x2, hyperparameters):
    """Anisotropic Wendland: hps = [signal variance, l_1..l_D]."""
    d = get_anisotropic_distance_matrix(x1, x2, hyperparameters[1:])
    return hyperparameters[0] * _wendland_poly(d)


# fvGP's cpu / gpu variants and the JAX package's TPU name of the same
# function (``parallel.sharded_cov.support_geometry`` knows the names)
wendland_anisotropic_tpu = wendland_anisotropic
wendland_anisotropic_gp2Scale_cpu = wendland_anisotropic
wendland_anisotropic_gp2Scale_gpu = wendland_anisotropic


def wendland_anisotropic_gp2Scale_cpu_sparse(x1, x2, hyperparameters):
    """The anisotropic Wendland kernel as a ``scipy.sparse.coo_matrix``
    holding only its nonzero entries: fvGP's sparse-kernel name and return
    type, for code that passes it as ``kernel_function``.  A host callable
    (float64 on the CPU, numpy or tensors in): the models densify its
    blocks, and the stored covariance exploits the sparsity by tiles."""
    from scipy.sparse import coo_matrix
    x1, x2, hps = (t.detach().cpu().double() if torch.is_tensor(t)
                   else torch.as_tensor(np.asarray(t, dtype=np.float64))
                   for t in (x1, x2, hyperparameters))
    k = wendland_anisotropic(x1, x2, hps).numpy()
    rows, cols = np.nonzero(k)
    return coo_matrix((k[rows, cols], (rows, cols)), shape=k.shape)


wendland_anisotropic_gp2Scale_gpu_sparse = \
    wendland_anisotropic_gp2Scale_cpu_sparse


# ---------------------------------------------------------------------------
# non-stationary g(x1) g(x2) kernel
# ---------------------------------------------------------------------------

@_host_inputs
def _g(x, x0, w, l):
    """g(x) = Σ_j w_j exp(-|x - x0_j|² / l)."""
    d = get_distance_matrix(x, x0)
    return torch.sum(w * torch.exp(-(d ** 2) / l), dim=1)


@_host_inputs
def non_stat_kernel(x1, x2, x0, w, l):
    """k = g(x1) g(x2) with the RBF basis g over the centres ``x0``."""
    return torch.outer(_g(x1, x0, w, l), _g(x2, x0, w, l))


@_host_inputs
def non_stat_kernel_gradient(x1, x2, x0, w, l):
    """∂k/∂(w, l) of :func:`non_stat_kernel`, (len(w) + 1, n1, n2): the
    ``w_j`` derivatives first, the ``l`` derivative last (a catalog helper;
    the port's own paths differentiate by autograd)."""
    d1 = get_distance_matrix(x1, x0)
    d2 = get_distance_matrix(x2, x0)
    e1 = torch.exp(-(d1 ** 2) / l)
    e2 = torch.exp(-(d2 ** 2) / l)
    g1 = torch.sum(w * e1, dim=1)
    g2 = torch.sum(w * e2, dim=1)
    dgdl1 = torch.sum(w * e1 * (d1 ** 2) / l ** 2, dim=1)
    dgdl2 = torch.sum(w * e2 * (d2 ** 2) / l ** 2, dim=1)
    dkdw = (torch.einsum("ij,k->ijk", e1.T, g2)
            + torch.einsum("ij,k->ikj", e2.T, g1))
    dkdl = torch.outer(dgdl1, g2) + torch.outer(dgdl2, g1).T
    return torch.cat([dkdw, dkdl[None]], dim=0)


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


@_host_inputs
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


# ---------------------------------------------------------------------------
# distributions as inputs; landmark embeddings
# ---------------------------------------------------------------------------

@_host_inputs
def wasserstein_1d(a, b):
    """W₁ between two unnormalized 1-d measures of equal length: each is
    normalized by its sum, then the mean |sorted difference|."""
    a = a.reshape(-1)
    b = b.reshape(-1)
    a = torch.sort(a / torch.sum(a)).values
    b = torch.sort(b / torch.sum(b)).values
    return torch.mean(torch.abs(a - b))


@_host_inputs
def wasserstein_1d_outer_vec(a, b):
    """Pairwise W₁ distances between two batches of unnormalized 1-d
    measures, rows normalized by their sums: a (N1, S), b (N2, S) →
    (N1, N2)."""
    a = torch.atleast_2d(a)
    b = torch.atleast_2d(b)
    a = torch.sort(a / torch.sum(a, dim=1, keepdim=True), dim=1).values
    b = torch.sort(b / torch.sum(b, dim=1, keepdim=True), dim=1).values
    return torch.mean(torch.abs(a[:, None, :] - b[None, :, :]), dim=-1)


@_host_inputs
def bump(d, r, beta=1., ampl=1.):
    """Smooth compactly supported bump: ampl·exp(β)·exp(-β/(1-(d/r)²))
    inside the support, 0 outside.  Both ``where``s matter: the inner one
    keeps the formula finite outside the support, so its gradient there is
    0 and not NaN."""
    u2 = (d / r) ** 2
    inside = u2 < 1.0
    one = torch.ones((), dtype=u2.dtype, device=u2.device)
    safe = torch.where(inside, 1.0 - u2, one)
    beta = torch.as_tensor(beta, dtype=u2.dtype, device=u2.device)
    vals = ampl * torch.exp(beta) * torch.exp(-beta / safe)
    return torch.where(inside, vals, torch.zeros_like(vals))


@_host_inputs
def sle_kernel(x1, x2, hps, args):
    """Sparse-landmark-embedding kernel: points embedded by bump similarity
    to the landmarks ``args['x_data']`` (else ``args['landmarks']``), then
    a squared exponential on the embedding.  hps = [amplitude, bump radius,
    bump sharpness β, length scale]; a 4-argument kernel."""
    landmarks = args["x_data"] if "x_data" in args else args["landmarks"]
    landmarks = torch.as_tensor(
        landmarks if torch.is_tensor(landmarks) else np.asarray(landmarks),
        dtype=x1.dtype, device=x1.device)
    e1 = bump(get_distance_matrix(x1, landmarks), hps[1], beta=hps[2])
    e2 = bump(get_distance_matrix(x2, landmarks), hps[1], beta=hps[2])
    D = get_distance_matrix(e1, e2)
    return hps[0] * torch.exp(-D ** 2 / hps[3])
