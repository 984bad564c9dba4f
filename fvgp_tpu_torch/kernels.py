"""Covariance kernels of the gp2Scale path, on torch tensors
(counterpart of ``fvgp_tpu/kernels.py``).

Kernels broadcast over leading batch dimensions: ``x1`` (..., n1, D) and
``x2`` (..., n2, D) give (..., n1, n2), so one call evaluates a whole chunk
of covariance tiles.  Distances use exact per-dimension differences, never
the ``|a|² + |b|² - 2ab`` matmul expansion: the expansion loses the diagonal
to cancellation (and to TF32 when a card runs float32 matmuls in it).
"""

import torch

__all__ = ["get_distance_matrix", "get_anisotropic_distance_matrix",
           "wendland_kernel", "wendland_anisotropic"]


def _sq_dist(x1, x2):
    """Squared Euclidean distances from exact per-dimension differences."""
    diff = x1[..., :, None, :] - x2[..., None, :, :]
    return torch.sum(diff * diff, dim=-1)


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
