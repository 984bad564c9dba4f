"""Block-sparse structure of the gp2Scale covariance (host, numpy) — the
parts of ``fvgp_tpu/parallel/sharded_cov.py`` the single-device path needs:
the bounding-box candidate prune, the tile-count bucket, the kernel's
support geometry and the stable kernel closure.
"""

import warnings

import numpy as np

from ..kernels import wendland_anisotropic

warnings.filterwarnings("once", category=UserWarning,
                        module=r"fvgp_tpu_torch(\..*)?")


def _candidate_pairs(x1, x2, lengthscales, radius, block_size, symmetric):
    """Tile pairs whose whitened bounding boxes are within the support
    radius (upper triangle when ``symmetric``).  Bounds and the symmetric
    prune come from the native runtime (numpy fallback inside it)."""
    from ..native import block_bounds, candidate_pairs
    if lengthscales is not None:
        x1 = x1 / lengthscales
        x2 = x2 if x2 is None else x2 / lengthscales
    if symmetric and np.isfinite(radius):
        lo1, hi1 = block_bounds(x1, block_size)
        return candidate_pairs(lo1, hi1, radius)
    lo1, hi1 = block_bounds(x1, block_size)
    if symmetric:
        lo2, hi2 = lo1, hi1
    else:
        lo2, hi2 = block_bounds(x2, block_size)
    # box-to-box gap per dimension: max(lo2-hi1, lo1-hi2, 0)
    gap = np.maximum(lo2[None, :, :] - hi1[:, None, :],
                     lo1[:, None, :] - hi2[None, :, :])
    gap = np.maximum(gap, 0.0)
    dist2 = np.sum(gap ** 2, axis=-1)
    keep = dist2 <= radius ** 2
    if symmetric:
        keep = np.triu(keep)            # upper triangle only
    rows, cols = np.nonzero(keep)
    return rows.astype(np.int32), cols.astype(np.int32)


def _bucket(n, multiple=64):
    """Round a tile count up so repeated shapes recur across occupancy
    changes: next multiple of max(64, n/8)."""
    if n <= multiple:
        return multiple
    step = max(multiple, 1 << (int(n - 1).bit_length() - 3))
    return -(-n // step) * step


def support_geometry(prior, hyperparameters, args):
    """(lengthscales, radius) for the bounding-box prune, or (None, inf).

    The Wendland kernel implies radius 1 in coordinates whitened by
    hps[1:].  User kernels declare their support via
    ``args['gp2Scale_lengthscales']`` (callable hps -> per-dim scales) and
    ``args['gp2Scale_support_radius']`` (whitened radius, default 1.0).
    Without a declaration every tile is computed, with a one-time warning.
    """
    hps = np.asarray(hyperparameters, dtype=np.float64)
    ls_fn = args.get("gp2Scale_lengthscales", None)
    if callable(ls_fn):
        return (np.asarray(ls_fn(hps)),
                float(args.get("gp2Scale_support_radius", 1.0)))
    if getattr(prior, "kernel", None) is wendland_anisotropic:
        return hps[1:], 1.0
    warnings.warn(
        "gp2Scale: the kernel's support is unknown, so no tile pruning is "
        "possible and every covariance tile will be computed. Declare the "
        "support via args['gp2Scale_lengthscales'] (callable hps -> scales) "
        "and args['gp2Scale_support_radius'] to enable sparsity.")
    return None, np.inf


def _stable_kernel_closure(prior):
    """The prior's kernel as a 3-argument callable ``k(x1, x2, hps)``;
    4-argument kernels close over the prior's CURRENT args dict, rebuilt
    when ``set_args`` rebinds it."""
    if prior.k_n_params != 4:
        return prior.kernel
    cached = getattr(prior, "_gp2_kernel_closure", None)
    a_dict = prior.args
    if cached is not None and cached[0] is a_dict:
        return cached[1]
    kernel = prior.kernel

    def kern_fn(a, b, h):
        return kernel(a, b, h, a_dict)

    prior._gp2_kernel_closure = (a_dict, kern_fn)
    return kern_fn
