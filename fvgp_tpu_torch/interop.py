"""Carry a model's state from the JAX package to the port.

``gp_from_numpy_state`` takes what the JAX ``GP`` exposes through its public
properties — as numpy, so this module never imports JAX — and builds a port
``GP`` that computes the same thing.
"""

import numpy as np

from .models.gp import GP
from .parallel.ordering import morton_order

__all__ = ["gp_from_numpy_state"]


def gp_from_numpy_state(state, compute_device="cpu"):
    """A port ``GP(gp2Scale=True)`` from a state dict with ``x_data``,
    ``y_data``, ``noise_variances`` (or None), ``hyperparameters``, ``args``
    and optionally ``linalg_mode`` and ``gp2Scale_batch_size``.

    The JAX model's ``x_data`` is already Morton-ordered, so the port keeps
    that order (``gp2Scale_reorder=False``) after checking that the reorder
    would be the identity — a state whose order differs raises instead of
    silently changing the tile blocking."""
    x = np.asarray(state["x_data"], dtype=np.float64)
    y = np.asarray(state["y_data"], dtype=np.float64)
    if y.ndim == 2 and y.shape[1] == 1:
        y = y[:, 0]
    nv = state.get("noise_variances")
    args = dict(state.get("args") or {})
    if args.get("gp2Scale_reorder", True) and not np.array_equal(
            morton_order(x), np.arange(len(x))):
        raise ValueError("gp_from_numpy_state: x_data is not in Morton "
                         "order; pass the gp2Scale model's own x_data")
    args["gp2Scale_reorder"] = False
    return GP(x, y,
              init_hyperparameters=np.asarray(state["hyperparameters"],
                                              dtype=np.float64),
              noise_variances=None if nv is None else np.asarray(
                  nv, dtype=np.float64),
              compute_device=compute_device, gp2Scale=True,
              gp2Scale_batch_size=state.get("gp2Scale_batch_size", 10000),
              linalg_mode=state.get("linalg_mode"), args=args)
