"""Carry a model's state from the JAX package to the port.

``gp_from_numpy_state`` takes what the JAX ``GP`` exposes through its public
properties — as numpy, so this module never imports JAX — and builds a port
``GP`` that computes the same thing.
"""

import numpy as np

from .models.gp import GP
from .parallel.block_sparse import from_numpy_state
from .parallel.ordering import morton_order

__all__ = ["gp_from_numpy_state"]


def gp_from_numpy_state(state, compute_device="cuda"):
    """A port ``GP`` from a state dict with ``x_data``, ``y_data``,
    ``noise_variances`` (or None), ``hyperparameters``, ``args`` and
    optionally ``gp2Scale`` (default True), ``linalg_mode`` and
    ``gp2Scale_batch_size``.  The default kernel, mean and noise of the
    model kind are used.  A gp2Scale state may carry ``K``: the numpy dict
    that the JAX ``BlockSparseMatrix.__getstate__`` gives (``n``,
    ``n_cols``, ``block_size``, ``rows``, ``cols``, ``tiles``, ``diag``),
    which becomes the model's stored covariance, so both packages solve
    against one stored operator.

    A gp2Scale model's ``x_data`` is already Morton-ordered, so the port
    keeps that order (``gp2Scale_reorder=False``) after checking that the
    reorder would be the identity — a state whose order differs raises
    instead of silently changing the tile blocking.  A dense state
    (``gp2Scale`` False) keeps its order as it is."""
    x = np.asarray(state["x_data"], dtype=np.float64)
    y = np.asarray(state["y_data"], dtype=np.float64)
    if y.ndim == 2 and y.shape[1] == 1:
        y = y[:, 0]
    nv = state.get("noise_variances")
    args = dict(state.get("args") or {})
    gp2Scale = bool(state.get("gp2Scale", True))
    if gp2Scale:
        if args.get("gp2Scale_reorder", True) and not np.array_equal(
                morton_order(x), np.arange(len(x))):
            raise ValueError("gp_from_numpy_state: x_data is not in Morton "
                             "order; pass the gp2Scale model's own x_data")
        args["gp2Scale_reorder"] = False
    gp = GP(x, y,
            init_hyperparameters=np.asarray(state["hyperparameters"],
                                            dtype=np.float64),
            noise_variances=None if nv is None else np.asarray(
                nv, dtype=np.float64),
            compute_device=compute_device, gp2Scale=gp2Scale,
            gp2Scale_batch_size=state.get("gp2Scale_batch_size", 10000),
            linalg_mode=state.get("linalg_mode"), args=args)
    if gp2Scale and state.get("K") is not None:
        gp.prior.K = from_numpy_state(state["K"], device=gp.device)
    return gp
