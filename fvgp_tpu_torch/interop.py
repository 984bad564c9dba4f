"""Carry a model's state from the JAX package to the port.

Each function takes what a JAX model exposes — its public properties, or
the numpy dict its ``__getstate__`` gives — as numpy, so this module never
imports JAX, and builds a port model that computes the same thing:
``gp_from_numpy_state`` (``GP``, ``fvGP``), ``gpm_from_numpy_state``,
``gplvm_from_numpy_state`` and ``ggmp_from_numpy_state``.  A deep kernel's
weights are part of its hyperparameter vector, so
``gp_from_numpy_state(state, kernel_function=make_deep_kernel(net))``
carries them across.
"""

import numpy as np

from .kernels import default_matern_ard
from .models import ggmp as _ggmp
from .models.fvgp import fvGP
from .models.gp import GP
from .models.gplvm import GPLVM
from .models.gpm import GPm
from .parallel.block_sparse import from_numpy_state
from .parallel.mesh import current_mesh
from .parallel.ordering import morton_order

__all__ = ["gp_from_numpy_state", "gpm_from_numpy_state",
           "gplvm_from_numpy_state", "ggmp_from_numpy_state"]


def gp_from_numpy_state(state, compute_device="cuda", kernel_function=None,
                        prior_mean_function=None):
    """A port ``GP`` (or ``fvGP``) from a state dict with ``x_data``,
    ``y_data``, ``noise_variances`` (or None), ``hyperparameters``, ``args``
    and optionally ``gp2Scale`` (default True), ``linalg_mode`` and
    ``gp2Scale_batch_size``.  The noise is the model kind's default, and so
    are the kernel and the mean unless given here (a non-Euclidean model
    needs its kernel).  A gp2Scale state may carry ``K``: the numpy dict that the JAX
    ``BlockSparseMatrix.__getstate__`` gives (``n``, ``n_cols``,
    ``block_size``, ``rows``, ``cols``, ``tiles``, ``diag``), which becomes
    the model's stored covariance, so both packages solve against one
    stored operator (under an active mesh of more than one rank each rank
    keeps the tiles of its own row blocks).

    * A multi-task state carries ``output_num`` and the untransformed
      ``fvgp_x_data``, ``fvgp_y_data`` and ``fvgp_noise_variances``: the
      port's ``fvGP`` is built from those, and its flattened product-space
      data must equal the state's ``x_data`` / ``y_data``.
    * A non-Euclidean state's ``x_data`` is a list of objects; it is kept
      as it is.
    * A Euclidean gp2Scale model's ``x_data`` is already Morton-ordered, so
      the port keeps that order (``gp2Scale_reorder=False``) after checking
      that the reorder would be the identity — a state whose order differs
      raises instead of silently changing the tile blocking.  A dense state
      (``gp2Scale`` False) keeps its order as it is."""
    args = dict(state.get("args") or {})
    gp2Scale = bool(state.get("gp2Scale", True))
    multitask = state.get("output_num") is not None
    euclidean = not isinstance(
        state["fvgp_x_data"] if multitask else state["x_data"], list)
    common = dict(
        init_hyperparameters=np.asarray(state["hyperparameters"],
                                        dtype=np.float64),
        compute_device=compute_device, gp2Scale=gp2Scale,
        gp2Scale_batch_size=state.get("gp2Scale_batch_size", 10000),
        linalg_mode=state.get("linalg_mode"), kernel_function=kernel_function,
        prior_mean_function=prior_mean_function)
    if multitask:
        nv = state.get("fvgp_noise_variances")
        x = state["fvgp_x_data"]
        gp = fvGP(np.asarray(x, dtype=np.float64) if euclidean else list(x),
                  np.asarray(state["fvgp_y_data"], dtype=np.float64),
                  noise_variances=None if nv is None
                  else np.asarray(nv, dtype=np.float64), args=args, **common)
        if gp.output_num != int(state["output_num"]):
            raise ValueError("gp_from_numpy_state: output_num disagrees with "
                             "fvgp_y_data")
        if euclidean and not (
                np.array_equal(np.asarray(gp.x_data),
                               np.asarray(state["x_data"]))
                and np.array_equal(np.asarray(gp.y_data).ravel(),
                                   np.asarray(state["y_data"]).ravel())):
            raise ValueError("gp_from_numpy_state: the multi-task state's "
                             "x_data / y_data are not the flattening of its "
                             "fvgp_* arrays")
    else:
        x = state["x_data"]
        x = np.asarray(x, dtype=np.float64) if euclidean else list(x)
        y = np.asarray(state["y_data"], dtype=np.float64)
        if y.ndim == 2 and y.shape[1] == 1:
            y = y[:, 0]
        nv = state.get("noise_variances")
        if gp2Scale and euclidean:
            if args.get("gp2Scale_reorder", True) and not np.array_equal(
                    morton_order(x), np.arange(len(x))):
                raise ValueError("gp_from_numpy_state: x_data is not in "
                                 "Morton order; pass the gp2Scale model's "
                                 "own x_data")
            args["gp2Scale_reorder"] = False
        gp = GP(x, y, noise_variances=None if nv is None
                else np.asarray(nv, dtype=np.float64), args=args, **common)
    if gp2Scale and state.get("K") is not None:
        # under an active mesh each rank keeps its row blocks' tiles
        gp.prior.K = from_numpy_state(state["K"], device=gp.device,
                                      mesh=current_mesh())
    return gp


def _from_getstate(cls, state, compute_device, kernel_function):
    """A port model from the numpy dict of the JAX model's
    ``__getstate__`` (its kernel callable left out or replaced)."""
    model = cls.__new__(cls)
    state = {k: v for k, v in state.items() if k != "kernel"}
    state["kernel"] = kernel_function or default_matern_ard
    state["device"] = compute_device
    model.__setstate__(state)
    return model


def gpm_from_numpy_state(state, compute_device="cuda", kernel_function=None):
    """A port ``GPm`` from the JAX ``GPm.__getstate__`` dict (``W``,
    ``_x``, ``_y``, ``_y_mean``, ``hyperparameters``, ``log_noise``, the
    sizes and ``train_embedding``); the kernel is the default unless given
    here."""
    return _from_getstate(GPm, state, compute_device, kernel_function)


def gplvm_from_numpy_state(state, compute_device="cuda",
                           kernel_function=None):
    """A port ``GPLVM`` from the JAX ``GPLVM.__getstate__`` dict (``X``,
    ``_y``, ``_y_mean``, ``hyperparameters``, ``log_noise``, the sizes,
    ``args`` and ``_mcmc_info``); the kernel is the default unless given
    here."""
    return _from_getstate(GPLVM, state, compute_device, kernel_function)


def ggmp_from_numpy_state(state, compute_device="cuda"):
    """A port ``GGMP`` from a numpy dict: the constructor's ``x_data``,
    ``y_data`` and ``likelihood_terms``, the ``hyperparameters`` container's
    ``weights``, ``weights_bounds``, ``hps`` and ``hps_bounds``,
    ``likelihoods`` (one dict of ``mean``, ``variance`` and ``weight`` per
    component), ``gps`` (one ``gp_from_numpy_state`` dict per component)
    and optionally ``gp_eval_parallel``.  The components take ``GGMP``'s
    defaults: the default kernel and, single-task, ``constant_mean``
    (multi-task: fvGP's default mean)."""
    K = int(state["likelihood_terms"])
    hps_obj = _ggmp.hyperparameters(
        np.asarray(state["weights"], dtype=float),
        np.asarray(state["weights_bounds"], dtype=float),
        [np.asarray(h, dtype=float) for h in state["hps"]],
        [np.asarray(b, dtype=float) for b in state["hps_bounds"]])
    model = _ggmp.GGMP(state["x_data"], state["y_data"], hps_obj=hps_obj,
                       likelihood_terms=K,
                       gp_init_kwargs={"compute_device": compute_device},
                       gp_eval_parallel=state.get("gp_eval_parallel", False))
    model.initLikelihoods()
    for lk, saved in zip(model.likelihoods, state["likelihoods"]):
        lk.set_moments(np.asarray(saved["mean"], dtype=float),
                       np.asarray(saved["variance"], dtype=float))
        lk.set_weight(float(saved["weight"]))
    gps = [gp_from_numpy_state(
        gp_state, compute_device=compute_device,
        kernel_function=model.gp_kernel_functions[k],
        prior_mean_function=model.gp_mean_functions[k])
        for k, gp_state in enumerate(state["gps"])]
    model._component_GPs = model._expert_GPs = model.gps = gps
    hps_obj.set(hps_obj.weights,
                [np.asarray(g.hyperparameters, dtype=float).copy()
                 for g in gps])
    return model
