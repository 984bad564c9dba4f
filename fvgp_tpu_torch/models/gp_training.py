"""Training dispatcher (counterpart of ``fvgp_tpu/models/gp_training.py``):
``method="local"`` — scipy ``minimize`` (L-BFGS-B by default) over the fused
value-and-gradient of the sparse LML.  The other methods (global, hgdl,
mcmc, adam, bo, callables, asynchronous runs) are not ported yet (ROADMAP
item 1.5).
"""

import warnings

import numpy as np
from scipy.optimize import minimize


class GPtraining:
    def __init__(self, data, hyperparameters):
        self.data = data
        self.hyperparameters = np.asarray(hyperparameters, dtype=np.float64)

    @property
    def args(self):
        return self.data.args

    def train(self, objective_function=None, objective_function_gradient=None,
              objective_function_hessian=None, hyperparameter_bounds=None,
              init_hyperparameters=None, method="local", tolerance=0.0001,
              max_iter=120, local_optimizer="L-BFGS-B", constraints=(),
              info=False, fused_value_and_grad=None):
        """Synchronous training; returns the optimized hyperparameters."""
        if not self._in_bounds(init_hyperparameters, hyperparameter_bounds):
            raise Exception("Starting positions outside of optimization "
                            "bounds.", init_hyperparameters,
                            hyperparameter_bounds)
        if method != "local":
            raise NotImplementedError(
                f"fvgp_tpu_torch: train(method={method!r}) is not ported yet "
                "(ROADMAP item 1.5); use method='local'")
        progress = None
        if info:
            state = {"i": 0}

            def progress(intermediate_result):
                state["i"] += 1
                print(f"fvgp_tpu_torch local iteration {state['i']}: "
                      f"f(x)= {float(intermediate_result.fun)}")
        fun, jac = self._fun_and_jac(objective_function,
                                     objective_function_gradient,
                                     fused_value_and_grad)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            res = minimize(fun, init_hyperparameters, method=local_optimizer,
                           jac=jac, hess=objective_function_hessian,
                           bounds=hyperparameter_bounds, tol=tolerance,
                           callback=progress, constraints=constraints,
                           options={"maxiter": max_iter})
        hyperparameters = np.asarray(res["x"])
        if hyperparameters.ndim != 1:
            raise AssertionError("Optimizer returned invalid hyperparameters: "
                                 + str(hyperparameters))
        return hyperparameters

    @staticmethod
    def _fun_and_jac(objective, gradient, fused):
        """scipy calls f and g separately; caching the fused value and
        gradient halves the device work."""
        if fused is None:
            return objective, gradient
        cache = {}

        def fun(x):
            key = x.tobytes()
            if key not in cache:
                cache.clear()
                cache[key] = fused(x)
            return cache[key][0]

        def jac(x):
            key = x.tobytes()
            if key not in cache:
                cache.clear()
                cache[key] = fused(x)
            return np.asarray(cache[key][1])

        return fun, jac

    @staticmethod
    def _in_bounds(v, bounds):
        if not isinstance(bounds, np.ndarray):
            raise AssertionError("bounds must be np.ndarray")
        return not (np.any(v < bounds[:, 0]) or np.any(v > bounds[:, 1]))
