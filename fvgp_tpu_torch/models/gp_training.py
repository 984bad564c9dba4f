"""Training dispatcher (counterpart of ``fvgp_tpu/models/gp_training.py``):

* ``method="global"`` — best/1/bin differential evolution; with a batched
  objective each generation's whole population is one chunked, batched
  evaluation; constraints by Deb's feasibility rules;
* ``method="local"`` — scipy ``minimize`` (L-BFGS-B by default) over the
  fused value-and-gradient of the LML;
* ``method="mcmc"`` — adaptive Metropolis (``gp_mcmc``): the per-block
  sampler, or C vectorized chains over the batched objective.

The other methods (hgdl, adam, bo, callables, asynchronous runs) are not
ported yet (ROADMAP item 1.5).
"""

import warnings

import numpy as np
from scipy.optimize import minimize

from .gp_mcmc import gpMCMC, run_mcmc_vectorized


class GPtraining:
    def __init__(self, data, hyperparameters):
        self.mcmc_info = None
        self.data = data
        self.hyperparameters = np.asarray(hyperparameters, dtype=np.float64)

    @property
    def args(self):
        return self.data.args

    def train(self, objective_function=None, objective_function_gradient=None,
              objective_function_hessian=None, hyperparameter_bounds=None,
              init_hyperparameters=None, method="global", pop_size=20,
              tolerance=0.0001, max_iter=120, local_optimizer="L-BFGS-B",
              constraints=(), mcmc_prior=None, mcmc_prop_distrs="normal",
              mcmc_args=None, info=False, batched_objective=None,
              fused_value_and_grad=None):
        """Synchronous training; returns the optimized hyperparameters."""
        if mcmc_args is None:
            mcmc_args = {}
        if not self._in_bounds(init_hyperparameters, hyperparameter_bounds):
            raise Exception("Starting positions outside of optimization "
                            "bounds.", init_hyperparameters,
                            hyperparameter_bounds)
        if method == "global":
            hyperparameters = self._differential_evolution(
                objective_function, hyperparameter_bounds,
                init_hyperparameters, pop_size=pop_size, tol=tolerance,
                max_iter=max_iter, info=info,
                batched_objective=batched_objective, constraints=constraints)
        elif method == "local":
            hyperparameters = self._local(
                objective_function, objective_function_gradient,
                objective_function_hessian, hyperparameter_bounds,
                init_hyperparameters, tolerance, max_iter, local_optimizer,
                constraints, info, fused_value_and_grad)
        elif method == "mcmc":
            hyperparameters = self._mcmc(
                objective_function, hyperparameter_bounds,
                init_hyperparameters, max_iter, mcmc_prior, mcmc_prop_distrs,
                mcmc_args, info, batched_objective)
        else:
            raise NotImplementedError(
                f"fvgp_tpu_torch: train(method={method!r}) is not ported yet "
                "(ROADMAP item 1.5); use 'global', 'local' or 'mcmc'")
        hyperparameters = np.asarray(hyperparameters)
        if hyperparameters.ndim != 1:
            raise AssertionError("Optimizer returned invalid hyperparameters: "
                                 + str(hyperparameters))
        return hyperparameters

    def _local(self, objective, gradient, hessian, bounds, x0, tolerance,
               max_iter, local_optimizer, constraints, info, fused):
        progress = None
        if info:
            state = {"i": 0}

            def progress(intermediate_result):
                state["i"] += 1
                print(f"fvgp_tpu_torch local iteration {state['i']}: "
                      f"f(x)= {float(intermediate_result.fun)}")
        fun, jac = self._fun_and_jac(objective, gradient, fused)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            res = minimize(fun, x0, method=local_optimizer, jac=jac,
                           hess=hessian, bounds=bounds, tol=tolerance,
                           callback=progress, constraints=constraints,
                           options={"maxiter": max_iter})
        return res["x"]

    def _mcmc(self, log_likelihood, bounds, x0, max_iter, mcmc_prior,
              mcmc_prop_distrs, mcmc_args, info, batched_objective):
        """Adaptive Metropolis on the LML; fills ``mcmc_info`` and returns
        the median of the last 1% of the trace."""
        n_chains = int(mcmc_args.get("n_chains", 1))
        if n_chains > 1 and batched_objective is not None \
                and mcmc_prior is None and mcmc_prop_distrs == "normal":
            # parallel chains: one batched evaluation of every chain's
            # proposal per step
            bounds = np.asarray(bounds, dtype=np.float64)
            rng = np.random.default_rng(11)
            x0s = rng.uniform(bounds[:, 0], bounds[:, 1],
                              size=(n_chains, len(bounds)))
            x0s[0] = np.asarray(x0, dtype=np.float64)
            res = run_mcmc_vectorized(
                lambda X: -np.asarray(batched_objective(X)),
                bounds, x0s, n_updates=max_iter, info=info)
        else:
            def prior_function(theta, bounds, args):
                return 0. if self._in_bounds(theta, bounds) else -np.inf

            def likelihood_func(hps, args):
                return log_likelihood(hps)

            sampler = gpMCMC(likelihood_func,
                             prior_function=mcmc_prior or prior_function,
                             proposal_distributions=mcmc_prop_distrs,
                             bounds=bounds, args=mcmc_args)
            res = sampler.run_mcmc(x0=x0, n_updates=max_iter, info=info,
                                   break_condition="default")
        self.mcmc_info = res
        return res["median(x)"]

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
    def _constraint_violation(constraints, x):
        """Total violation of scipy-style constraints at x (0 when
        feasible): NonlinearConstraint / LinearConstraint objects and the
        ``{'type': 'ineq'|'eq', 'fun': ...}`` dicts."""
        total = 0.0
        for c in (constraints or ()):
            if isinstance(c, dict):
                val = np.atleast_1d(np.asarray(c["fun"](x), dtype=np.float64))
                if c.get("type", "ineq") == "eq":
                    total += float(np.sum(np.abs(val)))
                else:                      # ineq convention: fun(x) >= 0
                    total += float(np.sum(np.maximum(-val, 0.0)))
                continue
            val = np.atleast_1d(np.asarray(
                c.fun(x) if callable(getattr(c, "fun", None)) else c.A @ x,
                dtype=np.float64))
            lb = np.broadcast_to(np.atleast_1d(c.lb), val.shape)
            ub = np.broadcast_to(np.atleast_1d(c.ub), val.shape)
            total += float(np.sum(np.maximum(lb - val, 0.0))
                           + np.sum(np.maximum(val - ub, 0.0)))
        return total

    def _differential_evolution(self, objective, bounds, x0, pop_size=20,
                                tol=1e-4, max_iter=120, info=False,
                                batched_objective=None, constraints=()):
        """best/1/bin differential evolution (the JAX package's, with the
        same seeded generator).  With a batched objective the population is
        one batched evaluation per generation.  Constraints follow Deb's
        feasibility rules: feasible beats infeasible, infeasible candidates
        compete on total violation."""
        bounds = np.asarray(bounds, dtype=np.float64)
        H = len(bounds)
        NP = max(4, int(pop_size) * H)
        rng = np.random.default_rng(42)
        pop = rng.uniform(bounds[:, 0], bounds[:, 1], size=(NP, H))
        pop[0] = np.clip(np.asarray(x0, dtype=np.float64), bounds[:, 0],
                         bounds[:, 1])

        def eval_pop(P):
            if batched_objective is not None:
                return np.asarray(batched_objective(P), dtype=np.float64)
            return np.array([objective(p) for p in P], dtype=np.float64)

        def viol_pop(P):
            if not constraints:
                return np.zeros(len(P))
            return np.array([self._constraint_violation(constraints, p)
                             for p in P])

        fit = eval_pop(pop)
        fit = np.where(np.isfinite(fit), fit, np.inf)
        viol = viol_pop(pop)
        F, CR = 0.8, 0.9
        for gen in range(int(max_iter)):
            best = pop[np.lexsort((fit, viol))[0]]   # feasibility first
            idx = np.arange(NP)
            r1 = rng.permutation(NP)
            r2 = rng.permutation(NP)
            mutant = best[None, :] + F * (pop[r1] - pop[r2])
            cross = rng.uniform(size=(NP, H)) < CR
            cross[idx, rng.integers(0, H, NP)] = True
            trial = np.clip(np.where(cross, mutant, pop), bounds[:, 0],
                            bounds[:, 1])
            f_trial = eval_pop(trial)
            f_trial = np.where(np.isfinite(f_trial), f_trial, np.inf)
            v_trial = viol_pop(trial)
            improved = (v_trial < viol) | ((v_trial == viol)
                                           & (f_trial < fit))
            pop[improved] = trial[improved]
            fit[improved] = f_trial[improved]
            viol[improved] = v_trial[improved]
            if info:
                print(f"fvgp_tpu_torch DE generation {gen}: best f(x)= "
                      f"{fit.min()}")
            finite = fit[np.isfinite(fit)]
            if len(finite) == NP and np.std(finite) <= tol * (
                    abs(np.mean(finite)) + 1e-12):
                break
        return pop[np.lexsort((fit, viol))[0]]

    @staticmethod
    def _in_bounds(v, bounds):
        if not isinstance(bounds, np.ndarray):
            raise AssertionError("bounds must be np.ndarray")
        return not (np.any(v < bounds[:, 0]) or np.any(v > bounds[:, 1]))
