"""Training dispatcher (counterpart of ``fvgp_tpu/models/gp_training.py``):

* ``method="global"`` — best/1/bin differential evolution; with a batched
  objective each generation's whole population is one chunked, batched
  evaluation; constraints by Deb's feasibility rules;
* ``method="local"`` — scipy ``minimize`` (L-BFGS-B by default) over the
  fused value-and-gradient of the LML, with its Hessian for the optimizers
  that take one;
* ``method="hgdl"`` — multistart: with a batched value-and-gradient, a
  population of Adam runs advances in lockstep on the device (one batched
  value-and-gradient per epoch), then the best few are polished by scipy;
  without one, every start is polished in turn;
* ``method="mcmc"`` — adaptive Metropolis (``gp_mcmc``): the per-block
  sampler, or C vectorized chains over the batched objective;
* ``method="adam"`` — Adam on the host over the fused value-and-gradient,
  or, on the gp2Scale path, chunks of Adam steps on the device
  (``adam_chain_runner``);
* ``method="bo"`` — Bayesian optimization (``gp_bo``);
* a callable ``method(trainer)`` — the caller's own optimizer.

Asynchronous runs (``train_async``) execute the same code in daemon threads
with the ``get_latest()``/``stop()`` polling contract of ``gp_actor``.
"""

import warnings

import numpy as np
import torch
from scipy.optimize import minimize

from .. import config
from ..parallel.mesh import current_mesh, fork_mesh, sync_host_random
from .gp_actor import (AsyncOptimizer, _AdamActor, _BOActor, _MCMCActor,
                       _MultistartActor)
from .gp_bo import bayesian_optimize
from .gp_mcmc import gpMCMC, run_mcmc_vectorized


def adam_step(X, G, m, v, t, lr, beta1=0.9, beta2=0.999, eps=1e-8):
    """One Adam update of the tensor ``X`` by the gradient ``G`` at step
    ``t`` (bias correction from t = 1, eps outside the root, as optax's
    ``adam`` with eps_root 0); returns ``(X, m, v)``."""
    m = (1.0 - beta1) * G + beta1 * m
    v = (1.0 - beta2) * G * G + beta2 * v
    mh = m / (1.0 - beta1 ** t)
    vh = v / (1.0 - beta2 ** t)
    return X - lr * (mh / (torch.sqrt(vh) + eps)), m, v


def projected_adam(grad_fn, X, steps, lo, hi, lr=0.05):
    """``steps`` Adam steps (``adam_step``: optax's ``adam(lr)``) on the rows
    of the tensor ``X`` in lockstep, each followed by the projection onto
    ``[lo, hi]``.  ``grad_fn(X)`` is the gradient of the objective to
    MINIMIZE; its non-finite entries are zeroed."""
    m = torch.zeros_like(X)
    v = torch.zeros_like(X)
    for t in range(1, int(steps) + 1):
        G = grad_fn(X)
        G = torch.where(torch.isfinite(G), G, torch.zeros_like(G))
        X, m, v = adam_step(X, G, m, v, t, lr)
        X = torch.clamp(X, lo, hi)
    return X


class GPtraining:
    def __init__(self, data, hyperparameters):
        self.mcmc_info = None
        self.bo_info = None
        self.data = data
        self.hyperparameters = np.asarray(hyperparameters, dtype=np.float64)

    @property
    def args(self):
        return self.data.args

    @property
    def gp2Scale(self):
        return self.data.gp2Scale

    def train(self, objective_function=None, objective_function_gradient=None,
              objective_function_hessian=None, hyperparameter_bounds=None,
              init_hyperparameters=None, method="global", pop_size=20,
              tolerance=0.0001, max_iter=120, local_optimizer="L-BFGS-B",
              global_optimizer="genetic", constraints=(), mcmc_prior=None,
              mcmc_prop_distrs="normal", mcmc_args=None, bo_args=None,
              dask_client=None, info=False, batched_objective=None,
              fused_value_and_grad=None, batched_value_and_grad=None,
              adam_chain_runner=None):
        """Synchronous training; returns the optimized hyperparameters.
        ``global_optimizer`` and ``dask_client`` are accepted and ignored,
        as in the JAX package.  Under a mesh of more than one rank every
        rank first takes rank 0's numpy random state, so the methods that
        draw from it (``mcmc``) run the same chain on every rank."""
        if mcmc_args is None:
            mcmc_args = {}
        sync_host_random()
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
        elif method == "hgdl":
            optima = self.multistart_optimize(
                objective_function, objective_function_gradient,
                hyperparameter_bounds, init_hyperparameters,
                n_starts=max(pop_size, 4), epochs=max_iter,
                tolerance=tolerance, local_optimizer=local_optimizer,
                fused_value_and_grad=fused_value_and_grad, info=info,
                batched_value_and_grad=batched_value_and_grad,
                constraints=constraints)
            hyperparameters = optima[0]["x"]
        elif method == "mcmc":
            hyperparameters = self._mcmc(
                objective_function, hyperparameter_bounds,
                init_hyperparameters, max_iter, mcmc_prior, mcmc_prop_distrs,
                mcmc_args, info, batched_objective)
        elif method == "adam":
            hyperparameters = self._adam(
                objective_function, objective_function_gradient,
                hyperparameter_bounds, init_hyperparameters, tolerance,
                max_iter, info, fused_value_and_grad, adam_chain_runner)
        elif method == "bo":
            hyperparameters, self.bo_info = bayesian_optimize(
                objective_function, hyperparameter_bounds,
                init_hyperparameters, max_iter=max_iter, bo_args=bo_args,
                info=info, device=self.data.device)
        elif callable(method):
            hyperparameters = method(self)
        else:
            raise ValueError("No optimization mode specified in "
                             "fvgp_tpu_torch")
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

    def _adam(self, objective, gradient, bounds, x0, tolerance, max_iter,
              info, fused, chain_runner):
        """Adam: chunks of ``args["adam_chain_steps"]`` (default 8) steps on
        the device through ``chain_runner`` (the gp2Scale path), else the
        host loop over the fused value-and-gradient."""
        chain_steps = int(self.args.get("adam_chain_steps", 8))
        if chain_runner is not None and chain_steps > 1:
            theta = np.asarray(x0, np.float64).copy()
            m = np.zeros_like(theta)
            v = np.zeros_like(theta)
            bounds = np.asarray(bounds, np.float64)
            t = 0
            # full chunks only, and never more steps than the budget
            chain_steps = min(chain_steps, max(int(max_iter), 1))
            for _ in range(max(1, int(max_iter) // chain_steps)):
                theta_new, m, v, fvals = chain_runner(theta, m, v, t,
                                                      chain_steps, bounds)
                t += chain_steps
                step_norm = np.linalg.norm(theta_new - theta) / chain_steps
                theta = theta_new
                if info:
                    print(f"fvgp_tpu_torch adam (device chain) iteration {t} "
                          f"out of {max_iter}: f(x)= {float(fvals[-1])}")
                if step_norm < tolerance * 1e-2:
                    break
            return theta
        progress = None
        if info:
            def progress(theta, fval, grad, iteration):
                if iteration % 10 == 0 or iteration == 1:
                    print(f"fvgp_tpu_torch adam iteration {iteration} out of "
                          f"{max_iter}: f(x)= {float(fval)}, "
                          f"|grad|= {float(np.linalg.norm(grad))}")
        obj_fn, grad_fn = objective, gradient
        if fused is not None:
            # one evaluation per step instead of two: adam_optimize always
            # evaluates the value and then the gradient at the SAME theta
            memo = {}

            def obj_fn(theta):
                val, g = fused(np.asarray(theta))
                memo["g"] = (np.asarray(theta).tobytes(), g)
                return val

            def grad_fn(theta):
                hit = memo.get("g")
                if hit is not None and hit[0] == np.asarray(theta).tobytes():
                    return hit[1]
                return fused(np.asarray(theta))[1]
        theta, _ = self.adam_optimize(obj_fn, grad_fn, x0, max_iter=max_iter,
                                      callback=progress)
        return theta

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

    # ------------------------------------------------------------------
    def _device_multistart_phase(self, bvg_device, bounds, starts, epochs,
                                 lr=0.05):
        """Advance ALL restarts in lockstep on the device: per epoch one
        batched value-and-gradient, an Adam step and the projection onto
        the bounds (``projected_adam``).  The JAX package caches its
        compiled scan per objective; the port compiles nothing, so there is
        no runner cache."""
        dev = self.data.device
        dtype = config.linalg_dtype(self.args, dev)

        def tensor(a):
            return torch.as_tensor(np.asarray(a, np.float64),
                                   dtype=dtype).to(dev)

        X = projected_adam(lambda X: bvg_device(X)[1], tensor(starts),
                           epochs, tensor(bounds[:, 0]),
                           tensor(bounds[:, 1]), lr=lr)
        vals, _ = bvg_device(X)
        return (np.asarray(config.to_numpy(X), np.float64),
                np.asarray(config.to_numpy(vals), np.float64))

    def multistart_optimize(self, objective, gradient, bounds, x0,
                            n_starts=20, epochs=120, tolerance=1e-4,
                            local_optimizer="L-BFGS-B",
                            fused_value_and_grad=None, info=False,
                            publish=None, stop_requested=None,
                            batched_value_and_grad=None, constraints=()):
        """Multistart local optimization in place of the HGDL package.

        Starts: ``default_rng(7)`` uniform in the bounds, start 0 the
        clipped ``x0``.  With a batched value-and-gradient, a lockstep Adam
        phase of ``args["multistart_device_epochs"]`` epochs (default
        ``min(epochs, 200)``) advances every start on the device, and the
        best three (feasible first under constraints) are polished by
        L-BFGS-B, or SLSQP under constraints; otherwise every start is
        polished in turn.  ``publish`` / ``stop_requested`` are the async
        actor's hooks.  Returns HGDL-style sorted optima
        ``[{"x", "f(x)"}, ...]``."""
        bounds = np.asarray(bounds, dtype=np.float64)
        H = len(bounds)
        rng = np.random.default_rng(7)
        starts = rng.uniform(bounds[:, 0], bounds[:, 1],
                             size=(int(n_starts), H))
        starts[0] = np.clip(np.asarray(x0, dtype=np.float64),
                            bounds[:, 0], bounds[:, 1])
        if batched_value_and_grad is not None and len(starts) > 1:
            dev_epochs = int(self.args.get("multistart_device_epochs",
                                           min(int(epochs), 200)))
            if info and dev_epochs < int(epochs):
                print(f"fvgp_tpu_torch multistart device phase capped at "
                      f"{dev_epochs} lockstep epochs (of {int(epochs)}; "
                      "override with args['multistart_device_epochs']); "
                      "the polish phase gets the full budget")
            X, vals = self._device_multistart_phase(
                batched_value_and_grad, bounds, starts, epochs=dev_epochs)
            rank = np.where(np.isfinite(vals), vals, np.inf)
            if constraints:
                viol = np.array([self._constraint_violation(constraints, xx)
                                 for xx in X])
                order = np.lexsort((rank, viol))
            else:
                order = np.argsort(rank)
            n_polish = min(3, len(starts))
            starts = X[order[:n_polish]]
            if info:
                print(f"fvgp_tpu_torch multistart device phase: best f(x)= "
                      f"{vals[order[0]]}, polishing top {n_polish}")
        fun, jac = self._fun_and_jac(objective, gradient,
                                     fused_value_and_grad)
        # L-BFGS-B takes no constraints; SLSQP honors bounds and
        # scipy-style constraint objects
        polish_method = local_optimizer
        if constraints and str(local_optimizer).upper() in ("L-BFGS-B",
                                                            "LBFGSB"):
            polish_method = "SLSQP"
        optima = []
        for s_i, s in enumerate(starts):
            if stop_requested is not None and stop_requested():
                break
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                try:
                    res = minimize(fun, s, method=polish_method, jac=jac,
                                   bounds=bounds, tol=tolerance,
                                   constraints=constraints,
                                   options={"maxiter": int(epochs)})
                except Exception:
                    continue
            if np.isfinite(res.fun):
                optima.append({"x": np.asarray(res.x),
                               "f(x)": float(res.fun)})
                optima.sort(key=lambda o: o["f(x)"])
                if publish is not None:
                    publish(optima=list(optima))
                if info:
                    print(f"fvgp_tpu_torch multistart {s_i + 1}/"
                          f"{len(starts)}: f(x)= {res.fun}, best= "
                          f"{optima[0]['f(x)']}")
        if not optima:
            raise Exception("Multi-start optimization failed on every start.")
        return optima

    # ------------------------------------------------------------------
    def train_async(self, dask_client=None, objective_function=None,
                    objective_function_gradient=None,
                    objective_function_hessian=None,
                    hyperparameter_bounds=None, init_hyperparameters=None,
                    method="global", pop_size=20, tolerance=0.0001,
                    max_iter=120, local_optimizer="L-BFGS-B",
                    global_optimizer="genetic", constraints=(),
                    mcmc_prior=None, mcmc_prop_distrs="normal",
                    mcmc_args=None, bo_args=None, info=False,
                    fused_value_and_grad=None, run_context=None):
        """Start an asynchronous run in a daemon thread; returns an
        ``AsyncOptimizer`` proxy.  ``dask_client`` is accepted and ignored:
        the actors are threads.  ``run_context`` (a zero-argument
        context-manager factory) wraps the WHOLE background run, so the
        sequential linear-algebra gate lives as long as the thread.

        The MCMC actor draws from a private ``RandomState`` taken from
        numpy's global state here.  Under a mesh of more than one rank the
        actors run in lockstep (``models/gp_actor.py``): the global state
        is synced first, so every rank's actor computes the same chain, on
        a mesh of its own (``mesh.fork_mesh``, made here by every rank
        together); polls and stops agree across the ranks.  Let every
        rank's run end (``kill_client``, or poll until it is done) before
        the process group goes."""
        mesh = current_mesh()
        sync_host_random(mesh)
        if mcmc_args is None:
            mcmc_args = {}
        if method not in ("hgdl", "mcmc", "adam", "bo"):
            raise AssertionError("Asynchronous training only supported for "
                                 "hgdl, mcmc, adam, bo; got method="
                                 + str(method))
        if method == "mcmc":
            def prior_function(theta, bounds, args):
                return 0. if self._in_bounds(theta, bounds) else -np.inf

            def likelihood_func(hps, args):
                return objective_function(hps)

            actor = _MCMCActor(likelihood_func, hyperparameter_bounds,
                               mcmc_prior or prior_function, mcmc_prop_distrs,
                               mcmc_args, init_hyperparameters, max_iter,
                               info)
        elif method == "adam":
            actor = _AdamActor(objective_function,
                               objective_function_gradient,
                               init_hyperparameters, 1e-2, 0.9, 0.999, 1e-8,
                               max_iter, 1e-6)
        elif method == "bo":
            actor = _BOActor(objective_function, hyperparameter_bounds,
                             init_hyperparameters, max_iter, bo_args, info,
                             device=self.data.device)
        else:
            def run_fn(publish, stop_requested):
                return self.multistart_optimize(
                    objective_function, objective_function_gradient,
                    hyperparameter_bounds, init_hyperparameters,
                    n_starts=max(pop_size, 4), epochs=max_iter,
                    tolerance=tolerance, local_optimizer=local_optimizer,
                    fused_value_and_grad=fused_value_and_grad, info=info,
                    publish=publish, stop_requested=stop_requested,
                    constraints=constraints)
            actor = _MultistartActor(run_fn)
        if method == "mcmc":
            actor._random_state = np.random.RandomState()
            actor._random_state.set_state(np.random.get_state())
        if mesh is not None and mesh.size > 1:
            actor._mesh = fork_mesh(mesh)
        actor._run_context = run_context
        actor.start()
        return AsyncOptimizer(actor)

    @staticmethod
    def stop_training(opt_obj):
        """Ask an asynchronous run to stop."""
        try:
            opt_obj.cancel_tasks()
        except Exception:
            warnings.warn("No asynchronous training to be canceled; "
                          "no training is running.", UserWarning,
                          stacklevel=2)

    @staticmethod
    def kill_client(opt_obj):
        """Stop an asynchronous run and wait up to 5 s for its thread."""
        try:
            opt_obj.kill_client()
        except Exception:
            warnings.warn("No asynchronous training to be killed; "
                          "no training is running.", UserWarning,
                          stacklevel=2)

    def update_hyperparameters(self, opt_obj):
        """The latest hyperparameters of a running asynchronous optimizer:
        the best of an optima list, else ``median(x)``, else ``x``; the
        current ones when the poll raises or finds nothing.  Under a mesh
        of more than one rank the poll is a collective that returns the
        same step's snapshot on every rank (``AsyncOptimizer.get_agreed``):
        call it on every rank."""
        mesh = current_mesh()
        if mesh is not None and mesh.size > 1:
            opt_list = opt_obj.get_agreed(mesh)
        else:
            try:
                opt_list = opt_obj.get_latest()
            except Exception:
                return self.hyperparameters
        if not opt_list:
            warnings.warn("Hyperparameter update not successful: empty "
                          "optima list.", UserWarning, stacklevel=2)
            return self.hyperparameters
        if isinstance(opt_list, list):
            updated = opt_list[0]["x"]
        elif isinstance(opt_list, dict):
            if "median(x)" in opt_list:
                updated = opt_list["median(x)"]
            elif "x" in opt_list:
                updated = opt_list["x"]
            else:
                raise Exception("Reading the updated hyperparameters failed",
                                opt_list)
        else:
            raise Exception("Reading the updated hyperparameters failed",
                            opt_list)
        updated = np.asarray(updated)
        if updated.ndim != 1:
            raise AssertionError("async optimizer returned invalid "
                                 "hyperparameters: " + str(updated))
        return updated

    # ------------------------------------------------------------------
    @staticmethod
    def adam_optimize(nlml, grad_nlml, theta0, lr=1e-2, beta1=0.9,
                      beta2=0.999, eps=1e-8, max_iter=1000, tol=1e-6,
                      callback=None, early_stop=None):
        """Adam on (objective, gradient) callables, the moments in float64
        numpy, no clipping; stops when a step moves theta by less than
        ``tol`` or ``early_stop()`` says so.  Returns (theta, history)."""
        theta = np.asarray(theta0, dtype=np.float64).copy()
        d = theta.size
        m = np.zeros(d)
        v = np.zeros(d)
        history = {"theta": [], "nlml": [], "grad_norm": []}
        for t in range(1, int(max_iter) + 1):
            fval = nlml(theta)
            g = np.asarray(grad_nlml(theta), dtype=np.float64)
            m = beta1 * m + (1.0 - beta1) * g
            v = beta2 * v + (1.0 - beta2) * (g ** 2)
            m_hat = m / (1.0 - beta1 ** t)
            v_hat = v / (1.0 - beta2 ** t)
            step = lr * m_hat / (np.sqrt(v_hat) + eps)
            theta_new = theta - step
            history["theta"].append(theta.copy())
            history["nlml"].append(fval)
            history["grad_norm"].append(np.linalg.norm(g))
            if callback is not None:
                callback(theta, fval, g, t)
            if np.linalg.norm(theta_new - theta) < tol or (
                    early_stop is not None and early_stop()):
                theta = theta_new
                break
            theta = theta_new
        return theta, history

    @staticmethod
    def _in_bounds(v, bounds):
        if not isinstance(bounds, np.ndarray):
            raise AssertionError("bounds must be np.ndarray")
        return not (np.any(v < bounds[:, 0]) or np.any(v > bounds[:, 1]))

    def __getstate__(self):
        # the BO surrogate is a model of its own, rebuilt by the next run
        bo_info = self.bo_info
        if isinstance(bo_info, dict) and bo_info.get("surrogate") is not None:
            bo_info = {k: v for k, v in bo_info.items() if k != "surrogate"}
        return dict(data=self.data, mcmc_info=self.mcmc_info,
                    bo_info=bo_info, hyperparameters=self.hyperparameters)

    def __setstate__(self, state):
        self.__dict__.update(state)
