"""Asynchronous training actors (a copy of ``fvgp_tpu/models/gp_actor.py``,
which imports numpy and ``threading`` only; the BO actor also carries the
device of its surrogate).

fvGP runs MCMC/Adam/BO inside Dask actors on remote workers with a
lock-protected ``get_latest()`` snapshot and cooperative ``stop()``.  Here
the process that drives the card runs the actor as a daemon *thread*: the
same polling contract (get_latest / stop / cancel_tasks / kill_client), no
process boundary, no pickled closures.  Grad mode is thread-local in
PyTorch, so every no-grad region of the evaluations is entered inside the
thread by the code that needs it.
"""

import threading

import numpy as np


class _ActorBase:
    def __init__(self):
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        self._latest = {}
        self._done = False
        # optional zero-arg context-manager factory wrapping the whole run
        # (e.g. the linalg sequential-state gate, whose lifetime must match
        # the background thread, not the submitting call)
        self._run_context = None

    def start(self):
        self._thread = threading.Thread(target=self._run_guarded, daemon=True)
        self._thread.start()
        return self

    def _run_guarded(self):
        """An exception in the worker thread must not strand pollers:
        is_done() would stay False forever (e.g. stop() issued before the
        first optimum completes makes multistart raise).  The error is
        published in the snapshot and the actor terminates."""
        try:
            if self._run_context is not None:
                with self._run_context():
                    self._run()
            else:
                self._run()
        except Exception as exc:
            self._publish(error=f"{type(exc).__name__}: {exc}")
        finally:
            self._done = True

    def stop(self):
        self._stop.set()

    def is_done(self):
        return self._done

    def get_latest(self):
        with self._lock:
            return dict(self._latest)

    def join(self, timeout=None):
        if self._thread is not None:
            self._thread.join(timeout)

    def _publish(self, **kwargs):
        with self._lock:
            self._latest.update(kwargs)

    def _run(self):
        raise NotImplementedError


class _MCMCActor(_ActorBase):
    """MCMC in a background thread, snapshotting the running median
    (ref gp_actor.py:7)."""

    def __init__(self, likelihood_fn, bounds, prior_fn, prop_distrs, mcmc_args,
                 x0, max_iter, info):
        super().__init__()
        from .gp_mcmc import gpMCMC
        self._sampler = gpMCMC(likelihood_fn, bounds=bounds, prior_function=prior_fn,
                               proposal_distributions=prop_distrs, args=mcmc_args)
        self._x0 = np.asarray(x0)
        self._max_iter = int(max_iter)
        self._info = info

    def _run(self):
        def every_iteration(sampler):
            info = sampler.mcmc_info
            if info:
                self._publish(**{"median(x)": info["median(x)"],
                                 "x": info["max x"], "f(x)": info["max f(x)"]})
            return False

        def break_cond(sampler):
            return self._stop.is_set()

        info = self._sampler.run_mcmc(
            x0=self._x0, n_updates=self._max_iter, info=self._info,
            break_condition=break_cond, run_in_every_iteration=every_iteration)
        if info:
            self._publish(**{"median(x)": info["median(x)"],
                             "x": info["max x"], "f(x)": info["max f(x)"]})
        self._done = True


class _AdamActor(_ActorBase):
    """Adam in a background thread (ref gp_actor.py:81)."""

    def __init__(self, objective, gradient, x0, lr, beta1, beta2, eps,
                 max_iter, tol):
        super().__init__()
        self._objective = objective
        self._gradient = gradient
        self._x0 = np.asarray(x0, dtype=np.float64)
        self._lr, self._b1, self._b2, self._eps = lr, beta1, beta2, eps
        self._max_iter = int(max_iter)
        self._tol = tol

    def _run(self):
        from .gp_training import GPtraining
        theta, _ = GPtraining.adam_optimize(
            self._objective, self._gradient, self._x0, lr=self._lr,
            beta1=self._b1, beta2=self._b2, eps=self._eps,
            max_iter=self._max_iter, tol=self._tol,
            callback=lambda th, f, g, i: self._publish(x=np.asarray(th), **{"f(x)": float(f)}),
            early_stop=self._stop.is_set)
        self._publish(x=np.asarray(theta))
        self._done = True


class _BOActor(_ActorBase):
    """Bayesian optimization in a background thread (ref gp_actor.py:139):
    the polled snapshot is the best hyperparameters so far.  The surrogate
    lives on ``device``."""

    def __init__(self, objective, bounds, x0, max_iter, bo_args, info,
                 device="cuda"):
        super().__init__()
        self._device = device
        self._objective = objective
        self._bounds = bounds
        self._x0 = np.asarray(x0)
        self._max_iter = int(max_iter)
        self._bo_args = bo_args
        self._info = info

    def _run(self):
        from .gp_bo import bayesian_optimize
        bo_args = dict(self._bo_args or {})
        bo_args["progress_callback"] = lambda x, f: self._publish(
            x=np.asarray(x), **{"f(x)": float(f)})
        bo_args["stop_requested"] = self._stop.is_set
        x, info = bayesian_optimize(self._objective, self._bounds, self._x0,
                                    max_iter=self._max_iter, bo_args=bo_args,
                                    info=self._info, device=self._device)
        self._publish(x=np.asarray(x))
        self._done = True


class _MultistartActor(_ActorBase):
    """HGDL-equivalent multi-start local optimization in a background thread:
    publishes the best optimum list found so far, ordered like HGDL's
    ``get_latest()`` (a list of dicts with key "x")."""

    def __init__(self, run_fn):
        super().__init__()
        self._run_fn = run_fn

    def _run(self):
        optima = self._run_fn(publish=self._publish,
                              stop_requested=self._stop.is_set)
        self._publish(optima=optima)
        self._done = True


class AsyncOptimizer:
    """Proxy mirroring HGDL's optimizer interface (ref gp_actor.py:213):
    get_latest / cancel_tasks / kill_client."""

    def __init__(self, actor):
        self.actor = actor

    def get_latest(self):
        latest = self.actor.get_latest()
        if "optima" in latest and latest["optima"]:
            return latest["optima"]
        if "median(x)" in latest:
            return {"median(x)": latest["median(x)"], "x": latest.get("x")}
        if "x" in latest:
            return {"x": latest["x"]}
        return {}

    def get_final(self):
        self.actor.join()
        return self.get_latest()

    def stop(self):
        self.actor.stop()

    def cancel_tasks(self):
        self.actor.stop()

    def kill_client(self):
        self.actor.stop()
        self.actor.join(timeout=5)

    def is_done(self):
        return self.actor.is_done()
