"""Adaptive-Metropolis MCMC (a copy of ``fvgp_tpu/models/gp_mcmc.py``,
which imports numpy only).

The ``gpMCMC``/``ProposalDistribution`` API of fvGP: per-block proposals
over index subsets, the ``prop_args`` keys ``prop_Sigma``/``sigma_m``, the
``adapt(i, mcmc_obj)`` hook, the default 100-sample stability break, and the
``mcmc_info`` trace dict with MAP / max x / mean / median / var of the last
1%.

* ``run_mcmc_vectorized`` runs C chains whose C marginal likelihoods per
  step are one batched call (the GP's batched objective).
* Both samplers share one Robbins–Monro adaptation step (``shaby_update``,
  Shaby & Wells' log-adaptive scheme targeting acceptance 0.234).
* The adapted step scale ``sigma_m`` multiplies the proposal covariance, as
  the scheme prescribes.
* The default proposal and the accept test draw from numpy's global random
  state, or, inside :func:`private_random_state`, from a thread's own
  ``RandomState`` (the asynchronous actor's, so that draws of the main
  thread cannot change its chain; a deviation from the JAX package).
"""

import contextlib
import threading
import time
import warnings

import numpy as np

from ..parallel.mesh import sync_host_random


_RANDOM = threading.local()


def _random():
    """The random source of this thread's chains: its private
    ``RandomState`` (:func:`private_random_state`), else numpy's global
    state."""
    state = getattr(_RANDOM, "state", None)
    return np.random if state is None else state


@contextlib.contextmanager
def private_random_state(state):
    """Draw this thread's proposals and accept tests from ``state`` (a
    ``np.random.RandomState``) instead of numpy's global state."""
    prev = getattr(_RANDOM, "state", None)
    _RANDOM.state = state
    try:
        yield state
    finally:
        _RANDOM.state = prev


# module-level (not closures) so a sampler configured with the defaults
# stays picklable — the checkpoint/resume contract covers gpMCMC
def _uniform_box_log_prior(theta, b, _):
    return 0. if np.all((theta >= b[:, 0]) & (theta <= b[:, 1])) else -np.inf


def _no_adapt(step, sampler):
    return None


def shaby_update(sigma_m, Sigma, accept_rate, window, step, K, *,
                 r_opt=0.234, c_0=10.0, c_1=0.8, adapt_cov=True):
    """One Robbins–Monro adaptation of (step scale, shape matrix).

    The log step scale chases the target acceptance rate ``r_opt``; the
    shape matrix relaxes toward the empirical covariance of the recent
    sample ``window`` (rows = samples).  Gains decay as the step count
    grows, so the chain's stationary distribution is preserved.
    """
    gain_cov = ((step / K) + 3.0) ** (-c_1)
    gain_scale = c_0 * gain_cov
    sigma_m = float(sigma_m) * np.exp(gain_scale * (accept_rate - r_opt))
    if adapt_cov and window is not None and len(window) >= 2:
        empirical = np.atleast_2d(np.cov(np.asarray(window).T))
        if np.isfinite(empirical).all():
            Sigma = Sigma + gain_cov * (empirical - Sigma)
    return sigma_m, Sigma


class ProposalDistribution:
    """Proposal over a subset of hyperparameter indices (contract: ref
    gp_mcmc.py:234-364).

    ``proposal_dist(x_block, x_full, obj)`` draws the next block;
    ``adapt(i, mcmc_obj)`` may mutate ``obj.prop_args`` every ``K`` steps.
    The default is a Gaussian step with covariance
    ``sigma_m * prop_Sigma`` and Shaby-adaptive updates of both factors.
    """

    def __init__(self, indices, proposal_dist="normal", init_prop_Sigma=None,
                 adapt_callable=None, r_opt=.234, c_0=10, c_1=.8, K=10,
                 auto_accept=False, adapt_cov=True, prop_args=None, ID=None):
        self.indices = np.asarray(indices)
        self.r_opt, self.c_0, self.c_1, self.K = r_opt, c_0, c_1, K
        self.auto_accept = bool(auto_accept)
        self.adapt_cov = bool(adapt_cov)
        self.ID = ID
        self.jump_trace = []
        block_dim = self.indices.size

        is_gaussian = proposal_dist == "normal"
        if callable(proposal_dist):
            self.proposal_dist = proposal_dist
        elif is_gaussian:
            self.proposal_dist = self._gaussian_step
            if init_prop_Sigma is None:
                init_prop_Sigma = np.eye(block_dim)
                warnings.warn("Normal proposal distribution without "
                              "init_prop_Sigma; this can lead to slow "
                              "convergence.")
        else:
            raise Exception("No proposal distribution specified!")

        if callable(adapt_callable):
            self.adapt = adapt_callable
        elif adapt_callable == "normal" or is_gaussian:
            self.adapt = self._shaby_adapt
        elif isinstance(adapt_callable, str):
            raise Exception("Invalid string provided for adapt callable.")
        else:
            self.adapt = _no_adapt

        scale0 = 2.4 ** 2 / block_dim          # Gelman–Roberts–Gilks start
        if prop_args is None:
            self.prop_args = {"prop_Sigma": init_prop_Sigma,
                              "sigma_m": scale0}
        else:
            self.prop_args = prop_args
            if adapt_callable == "normal":
                self.prop_args.update(prop_Sigma=init_prop_Sigma,
                                      sigma_m=scale0)

    def _gaussian_step(self, x, hps, obj):
        """Draw from N(x, sigma_m · Σ).  Global numpy randomness on purpose
        (callers seed ``np.random.seed`` for reproducible chains), or the
        thread's private state."""
        cov = obj.prop_args["sigma_m"] * np.asarray(obj.prop_args["prop_Sigma"])
        return _random().multivariate_normal(x, cov)

    def normal_proposal_dist(self, x, hps, obj):
        """Public default Gaussian proposal (API parity with ref
        gp_mcmc.py:320-340): draw around the current position using the
        adapted shape matrix ``obj.prop_args['prop_Sigma']``.  Documented
        deviation: the adapted step scale ``sigma_m`` multiplies the
        covariance here, as Shaby's scheme prescribes (module docstring)."""
        return self._gaussian_step(x, hps, obj)

    def _shaby_adapt(self, step, sampler):
        """Every K steps: feed the recent acceptance rate and the recent
        positions of THIS block into the shared Robbins–Monro update."""
        if step % self.K:
            return
        lo = max(step - self.K + 1, 0)
        rate = float(np.mean(self.jump_trace[lo:step]))
        # slice the python list BEFORE converting: converting the whole
        # trace each adaptation is O(n^2) over the run
        window = np.asarray(sampler.trace["x"][lo:step])[:, self.indices]
        pa = self.prop_args
        pa["sigma_m"], pa["prop_Sigma"] = shaby_update(
            pa["sigma_m"], pa["prop_Sigma"], rate, window, step, self.K,
            r_opt=self.r_opt, c_0=self.c_0, c_1=self.c_1,
            adapt_cov=self.adapt_cov)

    def __getstate__(self):
        return self.__dict__

    def __setstate__(self, state):
        self.__dict__.update(state)


def _trace_summary(X_flat, F_flat):
    """The reference-shaped summary: MAP and quantiles of the last 1%
    (contract: ref gp_mcmc.py:169-179)."""
    best = int(np.argmax(F_flat))
    tail = X_flat[-max(1, len(X_flat) // 100):]
    return {"max f(x)": float(F_flat[best]),
            "MAP": float(F_flat[best]),
            "max x": X_flat[best],
            "mean(x)": tail.mean(axis=0),
            "median(x)": np.median(tail, axis=0),
            "var(x)": tail.var(axis=0)}


def _proposal_factors(A):
    """Batched (C, H, H) factors F with F·Fᵀ = A for the proposal draw.

    Cholesky with a diagonal-jitter ladder; if a chain's adapted
    covariance is indefinite beyond what jitter fixes, degrade gracefully
    the way ``rng.multivariate_normal`` (SVD-based) does — symmetrize and
    clip negative eigenvalues — instead of killing the whole
    multi-chain run with a LinAlgError."""
    H = A.shape[-1]
    eye = np.eye(H)
    for scale in (0.0, 1e-12, 1e-8, 1e-4):
        jit = scale * np.maximum(np.trace(A, axis1=1, axis2=2), 1e-30)
        try:
            return np.linalg.cholesky(A + jit[:, None, None] * eye)
        except np.linalg.LinAlgError:
            continue
    warnings.warn("MCMC proposal covariance not positive definite; "
                  "using an eigenvalue-clipped factor", stacklevel=2)
    As = 0.5 * (A + np.transpose(A, (0, 2, 1)))
    w, Q = np.linalg.eigh(As)
    return Q * np.sqrt(np.clip(w, 0.0, None))[:, None, :]


def run_mcmc_vectorized(log_likelihood_batch, bounds, x0s, *, n_updates=10000,
                        info=False, r_opt=0.234, c_0=10, c_1=0.8, K=10,
                        break_condition="default", seed=0):
    """Adaptive Metropolis with C parallel chains whose likelihood
    evaluations are ONE batched device call per step.

    Each chain carries its own (sigma_m, Σ) pair, adapted by the same
    ``shaby_update`` the per-block sampler uses.  Returns the
    reference-shaped ``mcmc_info`` dict pooled over chains, plus per-chain
    traces under ``"x_chains"``.
    """
    bounds = np.asarray(bounds, dtype=float)
    X = np.atleast_2d(np.asarray(x0s, dtype=float)).copy()
    C, H = X.shape
    rng = np.random.default_rng(seed)
    span = bounds[:, 1] - bounds[:, 0]
    Sigma = np.tile(np.diag((span * 0.2 / np.sqrt(12)) ** 2), (C, 1, 1))
    sigma_m = np.full(C, 2.4 ** 2 / H)

    def in_box(P):
        return np.all((P >= bounds[:, 0]) & (P <= bounds[:, 1]), axis=1)

    def chain_chols(Sigma, sigma_m):
        """One batched (C, H, H) factor of the scaled proposal
        covariances — recomputed only when the adaptation moves them,
        so the per-step proposal is a single batched matmul instead of
        C host multivariate_normal draws (O(C·H³) each)."""
        return _proposal_factors(Sigma * sigma_m[:, None, None])

    like = np.asarray(log_likelihood_batch(X), dtype=float)
    trace_x = [X.copy()]
    trace_f = [like.copy()]
    pooled_hist = [float(like.mean())]     # running per-step chain means:
    accept_hist = []                       # the break test is O(window),
    start = time.time()                    # never a full-trace conversion
    stamps = []
    L = chain_chols(Sigma, sigma_m)

    n_updates = max(int(n_updates), 2)
    for i in range(1, n_updates):
        # batched per-chain Gaussian step: X + L·z in one einsum
        z = rng.standard_normal((C, H))
        prop = X + np.einsum("chk,ck->ch", L, z)
        ok = in_box(prop)
        cand = np.where(ok[:, None], prop, X)
        like_cand = np.asarray(log_likelihood_batch(cand), dtype=float)
        expo = np.where(ok, like_cand - like, -np.inf)
        metr = np.where(expo < 50, np.exp(np.minimum(expo, 50)), 1.1)
        # a NaN exponent (failed likelihood, -inf minus -inf) lands in the
        # 1.1 branch above (NaN < 50 is False) — reject it explicitly
        metr = np.where(np.isnan(expo), 0.0, metr)
        accept = metr > rng.uniform(size=C)
        X = np.where(accept[:, None], cand, X)
        like = np.where(accept, like_cand, like)
        trace_x.append(X.copy())
        trace_f.append(like.copy())
        pooled_hist.append(float(like.mean()))
        stamps.append(time.time() - start)
        accept_hist.append(accept.astype(float))

        if (i % K) == 0 and i >= K:
            rates = np.mean(accept_hist[-K:], axis=0)
            recent = np.stack(trace_x[-K:], axis=0)      # (K, C, H)
            for c in range(C):
                sigma_m[c], Sigma[c] = shaby_update(
                    sigma_m[c], Sigma[c], rates[c], recent[:, c, :], i, K,
                    r_opt=r_opt, c_0=c_0, c_1=c_1)
            L = chain_chols(Sigma, sigma_m)

        if info and (i % 10) == 0:
            print(f"mcmc chains step {i}/{n_updates}: best f(x)= "
                  f"{np.max(trace_f[-1]):.4f}")
        if break_condition == "default" and i >= 1000:
            # O(window): the running pooled means, never the full trace
            if abs(float(np.mean(pooled_hist[-100:]))
                   - float(np.mean(pooled_hist[-200:-100]))) < 1e-3:
                break

    Xs = np.asarray(trace_x)            # (steps, C, H)
    Fs = np.asarray(trace_f)            # (steps, C)
    out = _trace_summary(Xs.reshape(-1, H), Fs.reshape(-1))
    out.update({"f(x)": Fs, "time stamps": stamps, "x": Xs.reshape(-1, H),
                "x_chains": Xs, "n_chains": C})
    return out


class gpMCMC:
    """Customizable per-block Metropolis sampler (contract: ref
    gp_mcmc.py:38-181).  Each likelihood call is one evaluation of the GP's
    marginal likelihood."""

    def __init__(self, log_likelihood_function, bounds=None, prior_function=None,
                 proposal_distributions="normal", args=None):
        self.log_likelihood_function = log_likelihood_function
        if bounds is None and prior_function is None:
            raise AssertionError("Provide either bounds (for the default uniform "
                                 "prior) or a prior_function.")
        if prior_function is None:
            self.prior_function = _uniform_box_log_prior
        else:
            self.prior_function = prior_function
        if proposal_distributions == "normal":
            if bounds is None:
                raise AssertionError("bounds must be provided to initialize the "
                                     "default normal proposal distribution.")
            # shape matrix from the search box: std = 20% of a uniform
            # draw's std over the box
            box_std = (bounds[:, 1] - bounds[:, 0]) * 0.2 / np.sqrt(12)
            proposal_distributions = [ProposalDistribution(
                np.arange(len(bounds)), init_prop_Sigma=np.diag(box_std ** 2))]
        self.proposal_distributions = proposal_distributions
        self.args = args
        self.bounds = bounds
        self.trace = None
        self.mcmc_info = {}

    # ------------------------------------------------------------------
    def run_mcmc(self, *, x0, n_updates=10000, info=False, break_condition=None,
                 run_in_every_iteration=None):
        """Run the sampler; returns the mcmc_info dict (contract: ref
        gp_mcmc.py:96-181)."""
        if not (isinstance(x0, np.ndarray) and x0.ndim == 1):
            raise AssertionError("x0 must be a 1-d np.ndarray")
        # the chain draws from numpy's global state (or the thread's
        # private one): under a mesh every rank must draw the same
        # proposals and accept tests
        sync_host_random(random_state=getattr(_RANDOM, "state", None))
        stop = self._resolve_break(break_condition)
        hook = run_in_every_iteration or (lambda sampler: None)

        t0 = time.time()
        self.trace = {"f(x)": [], "x": [x0], "time stamp": []}
        state = (x0.copy(),
                 self.prior_function(x0, self.bounds, self.args),
                 self.log_likelihood_function(x0, self.args))
        if info:
            print("Starting likelihood. f(x)= ", state[2])

        for i in range(1, max(int(n_updates), 2)):
            for block in self.proposal_distributions:
                state = self._metropolis_block(state, block, i)
            x, _, f = state
            self.trace["x"].append(x)
            self.trace["f(x)"].append(f)
            self.trace["time stamp"].append(time.time() - t0)
            # summarizing the FULL trace every step is O(n^2) in the run
            # length; refresh periodically for hooks/async pollers and
            # exactly once after the loop
            if (i % 25) == 0 or i == 1:
                self._refresh_info()
            hook(self)
            if info and (i % 10) == 0:
                print("Finished ", i, " out of ", n_updates,
                      " iterations. f(x)= ", f)
            if stop(self):
                break
        self._refresh_info()
        return self.mcmc_info

    def _resolve_break(self, break_condition):
        if break_condition is None:
            return lambda sampler: False
        if break_condition == "default":
            return self._default_break_condition
        if callable(break_condition):
            return break_condition
        raise Exception("No valid input for break condition provided!")

    def _refresh_info(self):
        xs = np.asarray(self.trace["x"])
        # xs[0] is the start point, which has no f(x) entry — align so
        # "max x" is the position that actually achieved "max f(x)"
        self.mcmc_info = _trace_summary(xs[1:],
                                        np.asarray(self.trace["f(x)"]))
        self.mcmc_info.update({"f(x)": self.trace["f(x)"],
                               "time stamps": self.trace["time stamp"],
                               "x": xs})

    @staticmethod
    def _default_break_condition(sampler):
        """Stop once the mean likelihood of the last 100 samples matches the
        100 before it to 1e-3 (contract: ref gp_mcmc.py:183-193)."""
        f = sampler.trace["f(x)"]
        if len(f) < 1000:
            return False
        # only the 200-sample tail is needed — converting the whole trace
        # every iteration made the run quadratic in its own length
        return abs(float(np.mean(f[-100:]))
                   - float(np.mean(f[-200:-100]))) < 1e-3

    def _metropolis_block(self, state, block, step):
        """One Metropolis step over ``block``'s index subset."""
        x, lp, ll = state
        proposal = x.copy()
        proposal[block.indices] = block.proposal_dist(
            x[block.indices].copy(), x, block)
        lp_new = self.prior_function(proposal, self.bounds, self.args)
        accepted = False
        if lp_new > -np.inf:
            ll_new = self.log_likelihood_function(proposal, self.args)
            if np.isnan(ll_new):
                raise Exception("Likelihood evaluation = NaN in gpMCMC")
            log_ratio = (lp_new + ll_new) - (lp + ll)
            if np.isnan(log_ratio):     # -inf minus -inf: reject, never
                ratio = 0.0             # auto-accept via the 1.1 branch
            elif log_ratio < 50:
                ratio = np.exp(log_ratio)
            else:
                ratio = 1.1
            accepted = block.auto_accept or ratio > _random().uniform()
            if accepted:
                x, lp, ll = proposal, lp_new, ll_new
        block.jump_trace.append(1.0 if accepted else 0.0)
        block.adapt(step, self)
        return (x, lp, ll)

    def __getstate__(self):
        return self.__dict__

    def __setstate__(self, state):
        self.__dict__.update(state)
