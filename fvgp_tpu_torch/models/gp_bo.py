"""Bayesian-optimization hyperparameter trainer (counterpart of
``fvgp_tpu/models/gp_bo.py``).

The contract is fvGP's ``method='bo'`` (ref gp_bo.py:529-851): the
expensive / noisy / gradient-free LML regime (stochastic-Lanczos
log-determinant, truncated CG), a per-dimension log/linear search-space
warp, a Sobol initial design seeded by the warm start, an inner GP
surrogate (Matérn-5/2 ARD + diagonal-quadratic trend + known or learned
homoscedastic noise), noisy expected improvement, value-and-location
patience convergence, a noise-aware recommendation, a Laplace
theta-posterior with curvature sensitivity, and the ``bo_info`` keys.

As in the JAX package:

* the surrogate is the package's own ``GP`` (``linalg_mode="CholInv"``)
  with torch kernel, mean and noise functions, trained by
  ``train(method="local")`` on the autograd gradient; it lives on the
  device of the model that called ``train`` and computes in float64 (it
  holds tens of points, and its nugget, 1e-7 of the signal, is below
  float32's resolution);
* the noisy-EI acquisition is a function of the surrogate's committed
  state on tensors; a random pre-screen is one batched call, and the
  restarts ascend in lockstep, one autograd call per step on the sum of
  their values (the rows are independent) with a projected Adam;
* the Laplace curvature is an exact ``torch.func.hessian`` of the
  posterior mean.

The Sobol design (``scipy.stats.qmc``, seeded) and the numpy generators stay
on the host.
"""

import dataclasses
import math
import warnings

import numpy as np
import torch
from scipy.stats import qmc

from ..kernels import get_anisotropic_distance_matrix, matern_kernel_diff2

__all__ = ["bayesian_optimize", "default_initial_design_size"]


def default_initial_design_size(dim, max_iter):
    """Sobol design size: the ~2(d+1) rule of thumb clipped into [5, 10d]
    and the evaluation budget (contract: ref gp_bo.py:104-112)."""
    rule = min(max(2 * dim + 2, 5), max(10 * dim, 5))
    return max(2, min(rule, max_iter))


# ---------------------------------------------------------------------------
# search space: unit-cube reparameterization
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _SearchSpace:
    """Unit-cube warp of the hyperparameter box.

    Scale-like hyperparameters (strictly positive bounds) act
    multiplicatively, so they are searched in log space; everything else
    linearly.  ``log_scale`` overrides the positivity heuristic per
    dimension; a log request on a box touching zero is refused with a
    warning (contract: ref gp_bo.py:45-98).
    """

    log_mask: np.ndarray     # (D,) bool — searched logarithmically
    origin: np.ndarray       # (D,) warped lower bound
    width: np.ndarray        # (D,) warped span (>= tiny)
    pinned: np.ndarray = None  # (D,) bool — lower == upper (fixed hp)

    @staticmethod
    def create(bounds, log_scale=None):
        box = np.asarray(bounds, dtype=float)
        loggable = np.all(box > 0.0, axis=1)
        if log_scale is None:
            use_log = loggable
        else:
            want = np.broadcast_to(np.asarray(log_scale, dtype=bool),
                                   (len(box),))
            refused = want & ~loggable
            if refused.any():
                warnings.warn(
                    f"log_scale requested for hyperparameter(s) "
                    f"{list(np.flatnonzero(refused))} whose bounds are not "
                    f"strictly positive; searched linearly instead.")
            use_log = want & loggable
        safe = np.where(loggable[:, None], box, 1.0)
        warped = np.where(use_log[:, None], np.log(safe), box)
        width = warped[:, 1] - warped[:, 0]
        # pinned dimensions (lower == upper): encode needs a nonzero width
        # to divide by, but decode must return the ORIGIN — substituting a
        # width of 1 alone pushed decoded points outside the user's box
        return _SearchSpace(use_log, warped[:, 0],
                            np.where(width > 0.0, width, 1.0),
                            pinned=width <= 0.0)

    @property
    def dim(self):
        return self.origin.size

    def encode(self, theta):
        """Hyperparameters → unit cube, rows of a 2-d array."""
        th = np.atleast_2d(np.asarray(theta, dtype=float))
        w = np.where(self.log_mask, np.log(np.maximum(th, 1e-300)), th)
        return np.clip((w - self.origin) / self.width, 0.0, 1.0)

    def decode(self, u):
        """Unit cube → hyperparameters, rows of a 2-d array."""
        w = self.origin + np.clip(np.atleast_2d(u), 0.0, 1.0) * self.width
        if self.pinned is not None:
            w = np.where(self.pinned, self.origin, w)
        return np.where(self.log_mask, np.exp(w), w)


# ---------------------------------------------------------------------------
# surrogate model pieces (torch functions: autograd trains the surrogate)
# ---------------------------------------------------------------------------

def _surrogate_kernel(x1, x2, hps):
    """Matérn-5/2 ARD: hps[0] signal variance, hps[1:1+D] length scales."""
    d = get_anisotropic_distance_matrix(x1, x2, hps[1:1 + x1.shape[-1]])
    return hps[0] * matern_kernel_diff2(d, 1.0)


def _poly_features(u):
    """Diagonal-quadratic feature map [1, u, u²] — shared between the trend
    fit and the trend evaluation so the two can never drift apart."""
    u = torch.atleast_2d(u)
    return torch.cat([torch.ones((u.shape[0], 1), dtype=u.dtype,
                                 device=u.device), u, u * u], dim=1)


def _quadratic_trend(u_data, y_data):
    """Fit the diagonal-quadratic trend that absorbs the global bowl of the
    likelihood surface.  Returns a prior-mean callable carrying its
    coefficients, or None when the design cannot determine 1+2d
    coefficients with headroom (contract: ref gp_bo.py:265-296)."""
    n, d = u_data.shape
    n_coef = 1 + 2 * d
    if n < 2 * n_coef:
        return None
    F = _poly_features(torch.as_tensor(u_data, dtype=torch.float64)).numpy()
    try:
        coef = np.linalg.lstsq(F, y_data, rcond=None)[0]
    except np.linalg.LinAlgError:
        return None
    if not np.isfinite(coef).all():
        return None

    def mean_f(x, hps):
        x = torch.as_tensor(x, dtype=torch.float64)
        return _poly_features(x) @ torch.as_tensor(coef, dtype=x.dtype,
                                                   device=x.device)

    mean_f.coefficients = np.asarray(coef)
    return mean_f


def _make_learned_noise(dim):
    def noise_f(x, hps):
        return torch.clamp(hps[dim + 1], min=1e-12) * torch.ones(
            x.shape[0], dtype=hps.dtype, device=hps.device)
    return noise_f


def _fit_surrogate(u_data, y_data, v_data, dim, train_max_iter, device):
    """Inner exact GP on the evaluated points, on ``device`` in float64.
    CholInv mode, so the acquisition's variance reads K⁻¹ directly;
    autograd supplies every gradient."""
    from .gp import GP

    mean_f = _quadratic_trend(u_data, y_data)
    if mean_f is not None:
        residual = y_data - mean_f(u_data, None).numpy()
    else:
        residual = y_data - np.mean(y_data)
    scale = float(np.var(residual))
    if not np.isfinite(scale) or scale <= 0.0:
        scale = float(np.var(y_data)) or 1.0

    init = np.concatenate([[scale], np.full(dim, 0.3)])
    bounds = np.vstack([[1e-4 * scale + 1e-12, 1e2 * scale + 1e-9],
                        np.tile([1e-2, 2.0], (dim, 1))])
    # nugget against near-duplicate design rows (a converged BO proposes
    # points a whisker apart)
    nugget = max(1e-7 * scale, 1e-12)

    kwargs = dict(kernel_function=_surrogate_kernel)
    if v_data is not None:
        kwargs["noise_variances"] = np.maximum(np.asarray(v_data, dtype=float),
                                               nugget)
    else:
        init = np.concatenate([init, [max(1e-4 * scale, nugget)]])
        bounds = np.vstack([bounds, [nugget, max(scale, 10.0 * nugget)]])
        kwargs["noise_function"] = _make_learned_noise(dim)
    kwargs["init_hyperparameters"] = init
    if mean_f is not None:
        kwargs["prior_mean_function"] = mean_f

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        gp = GP(u_data, y_data, linalg_mode="CholInv",
                compute_device=str(device), args={"dtype": "float64"},
                **kwargs)
        gp.train(hyperparameter_bounds=bounds, method="local",
                 max_iter=train_max_iter)
    gp._bo_mean_function = mean_f
    gp._bo_learned_noise = (None if v_data is not None
                            else float(gp.hyperparameters[dim + 1]))
    return gp


# ---------------------------------------------------------------------------
# acquisition: noisy EI + its lockstep projected-Adam maximizer
# ---------------------------------------------------------------------------

_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def _make_acquisition(gp, y_best_samples, dim, ascent_steps, ascent_lr):
    """(batched NEI, lockstep multistart ascender, posterior mean) as
    closures over the surrogate's committed state on its device.

    The ascender runs ALL restarts in lockstep: per step one autograd call
    on the sum of the restarts' NEI values (each row depends on its own
    point only, so row i of the gradient is restart i's), an Adam step on
    the negated gradient and the projection onto the unit cube."""
    from .gp_training import projected_adam
    KVinv = gp.kv.KVinv
    dt, dev = KVinv.dtype, KVinv.device

    def tensor(a):
        if torch.is_tensor(a):
            return a.to(dtype=dt, device=dev)
        return torch.as_tensor(np.asarray(a, dtype=np.float64),
                               dtype=dt).to(dev)

    x_data = tensor(gp.x_data)
    hps = tensor(gp.hyperparameters)
    kvinv_y = gp.kv.KVinvY[:, 0].to(dt)
    mean_f = getattr(gp, "_bo_mean_function", None)
    coef = tensor(mean_f.coefficients) if mean_f is not None else None
    y_mean = float(np.mean(np.asarray(gp.y_data)[:, 0]))
    ybs = tensor(y_best_samples)
    floor = torch.as_tensor(1e-10 * max(float(hps[0]), 1e-300), dtype=dt,
                            device=dev)

    def post_mean_var(U):
        """Posterior mean and variance of the rows of U (M, dim)."""
        k = _surrogate_kernel(x_data, U, hps)             # (n, M)
        prior = _poly_features(U) @ coef if coef is not None else y_mean
        mean = prior + kvinv_y @ k
        var = hps[0] - torch.sum(k * (KVinv @ k), dim=0)
        return mean, torch.maximum(var, floor)

    def nei(U):
        mean, var = post_mean_var(U)
        std = torch.sqrt(var)[:, None]
        gap = mean[:, None] - ybs[None, :]
        z = gap / std
        ei = gap * torch.special.ndtr(z) \
            + std * (torch.exp(-0.5 * z * z) * _INV_SQRT_2PI)
        return torch.maximum(torch.mean(ei, dim=1), torch.zeros_like(mean))

    def nei_batch(U):
        return nei(tensor(U))

    def ascent_grad(U):
        U = U.detach().requires_grad_(True)
        with torch.enable_grad():
            return -torch.autograd.grad(nei(U).sum(), U)[0]

    def ascend(U0):
        U = projected_adam(ascent_grad, tensor(U0), ascent_steps, 0.0, 1.0,
                           lr=ascent_lr)
        return U, nei(U)

    def post_mean(u):
        return post_mean_var(u[None, :])[0][0]

    return nei_batch, ascend, post_mean


def _propose(nei_batch, ascend, dim, rng, n_restarts, n_raw):
    """Random pre-screen (one batched call) → top-k starts → lockstep
    ascent → best of {screened, ascended}."""
    screen = rng.random((n_raw, dim))
    screen_vals = nei_batch(screen).cpu().numpy()
    order = np.argsort(-screen_vals)[:max(1, n_restarts)]
    U_fin, v_fin = ascend(screen[order])
    U_fin = U_fin.cpu().numpy()
    v_fin = v_fin.cpu().numpy()
    k = int(np.argmax(v_fin))
    if float(v_fin[k]) >= float(screen_vals[order[0]]):
        return np.clip(U_fin[k], 0.0, 1.0), float(v_fin[k])
    return screen[order[0]], float(screen_vals[order[0]])


def _laplace_posterior(post_mean, u_best, space, device):
    """Laplace theta-posterior from the surrogate curvature (contract: ref
    gp_bo.py:397-435) via an exact ``torch.func.hessian``."""
    u = torch.as_tensor(np.asarray(u_best, dtype=np.float64),
                        dtype=torch.float64).to(device)
    hess = torch.func.hessian(lambda v: -post_mean(v))(u).cpu().numpy()
    jac = np.diag(1.0 / space.width)
    curv = jac @ hess @ jac
    curv = 0.5 * (curv + curv.T)
    if not np.isfinite(curv).all() or np.any(np.linalg.eigvalsh(curv) <= 0.0):
        return None, curv
    try:
        return np.linalg.inv(curv), curv
    except np.linalg.LinAlgError:
        return None, curv


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

_SETTING_DEFAULTS = dict(
    seed=0, n_init=None, n_restarts=3, n_raw=512, n_incumbent_samples=64,
    ei_tolerance=0.0, patience=10, f_rtol=1e-3, x_tol=1e-3, refit_every=1,
    surrogate_train_max_iter=100, ascent_steps=80, ascent_lr=0.05,
    noise_function=None, noise_variance=None, log_scale=None,
)


class _EvalLog:
    """Preallocated record of every objective evaluation: unit-cube point,
    hyperparameters, value, and (optional) reported variance."""

    def __init__(self, capacity, dim):
        self.u = np.empty((capacity, dim))
        self.theta = np.empty((capacity, dim))
        self.y = np.empty(capacity)
        self.v = np.full(capacity, np.nan)
        self.count = 0

    def record(self, u, theta, value, variance):
        i = self.count
        self.u[i] = u
        self.theta[i] = theta
        self.y[i] = value
        if variance is not None:
            self.v[i] = variance
        self.count = i + 1
        return i

    @property
    def U(self):
        return self.u[:self.count]

    @property
    def Y(self):
        return self.y[:self.count]

    @property
    def best(self):
        return int(np.argmin(self.Y))

    def variances(self):
        """Per-point variances for the surrogate: None when nothing was
        reported; partial reports filled with the mean of what is known."""
        v = self.v[:self.count]
        known = v[np.isfinite(v)]
        if known.size == 0:
            return None
        return np.where(np.isfinite(v), v, float(known.mean()))

    def reported_noise(self):
        v = self.v[:self.count]
        known = v[np.isfinite(v)]
        return float(known.mean()) if known.size else None


class _BayesOpt:
    """One BO run.  Host state lives here; every per-iteration numeric step
    (surrogate posterior, acquisition, ascent) runs on ``device``."""

    def __init__(self, objective, bounds, x0, max_iter, settings, info,
                 callback, early_stop, device):
        self.objective = objective
        self.device = device
        self.space = _SearchSpace.create(np.asarray(bounds, dtype=float),
                                         log_scale=settings["log_scale"])
        self.cfg = settings
        self.max_iter = int(max_iter)
        self.info = info
        self.callback = callback
        self.early_stop = early_stop
        self.rng = np.random.default_rng(settings["seed"])
        # capacity covers the forced minimum design size even when the
        # user's budget is smaller (max_iter=1 would overflow the log)
        self.log = _EvalLog(max(self.max_iter, 2), self.space.dim)
        self.x0 = np.asarray(x0, dtype=float)
        self.surrogate = None
        self.post_mean_fn = None
        self.ei_history = []
        self.stopped_early = False
        self.stopping_reason = "budget"
        self._stall = 0
        self._incumbent = (np.inf, None)   # (best value, best unit point)

    # -- plumbing ----------------------------------------------------------
    def _stop_requested(self):
        return callable(self.early_stop) and self.early_stop()

    def _known_variance(self, theta):
        """Observation variance for the evaluation that just happened: the
        caller's noise_function (e.g. the SLQ estimator's self-reported
        spread) wins, then a fixed noise_variance, else unknown."""
        nf = self.cfg["noise_function"]
        if callable(nf):
            v = nf(theta)
            ok = v is not None and np.isfinite(v) and float(v) > 0.0
            return float(v) if ok else None
        fixed = self.cfg["noise_variance"]
        return None if fixed is None else max(float(fixed), 1e-12)

    def _evaluate(self, u_row, iteration):
        theta = self.space.decode(u_row)[0]
        value = float(self.objective(theta))
        if not np.isfinite(value):
            # a failed factorization / diverged solve must not poison the
            # surrogate: stand in a penalty RELATIVE to the observed values
            # (an absolute ~1e302 penalty overflowed np.var in the
            # surrogate fit, killing every subsequent refit)
            seen = self.log.y[:self.log.count]
            finite = seen[np.isfinite(seen)]
            if len(finite):
                spread = float(np.ptp(finite)) or abs(float(finite[0])) or 1.0
                value = float(finite.max()) + 3.0 * spread
            else:
                value = 1e6
        self.log.record(np.asarray(u_row, dtype=float), theta, value,
                        self._known_variance(theta))
        if callable(self.callback):
            b = self.log.best
            self.callback(self.log.theta[b], self.log.y[b], iteration,
                          {"n_evaluations": self.log.count})
        return value

    # -- phases ------------------------------------------------------------
    def _initial_design(self):
        d = self.space.dim
        n_init = self.cfg["n_init"]
        if n_init is None:
            n_init = default_initial_design_size(d, self.max_iter)
        n_init = max(2, min(int(n_init), self.max_iter))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            design = qmc.Sobol(d=d, scramble=True,
                               seed=int(self.cfg["seed"])).random(n_init)
        design[0] = self.space.encode(self.x0)[0]      # warm start
        if self.info:
            print(f"fvgp_tpu_torch bo: space-filling design of {n_init} points in "
                  f"{d} hyperparameters (budget {self.max_iter})")
        for i, row in enumerate(design):
            if self._stop_requested():
                self.stopped_early = True
                self.stopping_reason = "stopped"
                return
            self._evaluate(row, i)
        if self.info and self.log.count:
            print(f"fvgp_tpu_torch bo: design complete, best f(x)= "
                  f"{self.log.Y.min()}")

    def _refit_if_due(self):
        due = (self.surrogate is None
               or self.log.count % max(1, int(self.cfg["refit_every"])) == 0)
        if not due:
            return True
        try:
            # the surrogate models the NEGATED objective (BO maximizes)
            self.surrogate = _fit_surrogate(
                self.log.U, -self.log.Y, self.log.variances(),
                self.space.dim, int(self.cfg["surrogate_train_max_iter"]),
                self.device)
            return True
        except Exception as ex:
            warnings.warn(f"Inner BO surrogate fit failed ({ex}); "
                          f"stopping BO early.")
            self.stopping_reason = "surrogate_fit_failed"
            return False

    def _incumbent_samples(self):
        """Posterior samples of the best observed value (common random
        numbers per iteration) — the 'noisy' in noisy EI."""
        gp = self.surrogate
        U = self.log.U
        m = np.asarray(gp.posterior_mean(U)["m(x)"]).reshape(len(U))
        v = np.asarray(gp.posterior_covariance(
            U, variance_only=True)["v(x)"]).reshape(len(U))
        draws = m[:, None] + np.sqrt(np.maximum(v, 1e-12))[:, None] \
            * self.rng.standard_normal((len(U), self.cfg["n_incumbent_samples"]))
        return np.max(draws, axis=0)

    def _iterate(self):
        """One BO step: refit → acquire → evaluate.  Returns False when the
        loop must stop."""
        if self._stop_requested():
            self.stopped_early = True
            self.stopping_reason = "stopped"
            return False
        if not self._refit_if_due():
            return False

        nei_batch, ascend, self.post_mean_fn = _make_acquisition(
            self.surrogate, self._incumbent_samples(), self.space.dim,
            int(self.cfg["ascent_steps"]), float(self.cfg["ascent_lr"]))
        u_next, ei = _propose(nei_batch, ascend, self.space.dim, self.rng,
                              int(self.cfg["n_restarts"]),
                              int(self.cfg["n_raw"]))
        self.ei_history.append(ei)
        ei_tol = float(self.cfg["ei_tolerance"])
        if ei_tol > 0.0 and ei < ei_tol:
            self.stopping_reason = "ei_tolerance"
            return False

        latest = self._evaluate(u_next, self.log.count)
        if self.info:
            print(f"fvgp_tpu_torch bo evaluation {self.log.count} of at most "
                  f"{self.max_iter}: f(x)= {latest}, best= "
                  f"{self.log.Y.min()}, EI was {ei}")
        return not self._converged()

    def _converged(self):
        """Patience test on BOTH the best value and its location, judged
        against the observed spread (scale-free: the LML may be huge,
        negative, or near zero)."""
        b = self.log.best
        best_val = float(self.log.y[b])
        best_u = self.log.u[b].copy()
        spread = float(np.ptp(self.log.Y))
        scale = spread if spread > 0.0 else max(abs(best_val), 1.0)
        prev_val, prev_u = self._incumbent
        gained = (prev_val - best_val) / scale
        moved = (np.inf if prev_u is None
                 else float(np.linalg.norm(best_u - prev_u)))
        self._stall = (self._stall + 1
                       if gained <= float(self.cfg["f_rtol"])
                       and moved <= float(self.cfg["x_tol"]) else 0)
        self._incumbent = (best_val, best_u)
        patience = int(self.cfg["patience"])
        if patience > 0 and self._stall >= patience:
            self.stopping_reason = "converged"
            return True
        return False

    # -- wrap-up -----------------------------------------------------------
    def _recommend(self):
        """Pick the answer.  Under REPORTED noise the smallest observation
        is partly a lucky draw, so prefer the evaluated point with the best
        surrogate posterior mean unless it is >3σ worse than the best
        observation; a learned noise level never overrides observations
        (it cannot separate estimator noise from surrogate misfit)."""
        best_idx = self.log.best
        reported = self.log.reported_noise()
        learned = (getattr(self.surrogate, "_bo_learned_noise", None)
                   if self.surrogate is not None else None)
        if reported is not None:
            noise_var, noise_learned = reported, False
        elif learned is not None:
            noise_var, noise_learned = float(learned), True
        else:
            noise_var, noise_learned = 0.0, False
        if self.surrogate is not None and reported and noise_var > 0.0:
            try:
                U = self.log.U
                m = np.asarray(self.surrogate.posterior_mean(U)["m(x)"]
                               ).reshape(len(U))
                cand = int(np.argmax(m))        # surrogate is negated
                tol = 3.0 * np.sqrt(noise_var)
                if self.log.y[cand] <= self.log.y[best_idx] + tol:
                    best_idx = cand
            except Exception:
                pass
        return best_idx, noise_var, noise_learned

    def _diagnostics(self, best_idx):
        """Sensitivity ranking + approximate theta-posterior, free from the
        surrogate.  Curvature of the fitted surface is the honest ranking
        (the quadratic trend saturates the ARD values); raw ARD exposed
        separately."""
        gp = self.surrogate
        if gp is None:
            return None, None, None, None, None
        hps = np.asarray(gp.hyperparameters, dtype=float)
        ard = hps[1:1 + self.space.dim]
        post_cov = curv = sens = None
        if self.post_mean_fn is not None:
            try:
                post_cov, curv = _laplace_posterior(
                    self.post_mean_fn, self.log.u[best_idx], self.space,
                    self.device)
                if curv is not None:
                    sens = np.abs(np.diag(curv))
            except Exception:
                pass
        if sens is None:
            sens = 1.0 / np.maximum(ard, 1e-12)
        return hps, ard, sens, post_cov, curv

    def run(self):
        self._initial_design()
        while self.log.count < self.max_iter and not self.stopped_early:
            if not self._iterate():
                break

        if self.log.count == 0:
            # stopped before a single evaluation: nothing to recommend
            # but the starting point
            self.log.record(self.space.encode(self.x0)[0],
                            np.asarray(self.x0, dtype=float), np.inf, None)
            self.log.count = 0       # keep the trace honestly empty
            best_idx, noise_var, noise_learned = 0, 0.0, False
        else:
            best_idx, noise_var, noise_learned = self._recommend()
        theta_best = np.asarray(self.log.theta[best_idx], dtype=float)
        hps, ard, sens, post_cov, curv = self._diagnostics(best_idx)
        if self.info:
            print(f"fvgp_tpu_torch bo finished after {self.log.count} evaluations "
                  f"({self.stopping_reason}): f(x)= {self.log.y[best_idx]} "
                  f"at {theta_best}")
        bo_info = {
            "x": theta_best,
            "f(x)": float(self.log.y[best_idx]),
            "trace x": self.log.theta[:self.log.count].copy(),
            "trace f(x)": self.log.Y.copy(),
            "trace u": self.log.U.copy(),
            "n_evaluations": self.log.count,
            "ei history": np.asarray(self.ei_history),
            "surrogate hyperparameters": hps,
            "ard length scales": ard,
            "sensitivity": sens,
            "posterior covariance": post_cov,
            "curvature": curv,
            "log-transformed dimensions": self.space.log_mask,
            "stopped early": self.stopped_early,
            "stopping reason": self.stopping_reason,
            "observation noise variance": noise_var if noise_var > 0.0 else None,
            "noise was learned": noise_learned,
            "surrogate": self.surrogate,
        }
        return theta_best, bo_info


def bayesian_optimize(objective_function, hyperparameter_bounds,
                      init_hyperparameters, max_iter=50, bo_args=None,
                      info=False, callback=None, early_stop=None,
                      device="cuda"):
    """Minimize ``objective_function`` over ``hyperparameter_bounds`` by
    Bayesian optimization; returns (theta, bo_info).  The surrogate and the
    acquisition run on ``device`` (default: the card).

    ``bo_args`` keys (contract: ref gp_bo.py:556-561): ``log_scale``,
    ``n_init``, ``n_restarts``, ``n_raw``, ``n_incumbent_samples``,
    ``seed``, ``noise_function``, ``noise_variance``,
    ``surrogate_train_max_iter``, ``refit_every``, and the stopping
    controls ``patience``, ``f_rtol``, ``x_tol``, ``ei_tolerance``; plus
    the ascent knobs ``ascent_steps``/``ascent_lr`` (this implementation's
    acquisition maximizer).  ``progress_callback`` / ``stop_requested`` are
    the async-actor plumbing.
    """
    a = dict(bo_args or {})
    if callback is None and "progress_callback" in a:
        pc = a.pop("progress_callback")
        callback = lambda th, f, i, st: pc(th, f)            # noqa: E731
    if early_stop is None and "stop_requested" in a:
        early_stop = a.pop("stop_requested")
    settings = {k: a.get(k, v) for k, v in _SETTING_DEFAULTS.items()}
    from ..config import resolve_device
    device = device if isinstance(device, torch.device) \
        else resolve_device(device)
    run = _BayesOpt(objective_function, hyperparameter_bounds,
                    init_hyperparameters, max_iter, settings, info,
                    callback, early_stop, device)
    return run.run()
