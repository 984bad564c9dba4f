"""GGMP — Gaussian-mixture distributional regression (counterpart of
``fvgp_tpu/models/ggmp.py``; the numpy helpers are copies of its own).

Each input location ("station") observes a probability density rather than a
scalar.  The density is represented as a K-component Gaussian mixture; one
independent GP per component is trained on the component-k means across
stations with the component-k variances as observation noise.  Training is
two-phase: per-GP type-II ML, then EM re-optimization of the mixture weights
against the observed densities or samples.  Posterior mean/variance combine
the K GPs by the law of total variance.

With ``gp_eval_parallel=True`` the K component posteriors share one batched
evaluation: K covariances (one default-kernel call each, on K3 on the card)
stacked into (K, N, N) with the noise diagonals, one batched Cholesky and
batched solves.  The mixture algebra over small K is host work.
"""

import hashlib
import os
import tempfile
from pathlib import Path

import numpy as np
import torch

from .. import config
from ..utils.logging import logger, phase_timer
from .fvgp import fvGP
from .gp import GP
from .gp_posterior import GPposterior

__all__ = ["GGMP", "hyperparameters", "NormalLikelihood", "constant_mean",
           "gaussian_pdf", "empirical_pdf_from_samples",
           "fit_gmm_fixed_weights", "align_gmm_components_hungarian",
           "gaussian_w2_squared", "optimize_weights_em_density",
           "optimize_weights_em_samples", "bhattacharyya_distance",
           "kl_divergence", "wasserstein_1d_density", "wasserstein_1d",
           "fit_station_gmms_cached", "fit_station_gmms_fixed_weights_cached",
           "build_gp_init_kwargs", "train_component_gps_mcmc",
           "prepare_station_terms_density",
           "fit_gmm_free_weights_multivariate", "fit_local_gmms_multivariate",
           "optimize_weights_em_multivariate_samples",
           "loglik_multivariate_mixture_samples", "sample_gmm_multivariate",
           "gaussian_w2_squared_mv", "energy_distance_multivariate",
           "sliced_wasserstein_distance", "mmd_rbf"]


def constant_mean(x, hps):
    """Trainable constant prior mean hps[-1], as a tensor on x's device
    and dtype (ref ggmp.py:35)."""
    return torch.ones(x.shape[0], dtype=x.dtype, device=x.device) \
        * hps[-1].to(x.dtype)

def gaussian_pdf(x, mu, var):
    """(ref ggmp.py:924)."""
    x = np.asarray(x, dtype=float)
    var = max(float(var), 1e-12)
    return np.exp(-0.5 * (x - mu) ** 2 / var) / np.sqrt(2 * np.pi * var)


def _normalize_density(domain, density):
    domain = np.asarray(domain, dtype=float)
    density = np.maximum(np.asarray(density, dtype=float), 0.0)
    dx = np.abs(np.gradient(domain))
    mass = density * dx
    z = mass.sum()
    if z <= 0:
        return domain, np.full_like(density, 1.0 / max(len(domain), 1)), dx
    return domain, mass / z / np.maximum(dx, 1e-300), dx


def empirical_pdf_from_samples(y, *, bins=120):
    """Histogram density from raw samples (ref ggmp.py:954)."""
    y = np.asarray(y, dtype=float).ravel()
    hist, edges = np.histogram(y, bins=bins, density=True)
    centers = 0.5 * (edges[:-1] + edges[1:])
    return centers, hist


def _density_moments(domain, density):
    domain, dens, dx = _normalize_density(domain, density)
    p = dens * dx
    p = p / p.sum()
    mu = float(np.sum(p * domain))
    var = float(np.sum(p * (domain - mu) ** 2))
    return mu, max(var, 1e-6)


# ---------------------------------------------------------------------------
# GMM fitting (1-d, fixed weights) + alignment
# ---------------------------------------------------------------------------

def fit_gmm_fixed_weights(domain, density, K, *, max_iter=200, tol=1e-8,
                          seed=0):
    """EM fit of a K-component 1-d GMM with FIXED uniform weights to a
    (domain, density) pair (ref ggmp.py:967).  Returns (means, variances)."""
    domain, dens, dx = _normalize_density(domain, density)
    p = dens * dx
    p = p / p.sum()
    mu0, var0 = _density_moments(domain, density)
    rng = np.random.default_rng(seed)
    means = mu0 + np.linspace(-1, 1, K) * np.sqrt(var0) \
        + 0.01 * rng.standard_normal(K)
    variances = np.full(K, var0)
    w = np.full(K, 1.0 / K)
    prev = np.inf
    for _ in range(max_iter):
        comp = np.stack([w[k] * gaussian_pdf(domain, means[k], variances[k])
                         for k in range(K)])          # (K, G)
        total = np.maximum(comp.sum(axis=0), 1e-300)
        resp = comp / total                           # responsibilities
        weighted = resp * p[None, :]                  # (K, G)
        mass = np.maximum(weighted.sum(axis=1), 1e-12)
        means = (weighted @ domain) / mass
        variances = np.maximum(
            np.einsum("kg,kg->k", weighted,
                      (domain[None, :] - means[:, None]) ** 2) / mass, 1e-8)
        ll = float(np.sum(p * np.log(total)))
        if abs(ll - prev) < tol:
            break
        prev = ll
    return means, variances


def gaussian_w2_squared(mu1, var1, mu2, var2):
    """Squared 2-Wasserstein distance between Gaussians (ref ggmp.py:1224).

    Scalar (mean, variance) pairs use the closed 1-d form; (d,) means with
    (d, d) covariances use the Bures form
    ||m1-m2||^2 + tr(C1 + C2 - 2 (C1^1/2 C2 C1^1/2)^1/2)."""
    if np.ndim(var1) >= 2:
        return gaussian_w2_squared_mv(mu1, var1, mu2, var2)
    return float((mu1 - mu2) ** 2 + (np.sqrt(var1) - np.sqrt(var2)) ** 2)


def _sym_psd(a):
    a = np.asarray(a, dtype=float)
    return 0.5 * (a + a.T)


def _sqrtm_psd(a, *, eps=1e-12):
    """PSD matrix square root by eigendecomposition (ref ggmp.py:1216)."""
    vals, vecs = np.linalg.eigh(_sym_psd(a))
    return (vecs * np.sqrt(np.clip(vals, eps, None))) @ vecs.T


def gaussian_w2_squared_mv(mean_a, cov_a, mean_b, cov_b):
    """Squared Bures-Wasserstein distance between multivariate Gaussians."""
    diff = np.asarray(mean_a, dtype=float).ravel() \
        - np.asarray(mean_b, dtype=float).ravel()
    ca, cb = _sym_psd(cov_a), _sym_psd(cov_b)
    ra = _sqrtm_psd(ca)
    cross = _sqrtm_psd(ra @ cb @ ra)
    return float(diff @ diff
                 + max(np.trace(ca + cb - 2.0 * cross), 0.0))


def align_gmm_components_hungarian(means_ref, vars_ref, means, variances):
    """Permute components of one GMM to best match a reference by Gaussian-W2
    (ref ggmp.py:1247)."""
    from scipy.optimize import linear_sum_assignment
    K = len(means_ref)
    cost = np.empty((K, K))
    for i in range(K):
        for j in range(K):
            cost[i, j] = gaussian_w2_squared(means_ref[i], vars_ref[i],
                                             means[j], variances[j])
    _, perm = linear_sum_assignment(cost)
    return perm


def build_input_mst(x_data):
    """Minimum spanning tree over station locations; returns (root, parent)
    arrays (ref ggmp.py:1363).  The root is the station closest to the
    centroid (ref ggmp.py:1354)."""
    from scipy.sparse.csgraph import breadth_first_order, minimum_spanning_tree
    from scipy.spatial.distance import squareform, pdist
    x = np.asarray(x_data, dtype=float)
    D = squareform(pdist(x))
    mst = minimum_spanning_tree(D)
    sym = mst + mst.T
    root = int(np.argmin(np.linalg.norm(x - x.mean(axis=0), axis=1)))
    order, parents = breadth_first_order(sym, root, directed=False,
                                         return_predecessors=True)
    return root, order, parents


def align_local_gmms_mst(x_data, means_all, vars_all):
    """Align per-station GMMs along a minimum spanning tree of the input
    locations — robust when stations are scattered rather than sequential
    (ref ggmp.py:1436)."""
    means_out = np.array(means_all, dtype=float)
    vars_out = np.array(vars_all, dtype=float)
    root, order, parents = build_input_mst(x_data)
    for node in order:
        parent = parents[node]
        if parent < 0:
            continue
        perm = align_gmm_components_hungarian(
            means_out[parent], vars_out[parent],
            means_out[node], vars_out[node])
        means_out[node] = means_out[node][perm]
        vars_out[node] = vars_out[node][perm]
    return means_out, vars_out


def align_local_gmms(x_data, means_all, vars_all, method="mst"):
    """Alignment dispatcher: 'mst' (spatial) or 'sequence'
    (ref ggmp.py:1519)."""
    if method == "mst":
        return align_local_gmms_mst(x_data, means_all, vars_all)
    if method == "sequence":
        return align_local_gmms_sequence(means_all, vars_all)
    raise ValueError(f"unknown alignment method {method!r}")


def align_local_gmms_sequence(means_all, vars_all):
    """Align per-station GMMs along the station sequence so component k means
    the same mode everywhere (ref ggmp.py:1287)."""
    means_all = np.asarray(means_all, dtype=float)
    vars_all = np.asarray(vars_all, dtype=float)
    N, K = means_all.shape[:2]
    means_out = means_all.copy()
    vars_out = vars_all.copy()
    for n in range(1, N):
        perm = align_gmm_components_hungarian(means_out[n - 1], vars_out[n - 1],
                                              means_out[n], vars_out[n])
        means_out[n] = means_out[n][perm]
        vars_out[n] = vars_out[n][perm]
    return means_out, vars_out


# ---------------------------------------------------------------------------
# EM weight optimization (phase 2)
# ---------------------------------------------------------------------------

def optimize_weights_em_density(terms, K, *, weight_floor=1e-9, max_iter=200,
                                tol_l1=1e-10, w0=None, log_every=None):
    """EM over mixture weights for the density objective
    (ref ggmp.py:2345).

    terms: (N, G_total stacked) per-station arrays of component densities —
    a list of (K, G_n) arrays with per-gridpoint mass p_n (G_n,) attached as
    tuples (comp_density, mass).
    """
    w = (np.full(K, 1.0 / K) if w0 is None
         else np.asarray(w0, dtype=float) / np.sum(w0))
    history = []
    for it in range(max_iter):
        num = np.zeros(K)
        denom = 0.0
        ll = 0.0
        for comp_density, mass in terms:
            mix = np.maximum(w @ comp_density, 1e-300)      # (G,)
            resp = (w[:, None] * comp_density) / mix        # (K, G)
            num += resp @ mass
            denom += mass.sum()
            ll += float(mass @ np.log(mix))
        w_new = np.maximum(num / max(denom, 1e-300), weight_floor)
        w_new = w_new / w_new.sum()
        history.append(ll)
        if np.abs(w_new - w).sum() < tol_l1:
            w = w_new
            break
        w = w_new
    return w, history, it + 1


def optimize_weights_em_samples(y_samples, means_list, vars_list, K, *,
                                weight_floor=1e-9, max_iter=200, tol_l1=1e-10,
                                w0=None, log_every=None):
    """EM over mixture weights for the raw-samples objective
    (ref ggmp.py:1584)."""
    w = (np.full(K, 1.0 / K) if w0 is None
         else np.asarray(w0, dtype=float) / np.sum(w0))
    history = []
    for it in range(max_iter):
        num = np.zeros(K)
        total = 0
        ll = 0.0
        for samples, mus, vs in zip(y_samples, means_list, vars_list):
            samples = np.asarray(samples, dtype=float).ravel()
            comp = np.stack([gaussian_pdf(samples, mus[k], vs[k])
                             for k in range(K)])            # (K, T)
            mix = np.maximum(w @ comp, 1e-300)
            resp = (w[:, None] * comp) / mix
            num += resp.sum(axis=1)
            total += len(samples)
            ll += float(np.sum(np.log(mix)))
        w_new = np.maximum(num / max(total, 1), weight_floor)
        w_new = w_new / w_new.sum()
        history.append(ll)
        if np.abs(w_new - w).sum() < tol_l1:
            w = w_new
            break
        w = w_new
    return w, history, it + 1


# ---------------------------------------------------------------------------
# density distances (ref ggmp.py:1703-1779, :2402-2441)
# ---------------------------------------------------------------------------

def bhattacharyya_distance(domain, p, q):
    domain, p, dxp = _normalize_density(domain, p)
    _, q, _ = _normalize_density(domain, q)
    bc = float(np.sum(np.sqrt(p * q) * dxp))
    return -np.log(max(bc, 1e-300))


def kl_divergence(domain, p, q):
    domain, p, dx = _normalize_density(domain, p)
    _, q, _ = _normalize_density(domain, q)
    mask = p > 1e-300
    return float(np.sum(p[mask] * np.log(p[mask] / np.maximum(q[mask], 1e-300))
                        * dx[mask]))


def wasserstein_1d_density(domain, p, q):
    domain, p, dx = _normalize_density(domain, p)
    _, q, _ = _normalize_density(domain, q)
    cdf_p = np.cumsum(p * dx)
    cdf_q = np.cumsum(q * dx)
    return float(np.sum(np.abs(cdf_p - cdf_q) * dx))


def energy_distance(x, y, seed=0):
    """Energy distance between two sample sets (ref ggmp.py:1703)."""
    x = np.atleast_2d(np.asarray(x, dtype=float))
    y = np.atleast_2d(np.asarray(y, dtype=float))
    if x.shape[0] == 1:
        x, y = x.T, y.T

    def _mean_dist(a, b):
        return float(np.mean(np.linalg.norm(a[:, None, :] - b[None, :, :],
                                            axis=-1)))
    return 2 * _mean_dist(x, y) - _mean_dist(x, x) - _mean_dist(y, y)


# ---------------------------------------------------------------------------
# GMM-fit disk cache (ref ggmp.py:1781-1988)
# ---------------------------------------------------------------------------

def _atomic_savez(path, **arrays):
    """(ref ggmp.py:2025)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    # suffix must end in .npz or np.savez appends one and the atomic
    # replace would move an empty placeholder into place
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def fit_station_gmms_cached(y_data, K, *, cache_dir=None, align=True,
                            max_iter=200, seed=0):
    """Fit per-station GMMs with a content-hash disk cache
    (ref ggmp.py:1847)."""
    hasher = hashlib.sha256()
    for domain, density in y_data:
        hasher.update(np.ascontiguousarray(np.asarray(domain, float)).tobytes())
        hasher.update(np.ascontiguousarray(np.asarray(density, float)).tobytes())
    hasher.update(str((K, max_iter, seed, align)).encode())
    key = hasher.hexdigest()[:24]
    path = None
    if cache_dir is not None:
        path = Path(cache_dir) / f"ggmp_gmms_{key}.npz"
        if path.exists():
            blob = np.load(path)
            return blob["means"], blob["variances"]
    N = len(y_data)
    means = np.empty((N, K))
    variances = np.empty((N, K))
    for n, (domain, density) in enumerate(y_data):
        means[n], variances[n] = fit_gmm_fixed_weights(domain, density, K,
                                                       max_iter=max_iter,
                                                       seed=seed)
        order = np.argsort(means[n])
        means[n] = means[n][order]
        variances[n] = variances[n][order]
    if align:
        means, variances = align_local_gmms_sequence(means, variances)
    if path is not None:
        _atomic_savez(path, means=means, variances=variances)
    return means, variances


def wasserstein_1d(domain, p, q):
    """W₁ between two densities on a shared grid (ref ggmp.py:2430) —
    the reference ggmp module's name for :func:`wasserstein_1d_density`
    (distinct from the sample-measure ``fvgp_tpu.kernels.wasserstein_1d``)."""
    return wasserstein_1d_density(domain, p, q)


def build_gp_init_kwargs(*, use_gpu=False, gpu_engine="torch"):
    """Convenience for ``GGMP(gp_init_kwargs=..., gp_device_ids=...)``
    (ref ggmp.py:2002): ``compute_device="cuda"`` for a GPU request (the
    engine string is carried in ``args`` for API compatibility), an
    explicit ``"cpu"`` otherwise."""
    if not use_gpu:
        return {"compute_device": "cpu"}, None
    return ({"compute_device": "cuda",
             "args": {"GPU_engine": str(gpu_engine)}}, None)


def fit_station_gmms_fixed_weights_cached(series_list, station_ids, *,
                                          data_path=None, K,
                                          gmm_max_iter=100, gmm_tol=1e-4,
                                          cache=True, cache_dir=None,
                                          log_every=100, logger=None):
    """Fit per-station fixed-weight GMMs from raw SAMPLE series
    (ref ggmp.py:1847): each station's samples become an empirical PDF,
    which is fit by :func:`fit_gmm_fixed_weights`; results are cached to an
    ``.npz`` keyed by a content hash of the series and settings.

    Returns ``(means, variances, cache_path)`` with shapes ``(N, K)``.
    """
    hasher = hashlib.sha256()
    for s in series_list:
        hasher.update(np.ascontiguousarray(np.asarray(s, float)).tobytes())
    hasher.update(np.ascontiguousarray(
        np.asarray(station_ids)).tobytes())
    hasher.update(str((int(K), int(gmm_max_iter), float(gmm_tol))).encode())
    key = hasher.hexdigest()[:24]
    path = None
    if cache and (cache_dir is not None or data_path is not None):
        base = Path(cache_dir) if cache_dir is not None else Path(data_path)
        base.mkdir(parents=True, exist_ok=True)
        path = base / f"ggmp_station_gmms_{key}.npz"
        if path.exists():
            blob = np.load(path)
            return blob["means"], blob["variances"], path
    N = len(series_list)
    means = np.empty((N, K))
    variances = np.empty((N, K))
    for n, s in enumerate(series_list):
        domain, density = empirical_pdf_from_samples(np.asarray(s, float))
        means[n], variances[n] = fit_gmm_fixed_weights(
            domain, density, K, max_iter=int(gmm_max_iter), tol=float(gmm_tol))
        order = np.argsort(means[n])
        means[n] = means[n][order]
        variances[n] = variances[n][order]
        if logger is not None and log_every and (n + 1) % int(log_every) == 0:
            logger.info("fit_station_gmms: %d/%d stations", n + 1, N)
    if path is not None:
        _atomic_savez(path, means=means, variances=variances)
    return means, variances, path


def train_component_gps_mcmc(model, hps_obj, *, n_updates_gp=500,
                             mcmc_until_converged=False, mcmc_chunk=100,
                             mcmc_max_total=5000, mcmc_tol_rel=1e-3,
                             mcmc_patience=3, gp_parallel=False,
                             gp_workers=None, blas_threads_per_gp=None,
                             **_compat):
    """Train each component GP independently by MCMC (ref ggmp.py:2159);
    returns the list of K trained hyperparameter vectors (the caller
    commits them to ``hps_obj``).

    ``gp_parallel=True`` drives the K samplers from a thread pool of
    ``gp_workers`` threads (the reference's multi-GPU round-robin,
    ref ggmp.py:469-503): MCMC's host-side proposal/adaptation work for
    different components overlaps while their likelihood evaluations
    interleave on the device queue.  Grad mode is thread-local, so every
    worker turns autograd off for itself (the default kernel then runs on
    K3 on the card).  ``blas_threads_per_gp`` is accepted and ignored."""
    K = int(model.likelihood_terms)

    @torch.no_grad()
    def _train_one(k):
        gp = model.gps[k]
        bounds = np.asarray(hps_obj.hps_bounds[k], dtype=float)
        if mcmc_until_converged:
            rounds = max(1, int(mcmc_max_total) // max(int(mcmc_chunk), 1))
            hps_k, _ = train_gp_mcmc_until_converged(
                gp, bounds, max_rounds=rounds,
                steps_per_round=int(mcmc_chunk),
                rel_tol=float(mcmc_tol_rel))
        else:
            hps_k = gp.train(method="mcmc", hyperparameter_bounds=bounds,
                             max_iter=int(n_updates_gp))
        return np.asarray(hps_k, dtype=float)

    if gp_parallel and K > 1:
        from concurrent.futures import ThreadPoolExecutor
        workers = int(gp_workers) if gp_workers else min(K, 8)
        with ThreadPoolExecutor(max_workers=workers) as pool:
            return list(pool.map(_train_one, range(K)))
    return [_train_one(k) for k in range(K)]


def prepare_station_terms_density(model, hps_list):
    """Per-station EM ingredients (ref ggmp.py:2301): for station i a tuple
    ``(p_obs, dx, log_pdf_grid)`` with ``log_pdf_grid[j, k] =
    log N(domain[j] | mu_ik, var_ik)`` where ``var_ik`` = GP predictive
    variance + the component's within-likelihood variance.  Returns
    ``(terms, ll_comp)`` with ``ll_comp[k]`` the density-weighted
    log-likelihood mass of component k."""
    if getattr(model, "multi_task", False):
        raise NotImplementedError(
            "prepare_station_terms_density covers single-task GGMP (as in "
            "the reference); multi-task models use "
            "GGMP._station_terms_density, whose terms are per (station, "
            "task).")
    K = int(model.likelihood_terms)
    x = np.asarray(model.x_data, dtype=float)
    mu, var_total = [], []
    for k in range(K):
        gp = model.gps[k]
        gp.set_hyperparameters(np.asarray(hps_list[k], dtype=np.float64))
        m = np.asarray(gp.posterior_mean(x)["m(x)"], dtype=float).reshape(-1)
        v = np.asarray(gp.posterior_covariance(x, variance_only=True)["v(x)"],
                       dtype=float).reshape(-1)
        v = np.maximum(v, 0.0)
        v_comp = max(float(np.mean(model.likelihoods[k].variance)), 1e-9)
        mu.append(m)
        var_total.append(v + v_comp)
    mu = np.stack(mu, axis=1)
    var_total = np.stack(var_total, axis=1)

    terms = []
    ll_comp = np.zeros(K)
    for i, (domain, density) in enumerate(model.y_data):
        domain_n, dens_n, dx = _normalize_density(domain, density)
        p_obs = dens_n
        log_pdf = np.stack([
            np.log(np.maximum(gaussian_pdf(domain_n, mu[i, k],
                                           var_total[i, k]), 1e-300))
            for k in range(K)], axis=1)
        ll_comp += np.sum((p_obs[:, None] * log_pdf) * dx[:, None], axis=0)
        terms.append((p_obs, dx, log_pdf))
    return terms, ll_comp


def train_gp_mcmc_until_converged(gp, bounds, *, max_rounds=5,
                                  steps_per_round=1500, rel_tol=1e-3,
                                  info=False):
    """Run MCMC training in rounds until the LML stops moving
    (ref ggmp.py:2089).  Returns (hyperparameters, rounds_used)."""
    prev = gp.log_likelihood()
    for r in range(int(max_rounds)):
        gp.train(method="mcmc", hyperparameter_bounds=bounds,
                 max_iter=int(steps_per_round))
        cur = gp.log_likelihood()
        if info:
            print(f"mcmc round {r + 1}: LML {prev:.4f} -> {cur:.4f}")
        if abs(cur - prev) <= rel_tol * max(abs(prev), 1.0):
            return np.asarray(gp.hyperparameters), r + 1
        prev = cur
    return np.asarray(gp.hyperparameters), int(max_rounds)


# ---------------------------------------------------------------------------
# parameter containers
# ---------------------------------------------------------------------------

class hyperparameters:
    """Mixture weights + K per-component GP hyperparameter sets with
    flatten/unflatten helpers (ref ggmp.py:781-860)."""

    def __init__(self, weights, weights_bounds, hps, hps_bounds):
        if len(hps) != len(hps_bounds):
            raise Exception("hps and hps_bounds have to be lists of equal length")
        if len(weights) != len(weights_bounds):
            raise Exception("weights and weights_bounds must have equal length")
        self.weights = weights
        self.weights_bounds = weights_bounds
        self.hps = hps
        self.hps_bounds = hps_bounds
        self.number_of_weights = len(weights)
        self.number_of_hps_sets = len(hps)
        self.number_of_hps = [len(h) for h in hps]
        self.vectorized_hps = self.vectorize_hps(weights, hps)
        self.vectorized_bounds = self.vectorize_bounds(weights_bounds, hps_bounds)

    def set(self, weights, hps):
        if len(hps) != len(self.hps_bounds):
            raise Exception("hps and hps_bounds have to be lists of equal length")
        if len(weights) != len(self.weights_bounds):
            raise Exception("weights and weights_bounds must have equal length")
        self.weights = weights
        self.hps = hps
        self.vectorized_hps = self.vectorize_hps(weights, hps)

    def vectorize_hps(self, weights, hps):
        return np.concatenate([np.asarray(weights, dtype=float)]
                              + [np.asarray(h, dtype=float) for h in hps])

    def devectorize_hps(self, v):
        weights = v[:self.number_of_weights]
        hps, idx = [], self.number_of_weights
        for n in self.number_of_hps:
            hps.append(v[idx:idx + n])
            idx += n
        return weights, hps

    def vectorize_bounds(self, weights_bounds, hps_bounds):
        return np.vstack([np.asarray(weights_bounds, dtype=float)]
                         + [np.asarray(b, dtype=float) for b in hps_bounds])

    def devectorize_bounds(self, b):
        weights_bounds = b[:self.number_of_weights]
        bounds, idx = [], self.number_of_weights
        for n in self.number_of_hps:
            bounds.append(b[idx:idx + n])
            idx += n
        return weights_bounds, bounds


class NormalLikelihood:
    """Diagonal Gaussian likelihood of one mixture component
    (ref ggmp.py:862-909)."""

    def __init__(self, mean, variance, weight):
        self.mean = mean
        self.variance = variance
        self.dim = len(mean)
        self.weight = weight
        self.weight_bounds = np.array([0, 1])

    def set_moments(self, mean, variance):
        self.mean = mean
        self.variance = variance

    def set_weight(self, weight):
        self.weight = weight

    def unravel(self):
        return np.concatenate([self.mean, self.variance])

    def ravel(self, vec):
        return vec[:self.dim], vec[self.dim:]


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class GGMP:
    """Gaussian GP for Gaussian-mixture data (ref ggmp.py:40).

    Workflow::

        ggmp = GGMP(x_data, y_data, hps_obj=hps, likelihood_terms=K)
        ggmp.initLikelihoods()
        ggmp.initGPs()
        ggmp.train(method="local", max_iter=200)
        mean = ggmp.posterior_mean(x_pred)
        var  = ggmp.posterior_variance(x_pred)

    ``y_data`` is a list of (domain, density) pairs — one empirical PDF per
    input location.  **Multi-task**: a station entry may instead be a LIST
    of per-task (domain, density) pairs (one PDF per output); the component
    models are then multi-task ``fvGP`` GPs over the task-augmented index
    set (GGMP-on-fvGP — beyond the reference, whose GGMP is single-task).
    """

    def __init__(self, x_data, y_data, *, hps_obj, gp_kernel_functions=None,
                 gp_mean_functions=None, likelihood_terms=5,
                 gp_init_kwargs=None, gp_device_ids=None,
                 gp_eval_parallel=False):
        if len(x_data) != len(y_data):
            raise AssertionError("x_data and y_data have different lengths")
        self.likelihood_terms = likelihood_terms
        self.number_of_GPs = likelihood_terms
        self.len_data = len(x_data)
        self.hps_obj = hps_obj
        self.init_weights = np.full(likelihood_terms, 1.0 / likelihood_terms)
        self.x_data = x_data
        self.y_data = y_data
        # a station entry that is a list of (domain, density) PAIRS (rather
        # than one pair) marks the multi-task case
        first = y_data[0]
        self.multi_task = (isinstance(first, (list, tuple)) and len(first) > 0
                           and isinstance(first[0], (list, tuple))
                           and len(first[0]) == 2
                           and np.ndim(first[0][0]) == 1)
        self.n_tasks = len(first) if self.multi_task else 1
        if self.multi_task and any(len(e) != self.n_tasks for e in y_data):
            raise AssertionError("every station needs the same task count")
        self.gp_kernel_functions = (gp_kernel_functions
                                    or [None] * likelihood_terms)
        if gp_mean_functions is not None:
            self.gp_mean_functions = gp_mean_functions
        elif self.multi_task:
            # fvGP's default mean handles the augmented index set
            self.gp_mean_functions = [None] * likelihood_terms
        else:
            self.gp_mean_functions = [constant_mean] * likelihood_terms
        self.gp_init_kwargs = dict(gp_init_kwargs or {})
        # accepted for API parity: each component GP takes its device from
        # gp_init_kwargs['compute_device']
        self.gp_device_ids = gp_device_ids
        self.gp_eval_parallel = bool(gp_eval_parallel)
        self.likelihoods = []

    # ------------------------------------------------------------------
    def initLikelihoods(self, init_mean=None, init_std=None, weights=None):
        """Seed the K NormalLikelihood objects from per-station empirical
        moments (ref ggmp.py:147-222)."""
        K = self.likelihood_terms
        if init_mean is not None and len(init_mean) != K:
            raise AssertionError("init_mean length must equal likelihood_terms")
        if init_std is not None and len(init_std) != K:
            raise AssertionError("init_std length must equal likelihood_terms")
        if self.multi_task:
            station_means = np.zeros((self.len_data, self.n_tasks))
            station_vars = np.zeros((self.len_data, self.n_tasks))
            for i, tasks in enumerate(self.y_data):
                for t, (domain, density) in enumerate(tasks):
                    station_means[i, t], station_vars[i, t] = \
                        _density_moments(domain, density)
        else:
            station_means = np.zeros(self.len_data)
            station_vars = np.zeros(self.len_data)
            for i, (domain, density) in enumerate(self.y_data):
                station_means[i], station_vars[i] = _density_moments(domain,
                                                                     density)
        self.station_means = station_means
        self.station_vars = station_vars
        if init_mean is None:
            offsets = np.linspace(-1.0, 1.0, K)
            init_mean = [station_means + offsets[k] for k in range(K)]
        if init_std is None:
            init_std = [np.sqrt(station_vars) for _ in range(K)]
        if weights is None:
            weights = np.full(K, 1.0 / K)
        self.likelihoods = [NormalLikelihood(init_mean[k],
                                             np.asarray(init_std[k]) ** 2,
                                             weights[k]) for k in range(K)]
        return self.likelihoods

    def initGPs(self):
        """One GP per component, trained on component-k means with
        component-k variances as noise (ref ggmp.py:224-467)."""
        if not self.likelihoods:
            raise ValueError("Initialize likelihoods first (call initLikelihoods).")
        kwargs = dict(self.gp_init_kwargs)
        kwargs.setdefault("ram_economy", True)
        self._component_GPs = []
        synced = []
        for k in range(self.likelihood_terms):
            init_hps = np.asarray(self.hps_obj.hps[k], dtype=float).copy()
            if self.multi_task:
                # GGMP-on-fvGP: component-k means/variances are (N, No);
                # each component is a multi-task GP over the task-augmented
                # index set (models/fvgp.py)
                y = np.asarray(self.likelihoods[k].mean,
                               dtype=float).reshape(self.len_data,
                                                    self.n_tasks)
                nv = np.maximum(np.asarray(self.likelihoods[k].variance,
                                           dtype=float).reshape(
                                               self.len_data, self.n_tasks),
                                1e-8)
                gp = fvGP(np.asarray(self.x_data, dtype=float), y,
                          init_hyperparameters=init_hps, noise_variances=nv,
                          kernel_function=self.gp_kernel_functions[k],
                          prior_mean_function=self.gp_mean_functions[k],
                          **kwargs)
            else:
                y = np.asarray(self.likelihoods[k].mean, dtype=float).ravel()
                nv = np.maximum(np.asarray(self.likelihoods[k].variance,
                                           dtype=float).ravel(), 1e-8)
                # the last hp is the prior mean under constant_mean: start
                # each component at its own data mean (ref ggmp.py:395-399)
                if self.gp_mean_functions[k] is constant_mean:
                    init_hps[-1] = float(y.mean())
                gp = GP(np.asarray(self.x_data, dtype=float), y,
                        init_hyperparameters=init_hps, noise_variances=nv,
                        kernel_function=self.gp_kernel_functions[k],
                        prior_mean_function=self.gp_mean_functions[k],
                        **kwargs)
            self._component_GPs.append(gp)
            synced.append(np.asarray(gp.hyperparameters, dtype=float).copy())
        self._expert_GPs = self._component_GPs
        self.gps = self._component_GPs
        self.hps_obj.set(self.hps_obj.weights, synced)
        return self.gps

    def build_pairwise_data_generating_normals(self, idx_a, idx_b):
        """K bivariate Gaussians pairing two stations' component moments
        (ref ggmp.py:130-145)."""
        if not self.likelihoods:
            raise ValueError("Call initLikelihoods first.")
        if not (0 <= idx_a < self.len_data and 0 <= idx_b < self.len_data):
            raise IndexError("Datapoint index out of range.")
        joints = []
        for comp in range(self.likelihood_terms):
            lk = self.likelihoods[comp]
            joints.append({"mean": np.array([lk.mean[idx_a], lk.mean[idx_b]]),
                           "cov": np.diag([lk.variance[idx_a],
                                           lk.variance[idx_b]]),
                           "weight": lk.weight})
        return joints

    # ------------------------------------------------------------------
    def train(self, hyperparameter_bounds=None, init_hyperparameters=None,
              method="local", max_iter=120, train_weights=True,
              weight_method="density", weight_max_iter=200, weight_tol=1e-10,
              weight_floor=1e-9, y_samples=None, **kwargs):
        """Two-phase training: per-component GP type-II ML, then EM weights
        (ref ggmp.py:571-693)."""
        if not getattr(self, "gps", None):
            raise ValueError("Call initGPs() before training.")
        for k, gp in enumerate(self.gps):
            bounds = (np.asarray(hyperparameter_bounds[k])
                      if hyperparameter_bounds is not None
                      else np.asarray(self.hps_obj.hps_bounds[k], dtype=float))
            init = (np.asarray(init_hyperparameters[k])
                    if init_hyperparameters is not None
                    else np.asarray(gp.hyperparameters, dtype=float))
            init = np.clip(init, bounds[:, 0], bounds[:, 1])
            gp.set_hyperparameters(init)
            gp.train(hyperparameter_bounds=bounds, init_hyperparameters=init,
                     method=method, max_iter=max_iter, **kwargs)
        synced = [np.asarray(gp.hyperparameters, dtype=float).copy()
                  for gp in self.gps]

        if train_weights:
            K = self.likelihood_terms
            w0 = np.asarray([lk.weight for lk in self.likelihoods], dtype=float)
            if weight_method == "density":
                terms = self._station_terms_density()
                w_opt, _, _ = optimize_weights_em_density(
                    terms, K, weight_floor=weight_floor,
                    max_iter=weight_max_iter, tol_l1=weight_tol, w0=w0)
            elif weight_method == "samples":
                if self.multi_task:
                    raise ValueError("weight_method='samples' is single-task "
                                     "only; use weight_method='density' for "
                                     "multi-task GGMP.")
                if y_samples is None:
                    raise ValueError("y_samples must be provided when "
                                     "weight_method='samples'.")
                x = np.asarray(self.x_data, dtype=float)
                gp_means, gp_vars = self._component_posteriors(x)
                means_list, vars_list = [], []
                mean_noise = np.array([float(np.mean(lk.variance))
                                       for lk in self.likelihoods])
                for n in range(self.len_data):
                    means_list.append(gp_means[:, n])
                    vars_list.append(gp_vars[:, n] + mean_noise)
                w_opt, _, _ = optimize_weights_em_samples(
                    y_samples, means_list, vars_list, K,
                    weight_floor=weight_floor, max_iter=weight_max_iter,
                    tol_l1=weight_tol, w0=w0)
            else:
                raise ValueError(f"Unknown weight_method {weight_method!r}. "
                                 f"Use 'density' or 'samples'.")
            for k in range(K):
                self.likelihoods[k].set_weight(float(w_opt[k]))

        weights = np.asarray([lk.weight for lk in self.likelihoods])
        self.hps_obj.set(weights, synced)
        return synced

    def _station_terms_density(self):
        """Per-station (component densities on the grid, grid mass) for the
        density EM objective (ref ggmp.py:2301)."""
        x = np.asarray(self.x_data, dtype=float)
        gp_means, gp_vars = self._component_posteriors(x)
        mean_noise = np.array([float(np.mean(lk.variance))
                               for lk in self.likelihoods])
        terms = []
        if self.multi_task:
            # one EM term per (station, task): the mixture weights are
            # shared across tasks, so every task's density constrains them
            for n, tasks in enumerate(self.y_data):
                for t, (domain, density) in enumerate(tasks):
                    domain_n, dens_n, dx = _normalize_density(domain, density)
                    mass = dens_n * dx
                    comp = np.stack([
                        gaussian_pdf(domain_n, gp_means[k, n, t],
                                     gp_vars[k, n, t] + mean_noise[k])
                        for k in range(self.likelihood_terms)])
                    terms.append((comp, mass))
            return terms
        for n, (domain, density) in enumerate(self.y_data):
            domain_n, dens_n, dx = _normalize_density(domain, density)
            mass = dens_n * dx
            comp = np.stack([
                gaussian_pdf(domain_n, gp_means[k, n],
                             gp_vars[k, n] + mean_noise[k])
                for k in range(self.likelihood_terms)])
            terms.append((comp, mass))
        return terms

    # ------------------------------------------------------------------

    # ------------------------------------------------------------------
    # component-parallel evaluation (ref ggmp.py:469-503 runs the K GPs in
    # a thread pool / round-robined over GPUs; here the K posteriors share
    # one batched evaluation)
    def _component_posteriors(self, x_pred, need_var=True):
        """(means, variances) stacked over the K components.  With
        ``gp_eval_parallel=True`` and an eligible model (one shared torch
        kernel/mean, vector noises, identical data — multi-task components
        qualify through their shared augmented index set) the K component
        posteriors are one batched evaluation; otherwise the per-GP path
        runs, and the reason is logged."""
        if self.gp_eval_parallel:
            out = self._batched_component_posteriors(x_pred,
                                                     need_var=need_var)
            if out is not None:
                return out
        means = np.stack([gp.posterior_mean(x_pred)["m(x)"]
                          for gp in self.gps])
        gp_vars = np.stack([gp.posterior_covariance(
            x_pred, variance_only=True)["v(x)"]
            for gp in self.gps]) if need_var else None
        return means, gp_vars

    def _batched_refusal(self):
        """Why the components cannot share one batched evaluation, or None
        when they can."""
        gps = self.gps
        if any(getattr(g, "gp2Scale", False) for g in gps):
            # gp2Scale components carry block-sparse covariances; the
            # batched evaluation densifies K full (N, N) kernels
            return "gp2Scale components keep their committed sparse solver"
        p0 = gps[0].prior
        if not (p0.kernel_traceable and p0.k_n_params == 3):
            return "the kernel is not a torch k(x1, x2, hps)"
        if any(g.prior.kernel is not p0.kernel for g in gps):
            return "the components' kernels differ"
        if not all(g.prior._default_mean for g in gps):
            if not (p0.mean_traceable and p0.m_n_params == 2):
                return "the mean is not a torch m(x, hps)"
            if any(g.prior.mean_function is not p0.mean_function
                   for g in gps):
                return "the components' means differ"
        H = len(gps[0].hyperparameters)
        if any(len(g.hyperparameters) != H for g in gps):
            return "the components' hyperparameter counts differ"
        x0 = np.asarray(gps[0].data.x_data, dtype=float)
        for g in gps:
            if not np.array_equal(np.asarray(g.data.x_data, dtype=float), x0):
                return "the components' data points differ"
            V = g.likelihood.V
            if not (torch.is_tensor(V) and V.dim() == 1):
                return "a component's noise is not a vector"
        if self.multi_task and not isinstance(gps[0].data.x_out, np.ndarray):
            return "the tasks are not a 1-d array"
        return None

    def _batched_component_posteriors(self, x_pred, need_var=True):
        """The K component posteriors as one batched evaluation, or None
        when the components cannot share it.  K covariances, one kernel
        call per component (K3 on the card, autograd off), stacked into
        (K, N, N) with the noise diagonals; one batched Cholesky, batched
        solves and the diagonal of k(x*, x*).  With ``need_var=False`` the
        variance slot returns None and no cross solve runs."""
        reason = self._batched_refusal()
        if reason is not None:
            logger.info("GGMP: per-GP component posteriors (%s)", reason)
            return None
        gps = self.gps
        prior = gps[0].prior
        kern, mean_fn = prior.kernel, prior.mean_function
        default_mean = all(g.prior._default_mean for g in gps)
        xp = np.atleast_2d(np.asarray(x_pred, dtype=float))
        n_points = xp.shape[0]
        if self.multi_task:
            # fvGP components share ONE augmented index set: evaluate the
            # batched single-output posterior on the task-augmented points
            # and reshape task-major afterwards (models/fvgp.py contract)
            xp = GPposterior.cartesian_product(xp, gps[0].data.x_out)
        npred = xp.shape[0]
        device, dtype = gps[0].device, prior.dtype

        def tensor(a):
            return config.to_tensor(a, device, dtype)

        ys = [np.asarray(g.data.y_data, dtype=float).ravel() for g in gps]
        with torch.no_grad(), phase_timer("fvgp.ggmp.components"):
            x, xq = tensor(gps[0].data.x_data), tensor(xp)
            hps = [tensor(g.hyperparameters) for g in gps]
            y = tensor(np.stack(ys))
            KV = torch.stack([kern(x, x, h) for h in hps]).to(dtype) \
                + torch.diag_embed(torch.stack(
                    [g.likelihood.V.to(device, dtype) for g in gps]))
            L = torch.linalg.cholesky(KV)
            del KV
            if default_mean:
                mu = tensor([float(np.mean(v)) for v in ys])[:, None]
                m_tr = mu.expand(-1, x.shape[0])
                m_pr = mu.expand(-1, npred)
            else:
                m_tr = torch.stack([mean_fn(x, h) for h in hps])
                m_pr = torch.stack([mean_fn(xq, h) for h in hps])
            alpha = torch.cholesky_solve((y - m_tr)[..., None], L)
            ks = torch.stack([kern(x, xq, h) for h in hps]).to(dtype)
            means = config.to_numpy(
                m_pr + (ks.transpose(1, 2) @ alpha)[..., 0])
            variances = None
            if need_var:
                kdiag = torch.stack([torch.diagonal(kern(xq, xq, h))
                                     for h in hps]).to(dtype)
                sol = torch.cholesky_solve(ks, L)
                variances = config.to_numpy(torch.clamp(
                    kdiag - torch.sum(ks * sol, dim=1), min=0.0))
        self._batched_eval_count = getattr(self, "_batched_eval_count", 0) + 1
        logger.debug("GGMP: batched path served call %d",
                     self._batched_eval_count)
        if self.multi_task:
            # task-major 'F' reshape per component: flat[j*n + i] is
            # (point i, task j) -> (K, n_points, n_tasks)
            K = means.shape[0]
            means = means.reshape(K, -1, n_points).transpose(0, 2, 1)
            if need_var:
                variances = variances.reshape(
                    K, -1, n_points).transpose(0, 2, 1)
        return means, variances

    def posterior_mean(self, x_pred):
        """Weight-averaged component posterior means (ref ggmp.py:695)."""
        if not getattr(self, "gps", None):
            raise ValueError("Call initGPs() before evaluating the posterior.")
        w = np.asarray([lk.weight for lk in self.likelihoods], dtype=float)
        w = w / w.sum()
        means, _ = self._component_posteriors(x_pred, need_var=False)
        return np.einsum("k,k...->...", w, means)

    def posterior_variance(self, x_pred):
        """Mixture variance via the law of total variance
        (ref ggmp.py:726-780): Σ w_k (ν_k + s̄²_k) + Σ w_k (μ_k - μ)²."""
        if not getattr(self, "gps", None):
            raise ValueError("Call initGPs() before evaluating the posterior.")
        w = np.asarray([lk.weight for lk in self.likelihoods], dtype=float)
        w = w / w.sum()
        mean_noise = np.array([float(np.mean(lk.variance))
                               for lk in self.likelihoods])
        means, gp_vars = self._component_posteriors(x_pred)
        variances = gp_vars + mean_noise.reshape((-1,) + (1,) * (gp_vars.ndim - 1))
        mean_total = np.einsum("k,k...->...", w, means)
        expected_var = np.einsum("k,k...->...", w, variances)
        var_of_means = np.einsum("k,k...->...", w, (means - mean_total[None]) ** 2)
        return expected_var + var_of_means

    def posterior_pdf(self, x_pred, domain):
        """Predictive mixture density on a grid at each prediction point."""
        w = np.asarray([lk.weight for lk in self.likelihoods], dtype=float)
        w = w / w.sum()
        mean_noise = np.array([float(np.mean(lk.variance))
                               for lk in self.likelihoods])
        means, gp_vars = self._component_posteriors(x_pred)
        domain = np.asarray(domain, dtype=float)
        n_pred = np.atleast_2d(x_pred).shape[0]
        if self.multi_task:
            out = np.zeros((n_pred, self.n_tasks, len(domain)))
            for k in range(self.likelihood_terms):
                for m in range(n_pred):
                    for t in range(self.n_tasks):
                        out[m, t] += w[k] * gaussian_pdf(
                            domain, means[k, m, t],
                            gp_vars[k, m, t] + mean_noise[k])
            return out
        out = np.zeros((n_pred, len(domain)))
        for k in range(self.likelihood_terms):
            for m in range(out.shape[0]):
                out[m] += w[k] * gaussian_pdf(domain, means[k, m],
                                              gp_vars[k, m] + mean_noise[k])
        return out


# ---------------------------------------------------------------------------
# multivariate-output GMMs (ref ggmp.py:1036-1207, :1556-1779)
# ---------------------------------------------------------------------------

def _as_2d(y):
    """(n,) -> (n, 1); (n, d) passes through (ref ggmp.py:1036)."""
    y = np.asarray(y, dtype=float)
    if y.ndim == 1:
        y = y[:, None]
    if y.ndim != 2:
        raise ValueError("samples must be 1-d or 2-d")
    return y


def _log_mvn_density(y, mean, cov, *, reg=1e-9):
    """Row-wise log N(y | mean, cov) via Cholesky (ref ggmp.py:1556).
    Vectorized over the n rows of y; no scipy.stats object per call."""
    y = _as_2d(y)
    mean = np.asarray(mean, dtype=float).ravel()
    d = mean.size
    cov = _sym_psd(cov) + reg * np.eye(d)
    L = np.linalg.cholesky(cov)
    z = np.linalg.solve(L, (y - mean).T)          # (d, n)
    maha = np.sum(z * z, axis=0)
    logdet = 2.0 * np.sum(np.log(np.diag(L)))
    return -0.5 * (maha + logdet + d * np.log(2.0 * np.pi))


def _kmeanspp(y, K, rng):
    """k-means++ seeding for the EM initial means."""
    n = len(y)
    centers = [y[rng.integers(n)]]
    for _ in range(1, K):
        d2 = np.min(np.stack([np.sum((y - c) ** 2, axis=1)
                              for c in centers]), axis=0)
        total = d2.sum()
        if total > 0:
            centers.append(y[rng.choice(n, p=d2 / total)])
        else:                       # all points coincide with a center
            centers.append(y[rng.integers(n)])
    return np.stack(centers)


def fit_gmm_free_weights_multivariate(y, K, *, covariance_type="diag",
                                      reg_covar=1e-6, n_init=4, max_iter=300,
                                      tol=1e-4, random_state=42,
                                      weight_floor=1e-9, sort_if_1d=True):
    """K-component multivariate GMM with free weights
    (ref ggmp.py:1083, which delegates to sklearn; self-contained
    vectorized EM here — k-means++ seeding, log-space E-step, diag/full
    M-step, best of ``n_init`` restarts).

    Returns (weights (K,), means (K, d), covs (K, d, d), info dict)."""
    y = _as_2d(y)
    n, d = y.shape
    K = int(K)
    if n < K:
        raise ValueError(f"Need at least K samples. n={n}, K={K}")
    cov_type = str(covariance_type).lower()
    if cov_type not in ("diag", "full", "spherical"):
        raise ValueError(f"Unsupported covariance_type={covariance_type!r}")

    base = np.random.default_rng(random_state)
    best = None
    for trial in range(max(1, int(n_init))):
        rng = np.random.default_rng(base.integers(2 ** 63)) \
            if random_state is not None else np.random.default_rng()
        means = _kmeanspp(y, K, rng)
        var0 = np.maximum(y.var(axis=0), reg_covar)
        covs = np.tile(np.diag(var0), (K, 1, 1))
        w = np.full(K, 1.0 / K)
        prev = -np.inf
        n_iter = 0
        converged = False
        for n_iter in range(1, int(max_iter) + 1):
            logp = np.stack([_log_mvn_density(y, means[k], covs[k],
                                              reg=reg_covar)
                             for k in range(K)], axis=1)       # (n, K)
            log_num = logp + np.log(np.maximum(w, 1e-300))
            m = log_num.max(axis=1, keepdims=True)
            log_den = m + np.log(np.sum(np.exp(log_num - m), axis=1,
                                        keepdims=True))
            ll = float(log_den.sum()) / n
            r = np.exp(log_num - log_den)                      # (n, K)
            Nk = np.maximum(r.sum(axis=0), 1e-12)
            w = np.maximum(Nk / n, weight_floor)
            w = w / w.sum()
            means = (r.T @ y) / Nk[:, None]
            for k in range(K):
                diff = y - means[k]
                if cov_type == "full":
                    C = (r[:, k, None] * diff).T @ diff / Nk[k]
                    covs[k] = _sym_psd(C) + reg_covar * np.eye(d)
                elif cov_type == "diag":
                    v = (r[:, k] @ diff ** 2) / Nk[k] + reg_covar
                    covs[k] = np.diag(v)
                else:                                          # spherical
                    v = float((r[:, k] @ np.sum(diff ** 2, axis=1))
                              / (Nk[k] * d)) + reg_covar
                    covs[k] = v * np.eye(d)
            if abs(ll - prev) < tol:
                converged = True
                break
            prev = ll
        if best is None or ll > best[0]:
            best = (ll, w, means, covs.copy(), converged, n_iter)

    ll, w, means, covs, converged, n_iter = best
    if sort_if_1d and d == 1:
        order = np.argsort(means[:, 0])
        w, means, covs = w[order], means[order], covs[order]
    n_cov = {"full": K * d * (d + 1) // 2, "diag": K * d,
             "spherical": K}[cov_type]
    n_params = (K - 1) + K * d + n_cov
    info = {"converged": converged, "n_iter": n_iter, "lower_bound": ll,
            "aic": 2.0 * n_params - 2.0 * ll * n,
            "bic": n_params * np.log(n) - 2.0 * ll * n,
            "covariance_type": cov_type, "reg_covar": float(reg_covar),
            "n_init": int(max(1, n_init))}
    return w, means, covs, info


def fit_local_gmms_multivariate(y_list, K, **kwargs):
    """One free-weight multivariate GMM per station (ref ggmp.py:1159).
    Returns {"weights", "means", "covs", "fit_info", "K", "d"}."""
    rs = kwargs.pop("random_state", 42)
    out = {"weights": [], "means": [], "covs": [], "fit_info": []}
    for i, y in enumerate(y_list):
        w, m, c, info = fit_gmm_free_weights_multivariate(
            y, K, random_state=None if rs is None else rs + i,
            sort_if_1d=False, **kwargs)
        out["weights"].append(w)
        out["means"].append(m)
        out["covs"].append(c)
        out["fit_info"].append(info)
    out["K"] = int(K)
    out["d"] = int(out["means"][0].shape[1])
    return out


def optimize_weights_em_multivariate_samples(y_list, means_list, covs_list, *,
                                             K, weight_floor=1e-9,
                                             max_iter=200, tol_l1=1e-10,
                                             log_every=None, w0=None,
                                             cov_reg=1e-9):
    """EM over SHARED mixture weights for the multivariate-samples objective
    sum_n sum_t log sum_k w_k N(y_nt | mu_nk, C_nk) (ref ggmp.py:1584).
    Returns (weights, weight history, objective history)."""
    K = int(K)
    w = (np.full(K, 1.0 / K) if w0 is None
         else np.maximum(np.asarray(w0, dtype=float).ravel(), 1e-12))
    w = w / w.sum()
    # per-station log-pdf tables do not change across iterations
    tables = []
    for y_n, mus, cvs in zip(y_list, means_list, covs_list):
        y_n = _as_2d(y_n)
        tables.append(np.stack([_log_mvn_density(y_n, mus[k], cvs[k],
                                                 reg=cov_reg)
                                for k in range(K)], axis=1))
    w_hist, obj_hist = [], []
    for _ in range(int(max_iter)):
        counts = np.zeros(K)
        obj = 0.0
        log_w = np.log(np.maximum(w, 1e-300))
        for logp in tables:
            log_num = logp + log_w
            m = log_num.max(axis=1, keepdims=True)
            log_den = m + np.log(np.sum(np.exp(log_num - m), axis=1,
                                        keepdims=True))
            counts += np.exp(log_num - log_den).sum(axis=0)
            obj += float(log_den.sum())
        w_new = np.maximum(counts / max(counts.sum(), 1e-300), weight_floor)
        w_new = w_new / w_new.sum()
        w_hist.append(w_new.copy())
        obj_hist.append(obj)
        if np.abs(w_new - w).sum() < tol_l1:
            w = w_new
            break
        w = w_new
    return w, np.asarray(w_hist), np.asarray(obj_hist)


def loglik_multivariate_mixture_samples(y, weights, means, covs, *,
                                        cov_reg=1e-9):
    """Per-sample mixture log-likelihood (ref ggmp.py:1650)."""
    y = _as_2d(y)
    weights = np.asarray(weights, dtype=float).ravel()
    logp = np.stack([_log_mvn_density(y, means[k], covs[k], reg=cov_reg)
                     for k in range(len(weights))], axis=1)
    log_num = logp + np.log(np.maximum(weights, 1e-300))
    m = log_num.max(axis=1)
    return m + np.log(np.sum(np.exp(log_num - m[:, None]), axis=1))


def sample_gmm_multivariate(weights, means, covs, n_samples, *,
                            random_state=None, cov_reg=1e-9):
    """Draw from a multivariate Gaussian mixture (ref ggmp.py:1674)."""
    rng = np.random.default_rng(random_state)
    weights = np.asarray(weights, dtype=float).ravel()
    means = np.asarray(means, dtype=float)
    comp = rng.choice(len(weights), size=int(n_samples),
                      p=weights / weights.sum())
    out = np.zeros((int(n_samples), means.shape[1]))
    for k in range(len(weights)):
        idx = np.nonzero(comp == k)[0]
        if len(idx):
            C = _sym_psd(covs[k]) + cov_reg * np.eye(means.shape[1])
            out[idx] = rng.multivariate_normal(means[k], C, size=len(idx))
    return out


def _pairwise_sqdist(a, b):
    """||a_i - b_j||^2 by the matmul expansion — O(nm) memory instead of
    the reference's O(nmd) broadcast (ref ggmp.py:1758)."""
    aa = np.sum(a * a, axis=1)
    bb = np.sum(b * b, axis=1)
    return np.maximum(aa[:, None] + bb[None, :] - 2.0 * (a @ b.T), 0.0)


def energy_distance_multivariate(a, b):
    """Energy distance between multivariate sample sets (ref ggmp.py:1703)."""
    a, b = _as_2d(a), _as_2d(b)
    d_ab = np.sqrt(_pairwise_sqdist(a, b))
    d_aa = np.sqrt(_pairwise_sqdist(a, a))
    d_bb = np.sqrt(_pairwise_sqdist(b, b))
    return float(max(2.0 * d_ab.mean() - d_aa.mean() - d_bb.mean(), 0.0))


def sliced_wasserstein_distance(a, b, *, n_projections=64, random_state=42):
    """Mean 1-d Wasserstein distance over random projections
    (ref ggmp.py:1719)."""
    from scipy.stats import wasserstein_distance
    a, b = _as_2d(a), _as_2d(b)
    rng = np.random.default_rng(random_state)
    v = rng.normal(size=(int(max(1, n_projections)), a.shape[1]))
    v = v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-12)
    return float(np.mean([wasserstein_distance(a @ vi, b @ vi) for vi in v]))


def mmd_rbf(a, b, *, gamma=None):
    """Unbiased MMD^2 with an RBF kernel (ref ggmp.py:1743)."""
    a, b = _as_2d(a), _as_2d(b)
    n, m = len(a), len(b)
    if n < 2 or m < 2:
        return float("nan")
    d_aa, d_bb, d_ab = (_pairwise_sqdist(a, a), _pairwise_sqdist(b, b),
                        _pairwise_sqdist(a, b))
    if gamma is None:
        gamma = 1.0 / max(2.0 * float(np.median(d_ab)), 1e-12)
    k_aa = np.exp(-gamma * d_aa)
    k_bb = np.exp(-gamma * d_bb)
    np.fill_diagonal(k_aa, 0.0)
    np.fill_diagonal(k_bb, 0.0)
    return float(k_aa.sum() / (n * (n - 1)) + k_bb.sum() / (m * (m - 1))
                 - 2.0 * np.mean(np.exp(-gamma * d_ab)))
