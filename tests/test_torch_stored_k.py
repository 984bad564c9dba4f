"""The stored-K gp2Scale path through the public ``GP``: the same data, made
from a seed, through the JAX package and the port (CPU, float64) with
``args["gp2Scale_traced_lml"] = False`` — the stored ``BlockSparseMatrix``,
the trial and the committed LML in every sparse linalg mode, posteriors,
``update_gp_data``, the preconditioner and warm-start policy, a prior mean
function, a multi-column y and a stored K carried across by ``interop``.

Tolerances: exact (dense-direct) modes 1e-8; the iterative solves run to
1e-10 in both packages, so posteriors agree to 1e-8 and CG iteration counts
are equal; SLQ log-determinants draw different probes in the two packages
and are held to 3 standard deviations of the variance they report."""

import warnings

import numpy as np
import pytest
import torch

from fvgp_tpu import GP as JaxGP
from fvgp_tpu_torch import GP, gp_from_numpy_state
from fvgp_tpu_torch.kernels import wendland_anisotropic
from fvgp_tpu_torch.models.gp_kv import sequential_linalg_state
from fvgp_tpu_torch.parallel.block_sparse import is_block_sparse

N, B = 500, 64
HPS = np.array([1.0, 1.5, 1.5])
ARGS = {"gp2Scale_block_size": B, "gp2Scale_traced_lml": False,
        "sparse_cg_tol": 1e-10, "sparse_minres_tol": 1e-10,
        "random_logdet_min_num_samples": 32,
        "random_logdet_max_num_samples": 64}
EXACT_MODES = [None, "Chol", "sparseLU", "sparseSolve"]
SLQ_MODES = ["sparseCG", "sparseCGpre", "sparseMINRES", "sparseMINRESpre",
             "sparseCGpre_amg", "sparseMINRESpre_ichol"]


def _data(n=N, seed=3, span=40.0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, span, (n, 2))
    y = np.sin(x[:, 0]) + 0.05 * rng.standard_normal(n)
    return x, y, rng.uniform(0, span, (9, 2))


def _make(cls, x, y, mode, args=None, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if cls is GP:
            kw["compute_device"] = "cpu"
        return cls(x, y, init_hyperparameters=HPS, gp2Scale=True,
                   linalg_mode=mode, args=dict(ARGS, **(args or {})), **kw)


def _journey(gp, xp):
    """Trial LML, committed LML, posterior mean / full covariance /
    variance, with the solver's bookkeeping."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = {"trial": gp.log_likelihood(HPS * 1.05),
               "trial_info": gp.kv.last_solve_info,
               "trial_var": gp.marginal_likelihood.log_likelihood_variance()}
        out["commit"] = gp.log_likelihood()
        out["commit_var"] = gp.marginal_likelihood.log_likelihood_variance()
        out["mean"] = np.asarray(gp.posterior_mean(xp)["m(x)"])
        cov = gp.posterior_covariance(xp)
        out["S"], out["v"] = np.asarray(cov["S"]), np.asarray(cov["v(x)"])
        out["v_only"] = np.asarray(gp.posterior_covariance(
            xp, variance_only=True)["v(x)"])
        out["mode"] = gp.kv.mode
    return out


def _dense_oracle(x, y, xp, hps=HPS, noise=None):
    xt, xpt, h = (torch.as_tensor(np.asarray(a)) for a in (x, xp, hps))
    K = wendland_anisotropic(xt, xt, h).numpy()
    ks = wendland_anisotropic(xt, xpt, h).numpy()
    kk = wendland_anisotropic(xpt, xpt, h).numpy()
    y = np.asarray(y).reshape(len(x), -1)
    nv = (np.mean(np.abs(y)) / 100.0) ** 2 if noise is None else noise
    KV = K + nv * np.eye(len(x))
    ym = y - y.mean()
    lml = -0.5 * (np.sum(ym * np.linalg.solve(KV, ym)) / y.shape[1]
                  + np.linalg.slogdet(KV)[1] + len(x) * np.log(2 * np.pi))
    mean = y.mean() + ks.T @ np.linalg.solve(KV, ym)
    S = kk - ks.T @ np.linalg.solve(KV, ks)
    return lml, mean, S


@pytest.mark.parametrize("mode", EXACT_MODES + SLQ_MODES)
def test_stored_k_lml_and_posteriors_match_jax(mode):
    x, y, xp = _data()
    j = _journey(_make(JaxGP, x, y, mode), xp)
    tgp = _make(GP, x, y, mode)
    assert tgp.kv.mode is None and tgp.kv._KV is None        # all lazy
    t = _journey(tgp, xp)
    assert t["mode"] == j["mode"]
    assert is_block_sparse(tgp.K)
    if mode in EXACT_MODES:
        assert t["trial_var"] is None and t["commit_var"] is None
        np.testing.assert_allclose(t["trial"], j["trial"], rtol=1e-8)
        np.testing.assert_allclose(t["commit"], j["commit"], rtol=1e-8)
        lml, _, _ = _dense_oracle(tgp.x_data, tgp.y_data, xp)
        np.testing.assert_allclose(t["commit"], lml, rtol=1e-8)
    else:
        for key in ("trial", "commit"):
            sd = np.sqrt(t[key + "_var"] + j[key + "_var"])
            assert abs(t[key] - j[key]) <= 3.0 * sd, (key, t[key], j[key], sd)
        if "CG" in mode:
            assert t["trial_info"]["iterations"] \
                == j["trial_info"]["iterations"]
            assert t["trial_info"]["preconditioned"] == ("pre" in mode)
    for key in ("mean", "S", "v", "v_only"):
        np.testing.assert_allclose(t[key], j[key], rtol=0, atol=1e-8,
                                   err_msg=key)
    _, mean, S = _dense_oracle(tgp.x_data, tgp.y_data, xp)
    np.testing.assert_allclose(t["mean"], mean[:, 0], atol=1e-6)
    np.testing.assert_allclose(t["S"], S, atol=1e-6)
    np.testing.assert_allclose(t["v_only"], np.diag(S), atol=1e-6)


def _host_kernel(x1, x2, hps):
    d = np.linalg.norm(x1[:, None, :] / hps[1:] - x2[None, :, :] / hps[1:],
                       axis=-1)
    return hps[0] * np.maximum(1.0 - d, 0.0) ** 4 * (4.0 * d + 1.0)


@pytest.mark.parametrize("mode,extra", [
    ("sparseCGpre", {}), ("sparseCG", {}), ("sparseMINRES", {}),
    ("sparseMINRESpre", {"sparse_preconditioner_type": "schwarz"}),
    ("sparseLU", {}), ("sparseLU", {"sparse_direct_dense_cutoff": 0})])
def test_committed_solves_on_the_stored_operator_match_jax(mode, extra):
    """A kernel that does not run on tensors has no committed fast solver:
    its posteriors solve against the stored K+V, with the tile loop on the
    host."""
    x, y, xp = _data(n=300, seed=5, span=30.0)
    args = dict(extra, **{"gp2Scale_lengthscales": lambda h: h[1:]})
    out = {}
    for name, cls in (("jax", JaxGP), ("torch", GP)):
        gp = _make(cls, x, y, mode, args, kernel_function=_host_kernel)
        assert gp.kv._fast_sparse_solver() is None
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            cov = gp.posterior_covariance(xp)
            out[name] = (np.asarray(gp.posterior_mean(xp)["m(x)"]),
                         np.asarray(cov["S"]), gp.kv.last_solve_info,
                         gp.kv.mode, np.asarray(gp.x_data),
                         np.asarray(gp.y_data))
    j, t = out["jax"], out["torch"]
    assert t[3] == j[3] == mode
    np.testing.assert_allclose(t[0], j[0], atol=1e-8)
    np.testing.assert_allclose(t[1], j[1], atol=1e-8)
    if "CG" in mode or extra.get("sparse_direct_dense_cutoff") == 0:
        assert t[2]["iterations"] == j[2]["iterations"] > 0
    K = _host_kernel(t[4], t[4], HPS)
    ks = _host_kernel(t[4], xp, HPS)
    yd = t[5][:, 0]
    KV = K + (np.mean(np.abs(yd)) / 100.0) ** 2 * np.eye(len(yd))
    np.testing.assert_allclose(
        t[0], yd.mean() + ks.T @ np.linalg.solve(KV, yd - yd.mean()),
        atol=1e-6)


@pytest.mark.parametrize("n_old,stored_first", [(384, True), (400, True),
                                                (384, False)])
def test_update_gp_data_under_gp2scale(n_old, stored_first):
    """An aligned append (384 = 6 tiles of 64) stacks the new tile sets
    onto the stored K; a misaligned one recomputes; with no K stored the
    prior stays lazy.  K is the dense kernel of the new data each time."""
    x, y, xp = _data()
    out = {}
    for name, cls in (("jax", JaxGP), ("torch", GP)):
        if name == "jax" and not stored_first:
            continue            # the port's own rule (ROADMAP section 3)
        gp = _make(cls, x[:n_old], y[:n_old], "sparseCGpre")
        if stored_first:
            assert gp.K.shape == (n_old, n_old)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            gp.update_gp_data(x[n_old:], y[n_old:], append=True)
            out[name] = (gp.K.toarray(), np.asarray(gp.x_data),
                         np.asarray(gp.posterior_mean(xp)["m(x)"]), gp.K.nnz)
            if name == "torch":
                lazy = gp.prior._K
    Kd, xd, mean, nnz = out["torch"]
    xt = torch.as_tensor(xd)
    np.testing.assert_allclose(
        Kd, wendland_anisotropic(xt, xt, torch.as_tensor(HPS)).numpy(),
        atol=1e-12)
    assert Kd.shape == (N, N) and lazy is not None
    if stored_first:
        np.testing.assert_allclose(Kd, out["jax"][0], atol=1e-10)
        np.testing.assert_allclose(mean, out["jax"][2], atol=1e-8)
    _, oracle_mean, _ = _dense_oracle(xd, _reordered_y(x, y, xd), xp)
    np.testing.assert_allclose(mean, oracle_mean[:, 0], atol=1e-6)
    # an overwrite drops the stored K
    gp = _make(GP, x[:n_old], y[:n_old], "sparseCGpre")
    _ = gp.K
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        gp.update_gp_data(x[n_old:], y[n_old:], append=False)
    assert gp.prior._K is None and gp.K.shape == (N - n_old, N - n_old)


def _reordered_y(x, y, xd):
    """y in the model's (Morton) order of the points."""
    lookup = {tuple(p): v for p, v in zip(x, y)}
    return np.array([lookup[tuple(p)] for p in xd])


def test_trial_solve_engages_preconditioner_before_commit():
    x, y, _ = _data()
    gp = _make(GP, x, y, "sparseCGpre")
    kv = gp.kv
    assert kv.mode is None and kv.Preconditioner_operator is None
    gp.log_likelihood(HPS * 1.05)          # trial eval, nothing committed
    assert kv.mode is None                 # still uncommitted...
    assert kv.Preconditioner_operator is not None   # ...but preconditioned
    assert kv.last_solve_info["preconditioned"]
    assert kv.Last_preconditioner_error is None


def test_warm_start_and_preconditioner_reuse_policy_matches_jax():
    """Successive trial evaluations under the MCMC settings: the
    preconditioner is reused until its refresh interval or the drift
    threshold, the warm start is dropped past the drift threshold, and
    every count agrees with the JAX package."""
    x, y, _ = _data()
    args = {"sparse_krylov_warm_start": True,
            "sparse_preconditioner_refresh_interval": 3, "sparse_cg_tol": 1e-8}
    steps = [HPS, HPS * 1.001, HPS * 1.002, HPS * 1.003,
             HPS * np.array([3.0, 1.0, 1.0]), HPS * 1.004]
    logs = {}
    for name, cls in (("jax", JaxGP), ("torch", GP)):
        gp = _make(cls, x, y, "sparseCGpre", args)
        log = []
        for h in steps:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                gp.log_likelihood(h)
            info = gp.kv.last_solve_info
            log.append((info["iterations"], bool(info["warm_start"]),
                        gp.kv.Preconditioner_reuse_counter))
        logs[name] = log
    assert logs["torch"] == logs["jax"]
    its, warm, reuse = zip(*logs["torch"])
    # the first trial starts from the committed solution; past the drift
    # threshold (the fifth step, and the sixth against the fifth) the start
    # is dropped and the preconditioner rebuilt
    assert warm == (True, True, True, True, False, False)
    assert reuse == (0, 1, 2, 0, 0, 0)
    assert max(its[:4]) < min(its[4:])     # warm starts cut the iterations
    # the fingerprint and its drift
    kv = gp.kv
    fp = kv.matrix_fingerprint(kv.addKV(gp.K, gp.V))
    assert fp[0] == (N, N) and fp[1] == gp.K.nnz
    assert kv._fingerprint_drift(fp, fp) == 0.0
    assert kv._fingerprint_drift(fp, None) == np.inf
    scaled = (fp[0], fp[1], fp[2] * 1.2, fp[3])
    assert kv._fingerprint_drift(fp, scaled) == pytest.approx(1 / 6)
    dense = kv.matrix_fingerprint(kv.addKV(gp.K, gp.V).to_dense())
    np.testing.assert_allclose(dense[2:], fp[2:], rtol=1e-10)


def test_sequential_linalg_state_gates_the_reuse_to_mcmc():
    args = {"sparse_krylov_warm_start": True,
            "sparse_preconditioner_refresh_interval": 5, "other": 1}
    with sequential_linalg_state(args, "mcmc"):
        assert args["sparse_krylov_warm_start"] is True
    with pytest.warns(UserWarning, match="disables sequential"):
        with sequential_linalg_state(args, "local"):
            assert args["sparse_krylov_warm_start"] is False
            assert args["sparse_preconditioner_refresh_interval"] == 1
    assert args == {"sparse_krylov_warm_start": True,
                    "sparse_preconditioner_refresh_interval": 5, "other": 1}
    # off the traced path only MCMC trains
    x, y, _ = _data(n=200)
    gp = _make(GP, x, y, "sparseLU")
    with pytest.warns(UserWarning, match="switched to MCMC"):
        gp.train(hyperparameter_bounds=np.array([[0.5, 2.0], [1.0, 2.0],
                                                 [1.0, 2.0]]),
                 method="local", max_iter=3)
    assert "x" in gp.mcmc_info or len(gp.mcmc_info) > 0
    # and it has no gradient there, as in the JAX package
    with pytest.raises(Exception, match="non-traceable"):
        gp.marginal_likelihood.log_likelihood_value_and_gradient(HPS)


def _mean_fn(x, hps):
    return 0.3 * x[:, 0] + 0.1 * hps[0]


def test_prior_mean_function_under_gp2scale_matches_jax():
    x, y, xp = _data()
    y = y + 0.3 * x[:, 0]
    args = {"gp2Scale_traced_lml": True}      # the mean alone leaves the
    out = {}                                  # traced path
    for name, cls in (("jax", JaxGP), ("torch", GP)):
        gp = _make(cls, x, y, "sparseLU", args, prior_mean_function=_mean_fn)
        assert not gp.marginal_likelihood._sparse_traced_ready()
        out[name] = _journey(gp, xp)
    for key in ("trial", "commit"):
        np.testing.assert_allclose(out["torch"][key], out["jax"][key],
                                   rtol=1e-8)
    for key in ("mean", "S"):
        np.testing.assert_allclose(out["torch"][key], out["jax"][key],
                                   atol=1e-8)
    np.testing.assert_allclose(np.asarray(gp.m),
                               _mean_fn(np.asarray(gp.x_data), HPS),
                               atol=1e-12)


def test_multi_column_y_matches_jax():
    x, y, xp = _data()
    Y = np.stack([y, np.cos(x[:, 1])], axis=1)
    out = {}
    for name, cls in (("jax", JaxGP), ("torch", GP)):
        gp = _make(cls, x, Y, "sparseCGpre", {"gp2Scale_traced_lml": True})
        assert not gp.marginal_likelihood._sparse_traced_ready()
        out[name] = _journey(gp, xp)
    j, t = out["jax"], out["torch"]
    assert t["mean"].shape == (9, 2) and t["v"].shape == (9, 2)
    assert t["trial_info"]["iterations"] == j["trial_info"]["iterations"]
    sd = np.sqrt(t["trial_var"] + j["trial_var"])
    assert abs(t["trial"] - j["trial"]) <= 3.0 * sd
    for key in ("mean", "S", "v"):
        np.testing.assert_allclose(t[key], j[key], atol=1e-8)


def test_interop_carries_a_stored_k_across():
    """The JAX model's stored K, as the numpy dict of its ``__getstate__``,
    becomes the port model's stored operator: the trial solve against it
    takes the same iterations and gives the same solution."""
    x, y, _ = _data()
    jgp = _make(JaxGP, x, y, "sparseCGpre")
    state = {"x_data": np.asarray(jgp.x_data),
             "y_data": np.asarray(jgp.y_data), "noise_variances": None,
             "hyperparameters": HPS, "args": dict(jgp.args),
             "linalg_mode": "sparseCGpre", "gp2Scale_batch_size": 10000,
             "K": jgp.K.__getstate__()}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tgp = gp_from_numpy_state(state, compute_device="cpu")
    assert tgp.prior._K is not None                  # carried, not assembled
    np.testing.assert_allclose(tgp.K.toarray(), jgp.K.toarray(), atol=0)
    sols = {}
    for name, gp in (("jax", jgp), ("torch", tgp)):
        KV = gp.kv.addKV(gp.K, gp.V)
        sol = gp.kv.compute_new_KVinvY(KV, gp.m)
        sols[name] = (np.asarray(sol.detach() if torch.is_tensor(sol)
                                 else sol),
                      gp.kv.last_solve_info["iterations"])
    assert sols["torch"][1] == sols["jax"][1]
    np.testing.assert_allclose(sols["torch"][0], sols["jax"][0], atol=1e-8)


@pytest.mark.parametrize("mode", ["sparseCGpre", "sparseLU"])
def test_block_sparse_cross_covariance_path_matches_jax(mode):
    """A cross covariance over the dense-sweep budget arrives as a
    rectangular ``BlockSparseMatrix``: the mean takes ``rmatmat``, the
    covariance densifies one column chunk at a time."""
    x, y, xp = _data()
    args = {"gp2Scale_dense_cross_budget": 1}
    out = {}
    for name, cls in (("jax", JaxGP), ("torch", GP)):
        gp = _make(cls, x, y, mode, args, gp2Scale_batch_size=100)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            k = gp.prior.compute_data_cross_covariance(xp, HPS)
            assert type(k).__name__ == "BlockSparseMatrix"
            cov = gp.posterior_covariance(xp)
            out[name] = (np.asarray(gp.posterior_mean(xp)["m(x)"]),
                         np.asarray(cov["S"]),
                         np.asarray(gp.posterior_covariance(
                             xp, variance_only=True)["v(x)"]))
    for t, j in zip(out["torch"], out["jax"]):
        np.testing.assert_allclose(t, j, atol=1e-8)
    _, mean, S = _dense_oracle(gp.x_data, gp.y_data, xp)
    np.testing.assert_allclose(out["torch"][0], mean[:, 0], atol=1e-6)
    np.testing.assert_allclose(out["torch"][1], S, atol=1e-6)
    np.testing.assert_allclose(out["torch"][2], np.diag(S), atol=1e-6)
