"""The stored K over the ranks of a mesh (ROADMAP item 1.8, second part) on
the CPU: spawned ``gloo`` worlds, float64, the plain K1 twin.

Under a mesh the stored ``BlockSparseMatrix`` is row-owned: each rank holds
the tiles of its own row blocks, and every method gives the whole answer on
every rank (one all-gather per product), so the solvers, the SLQ
log-determinant and the preconditioners run unchanged.  Two worlds, each
with its own deadline (a collective that one rank skips would block the
others; ``WORLD_TIMEOUT`` kills the world instead):

* (a) 8 ranks: the JAX suite's sweep of every sparse linalg mode under a
  mesh (``tests/test_scale.py:669``: N = 500 Morton-ordered, B = 64, the
  traced LML off, CG and MINRES to 1e-10) — the committed and a trial LML,
  the posterior mean, the full covariance and the variance on 6 points —
  held bitwise across the ranks; against the port's one-rank run to 1e-10
  with equal CG iterations, SLQ sample counts and stored-K products (CG,
  MINRES and Lanczos steps alike); against ``fvgp_tpu.GP`` meshless at
  ``tests/test_torch_stored_k.py``'s bounds (exact modes and iterative
  posteriors 1e-8, SLQ log-determinants within 3 standard deviations of
  the variances both report); against the dense oracle at the JAX test's
  own bounds (2% relative LML, 1e-5 mean).  At N = 900, B = 128
  (``test_sharded_covariance_spmm``): ``gp.K @ X`` against the dense
  product, the dense form, diagonal and fingerprint against one rank's,
  and the ranks' tiles partitioning the one-rank tile set; at N = 400,
  B = 64 (7 row blocks) the eighth rank owns none and still answers
  whole.
* (b) 4 ranks: aligned and misaligned appends against a fresh model
  (``tests/test_scale.py:921``), structured (scipy tridiagonal) noise and a
  multi-column y and a custom ``[factor, solve, logdet]`` mode against one
  rank, ``train(method="mcmc")`` off and on the
  traced path from differently seeded ranks, a pickle made on the mesh
  loaded on one rank, ``gp_lin_alg`` CG on the mesh K+V, a carried stored K
  through ``gp_from_numpy_state``, and asynchronous MCMC in lockstep.

The SLQ modes draw 32-64 probes (``tests/test_torch_stored_k.py``'s
settings) to keep the worlds short.  The workers are functions of this
module, looked up by name in each spawned rank, which imports torch and
the port only (JAX runs in the parent while the ranks work)."""

import datetime
import multiprocessing
import os
import pickle
import tempfile
import time
import traceback
import warnings

import numpy as np
import pytest
import scipy.sparse as sps
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: under the suite's
    parallel workers torch's default of a thread per core oversubscribes
    the cores, and loops of small tensor ops slow down tenfold and more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


WORLD_TIMEOUT = 300.0          # seconds for one spawned world, start to end
COLLECTIVE_TIMEOUT = 240.0     # seconds a rank waits in one collective

N, B = 500, 64
HPS = np.array([1.0, 1.5, 1.5])
ARGS = {"gp2Scale_block_size": B, "gp2Scale_traced_lml": False,
        "sparse_cg_tol": 1e-10, "sparse_minres_tol": 1e-10,
        "random_logdet_min_num_samples": 32,
        "random_logdet_max_num_samples": 64}
MODES = ["sparseCG", "sparseMINRES", "sparseCGpre", "sparseMINRESpre",
         "sparseCGpre_schwarz", "sparseCGpre_amg", "sparseMINRESpre_ichol",
         "sparseLU", "sparseSolve", None]
# the modes whose logdet is exact (a dense Cholesky below the cutoff; the
# auto pick at N = 500 is Chol)
EXACT_MODES = {"sparseLU", "sparseSolve", None}
ONE_RANK = 1e-10               # a mesh against one rank, the same probes
PARITY = 1e-8                  # against fvgp_tpu.GP (test_torch_stored_k)
SIGMAS = 3.0
ORACLE_LML, ORACLE_MEAN = 0.02, 1e-5    # tests/test_scale.py:669
BOUNDS = np.array([[0.5, 2.0], [1.0, 2.0], [1.0, 2.0]])


# ---------------------------------------------------------------------------
# spawned worlds
# ---------------------------------------------------------------------------

def _world_main(rank, world, store, out_dir, fn_name):
    torch.set_num_threads(1)
    try:
        import torch.distributed as dist
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, world), rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT))
        try:
            payload = {"ok": globals()[fn_name](rank, world)}
        finally:
            dist.destroy_process_group()
    except BaseException:
        payload = {"error": traceback.format_exc()}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(payload, f)


class _World:
    """``world`` spawned ranks running ``fn_name``; ``results()`` joins
    them within ``WORLD_TIMEOUT`` of the start (killing a world that
    overruns it) and returns each rank's result."""

    def __init__(self, fn_name, world):
        self.dir = tempfile.mkdtemp(prefix="fvgp_mesh_k_")
        store = os.path.join(self.dir, "store")
        ctx = multiprocessing.get_context("spawn")
        self.procs = [ctx.Process(target=_world_main,
                                  args=(r, world, store, self.dir, fn_name))
                      for r in range(world)]
        self.start = time.time()
        for p in self.procs:
            p.start()

    def results(self):
        for p in self.procs:
            p.join(max(0.0, WORLD_TIMEOUT - (time.time() - self.start)))
        hung = [p for p in self.procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(10)
        out = []
        for r in range(len(self.procs)):
            path = os.path.join(self.dir, f"rank{r}.pkl")
            if not os.path.exists(path):
                pytest.fail(f"rank {r} wrote no result ({len(hung)} ranks "
                            f"killed after {WORLD_TIMEOUT:.0f} s)")
            with open(path, "rb") as f:
                payload = pickle.load(f)
            if "error" in payload:
                pytest.fail(f"rank {r} failed:\n{payload['error']}")
            out.append(payload["ok"])
        return out


# ---------------------------------------------------------------------------
# data and journeys (both packages, any rank count)
# ---------------------------------------------------------------------------

def _data(n=N, seed=3):
    """``tests/test_scale.py``'s ``_sparse_dataset``, Morton-ordered."""
    from fvgp_tpu_torch.parallel.ordering import morton_order
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 40.0, (n, 2))
    y = np.sin(x[:, 0]) + 0.05 * rng.standard_normal(n)
    perm = morton_order(x)
    return x[perm], y[perm]


XP = np.random.default_rng(21).uniform(0, 40, (6, 2))


def _gp(cls, x, y, mode, args=None, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if cls.__module__.startswith("fvgp_tpu_torch"):
            kw["compute_device"] = "cpu"
        return cls(x, y, init_hyperparameters=HPS, gp2Scale=True,
                   linalg_mode=mode, args=dict(ARGS, **(args or {})), **kw)


class _ProductCount:
    """Counts the stored K's tile products (one per CG or MINRES iteration,
    Lanczos step or other product) while it is entered."""

    def __enter__(self):
        from fvgp_tpu_torch.parallel import block_sparse as bs
        self.mod, self.real, self.n = bs, bs._plain_product, 0

        def counted(*a, **k):
            self.n += 1
            return self.real(*a, **k)

        bs._plain_product = counted
        return self

    def __exit__(self, *exc):
        self.mod._plain_product = self.real


def _journey(gp):
    """Trial LML, committed LML, posterior mean / full covariance /
    variance, with the solver's bookkeeping."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ml = gp.marginal_likelihood
        out = {"trial": gp.log_likelihood(HPS * 1.05)}
        out["trial_iters"] = (gp.kv.last_solve_info or {}).get("iterations")
        out["trial_var"] = ml.log_likelihood_variance()
        out["trial_samples"] = gp.kv.last_logdet_info.get("num_samples")
        out["commit"] = gp.log_likelihood()
        out["commit_var"] = ml.log_likelihood_variance()
        out["commit_samples"] = gp.kv.last_logdet_info.get("num_samples")
        out["mean"] = np.asarray(gp.posterior_mean(XP)["m(x)"])
        cov = gp.posterior_covariance(XP)
        out["S"], out["v"] = np.asarray(cov["S"]), np.asarray(cov["v(x)"])
        out["v_only"] = np.asarray(gp.posterior_covariance(
            XP, variance_only=True)["v(x)"])
        out["mode"] = gp.kv.mode
    return out


def _port_sweep():
    """The ten modes through the port's ``GP`` (under the active mesh, if
    any), with the stored-K products each took."""
    from fvgp_tpu_torch import GP
    x, y = _data()
    out = {}
    for mode in MODES:
        with _ProductCount() as count:
            res = _journey(_gp(GP, x, y, mode))
        res["products"] = count.n
        out[str(mode)] = res
    return out


def _matrix_checks(mesh):
    """``test_sharded_covariance_spmm``'s model (N = 900, B = 128): the
    stored K's product, dense form, diagonal, fingerprint and tiles."""
    from fvgp_tpu_torch import GP
    from fvgp_tpu_torch.parallel import mesh as pm
    x, y = _data(900)
    gp = _gp(GP, x, y, None, {"gp2Scale_block_size": 128})
    K = gp.K
    X = np.random.default_rng(8).standard_normal((900, 2))
    s = K._store
    out = {"KX": K.matmat(torch.as_tensor(X)).numpy(), "X": X,
           "dense": K.to_dense().numpy(), "diag": K.diagonal().numpy(),
           "tf": K.trace_and_fro(), "live": s.live,
           "rows": s.rows_h.copy(), "cols": s.cols_h.copy(),
           "tiles": s.tiles.numpy().copy(), "nb": K.nb,
           "owned": pm.owned_rows(K.nb, mesh), "nnz": K.nnz,
           "padded": K.padded_tiles_global, "mesh": K.mesh is mesh}
    # 400 points of 64: 7 row blocks, so on 8 ranks the last owns none
    gp = _gp(GP, x[:400], y[:400], None)
    K = gp.K
    out["empty"] = {"live": K._store.live, "KX": K.matmat(
        torch.as_tensor(X[:400])).numpy(), "dense": K.to_dense().numpy(),
        "diag": K.diagonal().numpy(), "tiles": K.diagonal_tiles().numpy()}
    return out


def _sweep_world(rank, world):
    """World (a)."""
    from fvgp_tpu_torch.parallel import mesh as pm
    warnings.simplefilter("ignore")
    mesh = pm.make_mesh(layout="1d")
    with pm.use_mesh(mesh):
        out = {"sweep": _port_sweep(), "matrix": _matrix_checks(mesh)}
    out["ops"] = dict(mesh.ops)
    return out


# -- world (b) --------------------------------------------------------------

def banded_noise(x, hps):
    """SPD tridiagonal noise (``tests/test_structured_noise.py``)."""
    n = len(x)
    off = np.full(n - 1, 0.02)
    return sps.diags([off, np.full(n, 0.05), off], [-1, 0, 1]).tocsr()


def _append(n_old):
    """A stored K, then an append of the rest of the 600 points, against a
    fresh model of the same points in the same order."""
    from fvgp_tpu_torch import GP
    x, y = _data(600)
    gp = _gp(GP, x[:n_old], y[:n_old], None)
    assert gp.K.shape == (n_old, n_old)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        gp.update_gp_data(x[n_old:], y[n_old:], append=True)
        v_app = gp.log_likelihood()
    K = gp.K
    fresh = _gp(GP, np.asarray(gp.x_data).copy(), gp.y_data[:, 0].copy(),
                None, {"gp2Scale_reorder": False})
    return (v_app, fresh.log_likelihood(), K.shape, K.mesh, K.toarray(),
            fresh.K.toarray())


def _structured(kind):
    """A scipy noise callable, or a two-column y, on the stored K+V
    (sparseCGpre: CG, the preconditioner and SLQ on the merged tiles)."""
    from fvgp_tpu_torch import GP
    x, y = _data(300)
    kw = {}
    if kind == "noise":
        kw["noise_function"] = banded_noise
    else:
        y = np.stack([y, np.cos(x[:, 1])], axis=1)
    out = _journey(_gp(GP, x, y, "sparseCGpre", **kw))
    out.pop("mode")
    return out


def _mcmc(traced, seed):
    """``train(method="mcmc", max_iter=4)`` from numpy's global state
    seeded with ``seed``: off the traced path (the stored K, the auto mode)
    or on it (the traced mesh LML, sparseCGpre)."""
    from fvgp_tpu_torch import GP
    x, y = _data(300)
    gp = _gp(GP, x, y, "sparseCGpre" if traced else None,
             {"gp2Scale_traced_lml": traced})
    assert gp.marginal_likelihood._sparse_traced_ready() == traced
    np.random.seed(seed)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return gp.train(hyperparameter_bounds=BOUNDS, method="mcmc",
                        max_iter=4, init_hyperparameters=HPS)


def _custom_mode():
    """A custom ``[factor, solve, logdet]`` mode on the dense Cholesky of
    the stored K+V it is handed (whole on every rank under a mesh)."""
    def factor(KV):
        return torch.linalg.cholesky(KV.to_dense())

    def solve(L, b):
        return torch.cholesky_solve(b if b.dim() == 2 else b[:, None], L)

    def logdet(L):
        return float(2.0 * torch.log(torch.diagonal(L)).sum())

    return [factor, solve, logdet]


def _custom():
    from fvgp_tpu_torch import GP
    x, y = _data(300)
    gp = _gp(GP, x, y, _custom_mode())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (gp.log_likelihood(HPS * 1.05), gp.log_likelihood(),
                np.asarray(gp.posterior_mean(XP)["m(x)"]))


def _gla(gp):
    """``gp_lin_alg``'s preconditioned CG on the model's stored K+V."""
    from fvgp_tpu_torch import gp_lin_alg as gla
    KV = gp.kv.KV
    _, M = gla.calculate_sparse_preconditioner(KV)
    return gla.calculate_sparse_conj_grad(
        KV, np.asarray(gp.y_data)[:, 0], M=M,
        args={"sparse_cg_tol": 1e-12, "sparse_cg_maxiter": 1000})


def _carried_state(K):
    """A ``gp_from_numpy_state`` dict of the 300-point model, carrying
    ``K``'s numpy state."""
    x, y = _data(300)
    return {"x_data": x, "y_data": y, "noise_variances": None,
            "hyperparameters": HPS, "args": dict(ARGS),
            "linalg_mode": "sparseLU", "K": K.__getstate__()}


def _models_world(rank, world):
    """World (b)."""
    from fvgp_tpu_torch import GP, gp_from_numpy_state
    from fvgp_tpu_torch.parallel import mesh as pm
    warnings.simplefilter("ignore")
    mesh = pm.make_mesh(layout="1d")
    out = {}
    with pm.use_mesh(mesh):
        out["append"] = {n_old: _append(n_old) for n_old in (384, 500)}
        out["append"] = {k: v[:3] + (v[3] is mesh,) + v[4:]
                         for k, v in out["append"].items()}
        for kind in ("noise", "y2"):
            out[kind] = _structured(kind)
        out["custom"] = _custom()
        # differently seeded ranks: the chains must agree all the same
        out["mcmc"] = _mcmc(False, rank)
        out["mcmc_traced"] = _mcmc(True, rank)
        x, y = _data(300)
        gp = _gp(GP, x, y, "sparseLU")
        out["lml"] = gp.log_likelihood()
        out["pickle"] = pickle.dumps(gp)       # every rank: a collective
        out["gla"] = _gla(gp)
        carried = gp_from_numpy_state(_carried_state(gp.K),
                                      compute_device="cpu")
        K = carried.prior.K
        out["carried"] = (K.mesh is mesh, K._store.rows_h.tolist(),
                          pm.owned_rows(K.nb, mesh), K.nb,
                          carried.log_likelihood())
        dense = GP(x[:50], y[:50], init_hyperparameters=np.ones(3),
                   compute_device="cpu")
        np.random.seed(rank)
        opt = dense.train(hyperparameter_bounds=BOUNDS, method="mcmc",
                          max_iter=4, asynchronous=True)
        opt.actor.join(120)
        out["async"] = (opt.is_done(), opt.actor.published_steps(),
                        dense.update_hyperparameters(opt))
    if rank:
        out.pop("pickle")
    out["ops"] = dict(mesh.ops)
    return out


# ---------------------------------------------------------------------------
# the parent's side: JAX meshless, the port on one rank, the dense oracle
# ---------------------------------------------------------------------------

def _jax_sweep():
    from fvgp_tpu import GP as JaxGP
    x, y = _data()
    return {str(mode): _journey(_gp(JaxGP, x, y, mode)) for mode in MODES}


def _dense_oracle(x, y, xp, hps=HPS):
    from fvgp_tpu_torch.kernels import wendland_anisotropic
    xt, xpt, h = (torch.as_tensor(np.asarray(a)) for a in (x, xp, hps))
    K = wendland_anisotropic(xt, xt, h).numpy()
    ks = wendland_anisotropic(xt, xpt, h).numpy()
    y = np.asarray(y).reshape(len(x), -1)
    KV = K + (np.mean(np.abs(y)) / 100.0) ** 2 * np.eye(len(x))
    ym = y - y.mean()
    lml = -0.5 * (np.sum(ym * np.linalg.solve(KV, ym)) / y.shape[1]
                  + np.linalg.slogdet(KV)[1] + len(x) * np.log(2 * np.pi))
    return lml, y.mean() + ks.T @ np.linalg.solve(KV, ym)


@pytest.fixture(scope="module")
def worlds():
    """Both worlds spawned at once; the parent meanwhile runs the JAX
    package meshless, the port on one rank and the oracle."""
    sweep_world = _World("_sweep_world", 8)
    models_world = _World("_models_world", 4)
    warnings.simplefilter("ignore")
    jax_sweep = _jax_sweep()
    one = {"sweep": _port_sweep(), "matrix": _matrix_checks(None),
           "y2": _structured("y2"), "noise": _structured("noise"),
           "custom": _custom(),
           "mcmc": _mcmc(False, 0), "mcmc_traced": _mcmc(True, 0)}
    from fvgp_tpu_torch import GP
    x, y = _data(300)
    gp = _gp(GP, x, y, "sparseLU")
    one["lml"], one["K"], one["gla"] = gp.log_likelihood(), gp.K.toarray(), \
        _gla(gp)
    x5, y5 = _data()
    oracle = _dense_oracle(x5, y5, XP)
    return {"a": sweep_world.results(), "b": models_world.results(),
            "jax": jax_sweep, "one": one, "oracle": oracle}


# ---------------------------------------------------------------------------
# world (a)
# ---------------------------------------------------------------------------

_KEYS = ("trial", "commit", "mean", "S", "v", "v_only")


@pytest.mark.parametrize("mode", [str(m) for m in MODES])
def test_every_rank_returns_the_same_bits(worlds, mode):
    ranks = [r["sweep"][mode] for r in worlds["a"]]
    for other in ranks[1:]:
        for key, value in ranks[0].items():
            if isinstance(value, np.ndarray):
                np.testing.assert_array_equal(other[key], value, key)
            else:
                assert other[key] == value, key


@pytest.mark.parametrize("mode", [str(m) for m in MODES])
def test_eight_ranks_match_one_rank(worlds, mode):
    """The mesh against the port's meshless run: the same solves and
    probes, so 1e-10 and equal counts of CG iterations, SLQ samples and
    stored-K products."""
    got, one = worlds["a"][0]["sweep"][mode], worlds["one"]["sweep"][mode]
    assert got["mode"] == one["mode"]
    for key in ("trial_iters", "trial_samples", "commit_samples",
                "products"):
        assert got[key] == one[key], key
    for key in ("trial", "commit"):
        assert abs(got[key] - one[key]) <= ONE_RANK * abs(one[key]), key
    for key in ("mean", "S", "v", "v_only"):
        np.testing.assert_allclose(got[key], one[key], rtol=0,
                                   atol=ONE_RANK, err_msg=key)


@pytest.mark.parametrize("mode", [str(m) for m in MODES])
def test_eight_ranks_match_jax(worlds, mode):
    """Against ``fvgp_tpu.GP`` meshless, at test_torch_stored_k's bounds:
    exact LMLs and every posterior 1e-8, equal CG iterations, SLQ
    log-determinants within 3 standard deviations."""
    t, j = worlds["a"][0]["sweep"][mode], worlds["jax"][mode]
    assert t["mode"] == j["mode"]
    if mode in {str(m) for m in EXACT_MODES}:
        assert t["trial_var"] is None and t["commit_var"] is None
        for key in ("trial", "commit"):
            assert abs(t[key] - j[key]) <= PARITY * abs(j[key]), key
    else:
        for key in ("trial", "commit"):
            sd = np.sqrt(t[key + "_var"] + j[key + "_var"])
            assert abs(t[key] - j[key]) <= SIGMAS * sd, (key, t[key], j[key])
        if "CG" in mode:
            assert t["trial_iters"] == j["trial_iters"]
    for key in ("mean", "S", "v", "v_only"):
        np.testing.assert_allclose(t[key], j[key], rtol=0, atol=PARITY,
                                   err_msg=key)


@pytest.mark.parametrize("mode", [str(m) for m in MODES])
def test_eight_ranks_meet_the_dense_oracle(worlds, mode):
    """``tests/test_scale.py:669``'s own bounds."""
    got = worlds["a"][0]["sweep"][mode]
    lml, mean = worlds["oracle"]
    assert abs(got["commit"] - lml) / abs(lml) < ORACLE_LML
    np.testing.assert_allclose(got["mean"], mean[:, 0], atol=ORACLE_MEAN)


def test_stored_k_product_matches_the_dense_product(worlds):
    for out in worlds["a"]:
        m = out["matrix"]
        assert m["mesh"]
        np.testing.assert_allclose(m["KX"], m["dense"] @ m["X"], rtol=0,
                                   atol=1e-12)


def test_stored_k_methods_equal_one_rank(worlds):
    one = worlds["one"]["matrix"]
    for out in worlds["a"]:
        m = out["matrix"]
        np.testing.assert_array_equal(m["dense"], one["dense"])
        np.testing.assert_array_equal(m["diag"], one["diag"])
        assert m["tf"][0] == one["tf"][0]
        assert abs(m["tf"][1] - one["tf"][1]) <= 1e-12 * one["tf"][1]
        assert m["nnz"] == one["nnz"]


def test_a_rank_without_rows_gives_the_whole_answer(worlds):
    """N = 400 in tiles of 64 on 8 ranks: rank 7 owns no row block and
    holds sentinels only; its products, dense form, diagonal and diagonal
    tiles are still the whole matrix's."""
    one = worlds["one"]["matrix"]["empty"]
    assert worlds["a"][-1]["matrix"]["empty"]["live"] == 0
    for out in worlds["a"]:
        m = out["matrix"]["empty"]
        np.testing.assert_allclose(m["KX"], one["KX"], rtol=0, atol=1e-12)
        for key in ("dense", "diag", "tiles"):
            np.testing.assert_array_equal(m[key], one[key], key)


def test_ranks_hold_only_their_rows_and_partition_the_tiles(worlds):
    """Each rank stores its own row blocks' tiles (a rank of W = 1 row
    block may hold sentinels only); the live counts sum to one rank's, the
    live tiles are one rank's tiles, and every rank pads to the largest
    rank's bucket, as the JAX package's layout does."""
    from fvgp_tpu_torch.parallel.sharded_cov import _bucket
    one = worlds["one"]["matrix"]
    ranks = [out["matrix"] for out in worlds["a"]]
    nb = one["nb"]
    assert sum(m["live"] for m in ranks) == one["live"]
    key = {}
    for r, m in enumerate(ranks):
        r0, W = m["owned"]
        assert r0 == r * W and W == 1
        live = m["rows"] < nb
        assert np.all((m["rows"][live] >= r0) & (m["rows"][live] < r0 + W))
        assert np.all(m["rows"][~live] == nb)
        assert np.all(np.diff(m["rows"]) >= 0)          # row-sorted
        for i, j, t in zip(m["rows"][live], m["cols"][live],
                           m["tiles"][live]):
            key[(int(i), int(j))] = t
    live = one["rows"] < nb
    assert len(key) == int(live.sum())
    for i, j, t in zip(one["rows"][live], one["cols"][live],
                       one["tiles"][live]):
        np.testing.assert_array_equal(key[(int(i), int(j))], t)
    pad = _bucket(max(m["live"] for m in ranks))
    assert all(len(m["rows"]) == pad for m in ranks)
    assert all(m["padded"] == 8 * pad for m in ranks)
    assert worlds["a"][0]["ops"]["all_gather"] > 0


# ---------------------------------------------------------------------------
# world (b)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_old", [384, 500])
def test_append_under_the_mesh_matches_a_fresh_model(worlds, n_old):
    """An aligned (384 = 6 tiles of 64) and a misaligned append of a stored
    K: the row-owned K is recomputed on the mesh, and the LML and K are a
    fresh model's."""
    for out in worlds["b"]:
        v_app, v_fresh, shape, on_mesh, K, K_fresh = out["append"][n_old]
        assert shape == (600, 600) and on_mesh
        np.testing.assert_allclose(v_app, v_fresh, rtol=1e-6)
        np.testing.assert_allclose(K, K_fresh, rtol=0, atol=1e-12)


@pytest.mark.parametrize("kind", ["noise", "y2"])
def test_structured_noise_and_multi_column_y_match_one_rank(worlds, kind):
    one = worlds["one"][kind]
    for out in worlds["b"]:
        got = out[kind]
        assert got["trial_samples"] == one["trial_samples"]
        assert got["trial_iters"] == one["trial_iters"]
        for key in ("trial", "commit"):
            assert abs(got[key] - one[key]) <= ONE_RANK * abs(one[key]), key
        for key in ("mean", "S", "v", "v_only"):
            np.testing.assert_allclose(got[key], one[key], rtol=0,
                                       atol=ONE_RANK, err_msg=key)


def test_a_custom_mode_is_handed_the_whole_matrix(worlds):
    """A custom ``[factor, solve, logdet]`` receives the mesh K+V, whose
    ``to_dense`` is whole on every rank: the LMLs and the mean are one
    rank's."""
    one = worlds["one"]["custom"]
    for out in worlds["b"]:
        trial, commit, mean = out["custom"]
        assert abs(trial - one[0]) <= ONE_RANK * abs(one[0])
        assert abs(commit - one[1]) <= ONE_RANK * abs(one[1])
        np.testing.assert_allclose(mean, one[2], rtol=0, atol=ONE_RANK)


@pytest.mark.parametrize("path", ["mcmc", "mcmc_traced"])
def test_differently_seeded_ranks_train_the_same_chain(worlds, path):
    """Each rank seeds numpy's global state with its own rank before
    ``train(method="mcmc")``; every rank must still return rank 0's chain,
    which is a one-rank run from seed 0 — off the traced path and on the
    traced mesh path alike."""
    ranks = [out[path] for out in worlds["b"]]
    for got in ranks[1:]:
        np.testing.assert_array_equal(got, ranks[0])
    np.testing.assert_allclose(ranks[0], worlds["one"][path], rtol=1e-12)
    assert worlds["b"][0]["ops"]["broadcast"] >= 2


def test_without_a_mesh_the_host_random_state_is_untouched():
    """One rank, or no mesh: ``sync_host_random`` neither draws nor
    communicates, so a single process keeps its chain bit for bit."""
    import types

    from fvgp_tpu_torch.parallel.mesh import sync_host_random
    np.random.seed(5)
    before = np.random.get_state()[1].copy()
    sync_host_random(None)
    sync_host_random(types.SimpleNamespace(size=1))
    np.testing.assert_array_equal(np.random.get_state()[1], before)


def test_a_pickle_made_on_the_mesh_loads_on_one_rank(worlds):
    gp = pickle.loads(worlds["b"][0]["pickle"])
    assert gp.K.mesh is None
    np.testing.assert_array_equal(gp.K.toarray(), worlds["one"]["K"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        lml = gp.log_likelihood()
    assert abs(lml - worlds["b"][0]["lml"]) <= ONE_RANK * abs(lml)
    assert abs(lml - worlds["one"]["lml"]) <= ONE_RANK * abs(lml)


def test_gp_lin_alg_cg_on_the_mesh_k(worlds):
    for out in worlds["b"]:
        np.testing.assert_allclose(out["gla"], worlds["one"]["gla"], rtol=0,
                                   atol=ONE_RANK)


def test_a_carried_stored_k_keeps_each_rank_its_rows(worlds):
    for out in worlds["b"]:
        on_mesh, rows, (r0, W), nb, lml = out["carried"]
        assert on_mesh
        assert all(r0 <= r < min(r0 + W, nb) for r in rows)
        assert abs(lml - worlds["one"]["lml"]) <= ONE_RANK * abs(lml)


def test_asynchronous_training_is_refused_under_the_mesh(worlds):
    """No longer refused: asynchronous MCMC from differently seeded ranks
    runs in lockstep under the mesh, and the agreed poll gives every rank
    the same hyperparameters (``tests/test_torch_async_mesh.py`` holds
    the design in full)."""
    done, steps, hps = worlds["b"][0]["async"]
    assert done and steps > 0 and np.all(np.isfinite(hps))
    for out in worlds["b"][1:]:
        assert out["async"][:2] == (done, steps)
        np.testing.assert_array_equal(out["async"][2], hps)
