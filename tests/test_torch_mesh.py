"""The port's mesh (``parallel/mesh.py``, the mesh SpMMs and the mesh
branches of the sparse LML, the committed solver and the facade) on the
CPU: spawned ``gloo`` worlds, float64, the plain K1 twin.

Three worlds, each with its own deadline (a collective that one rank skips
would block the others; ``WORLD_TIMEOUT`` kills the world instead):

* (a) 4 ranks: the all-gather, flat-halo and 2 × 2 hierarchical-halo SpMMs
  against the one-rank product; the facade at the JAX dryrun's data
  (N = 2,100, B = 16) with each exchange forced, against ``fvgp_tpu.GP`` on
  a 4-device mesh of the JAX suite's virtual devices at the same probes,
  and against the port's own one-rank run;
* (b) 8 ranks: the dryrun's facade stage (``__graft_entry__._facade_stage``)
  against the meshless run, at the dryrun's bounds;
* (c) 4 ranks: an append against a fresh model, ``fvGP`` multi-task, two
  steps of the Adam chain against one rank, the stored-K path's three
  calls against one rank, the agreed out-of-memory retreat, and the
  auto 2-D layout under ``FVGP_TPU_ASSUME_SLICES``.

The workers are functions of this module, looked up by name in each
spawned rank, which imports torch and the port only (JAX runs in the
parent).  ``make_mesh``'s layout rules and the one-rank collectives run
without a spawn."""

import datetime
import multiprocessing
import os
import pickle
import tempfile
import time
import traceback
import types
import warnings

import numpy as np
import pytest
import torch

# a world takes ~10-20 s alone and up to ~65 s beside the suite's other
# workers on a loaded machine: the deadlines leave room for that, and a
# hung world still costs at most WORLD_TIMEOUT
WORLD_TIMEOUT = 300.0          # seconds for one spawned world, start to end
COLLECTIVE_TIMEOUT = 240.0     # seconds a rank waits in one collective

# the JAX dryrun's facade data (__graft_entry__._facade_stage)
DRY_N, DRY_B = 2100, 16
DRY_HPS = np.array([1.0, 2.0, 2.0])
# injected probes for the parity checks: rows for the largest padding
PROBES = 16
ZF = np.random.default_rng(3).choice([-1.0, 1.0], size=(150 * DRY_B, PROBES))
# the dryrun's own bounds (__graft_entry__.py:201-204) and MULTICHIP_r05's
# measured rel-errs of the JAX package's 8-device run
DRY_BOUNDS = {"loss": 1e-5, "grad": 1e-4, "mean": 1e-6, "var": 1e-5}
MULTICHIP_R05 = {"loss": 1.55e-8, "grad": 6.50e-8, "mean": 1.88e-12,
                 "var": 1.42e-10}
# against the JAX package, the same probes and a converged solve (128 CG
# trips: every column reaches the exit floor, ~106 trips, where the
# default 64 stop before it and leave the probes' solves at the 1e-7 that
# two summation orders give them)
PARITY = 1e-8
CONVERGED = {"sparse_cg_maxiter": 128}
# the 4-rank gradient against the 1-rank one (relative 2-norm): two
# reduction orders of one converged mBCG, each column frozen at the 1e-7
# relative residual of the CG's float64 freeze floor (measured 4.0e-10); a
# gradient summed twice over the ranks would be off by 3
RANKS_GRAD = 2e-9


# ---------------------------------------------------------------------------
# spawned worlds
# ---------------------------------------------------------------------------

def _world_main(rank, world, store, out_dir, fn_name, env):
    os.environ.update(env)
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

    def __init__(self, fn_name, world, env=None):
        self.dir = tempfile.mkdtemp(prefix="fvgp_mesh_")
        store = os.path.join(self.dir, "store")
        ctx = multiprocessing.get_context("spawn")
        self.procs = [ctx.Process(target=_world_main,
                                  args=(r, world, store, self.dir, fn_name,
                                        env or {}))
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


def _dry_data():
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 40, (DRY_N, 2))
    y = np.sin(0.2 * x[:, 0]) + 0.05 * rng.standard_normal(DRY_N)
    xp = rng.uniform(0, 40, (32, 2))
    return x, y, xp


def _inject_probes():
    """Every sparse LML of this process draws ``ZF``'s first rows."""
    import fvgp_tpu_torch.models.gp_marginal_likelihood as TML
    TML._rademacher_probes = (
        lambda n, p, dtype, device, generator:
        torch.as_tensor(ZF[:n, :p], dtype=dtype).to(device))


def _dry_gp(extra=None, **kw):
    from fvgp_tpu_torch import GP
    x, y, _ = _dry_data()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return GP(x, y, init_hyperparameters=DRY_HPS,
                  noise_variances=np.full(DRY_N, 1e-2), gp2Scale=True,
                  linalg_mode="sparseCGpre", compute_device="cpu",
                  args={"gp2Scale_block_size": DRY_B, **(extra or {})}, **kw)


def _journey(gp):
    """LML + gradient, posterior mean and variance, the committed CG's
    iterations, and the exchange the LML ran on."""
    _, _, xp = _dry_data()
    v, g = gp.marginal_likelihood.log_likelihood_value_and_gradient(DRY_HPS)
    pm = gp.posterior_mean(xp)["m(x)"]
    pv = gp.posterior_covariance(xp, variance_only=True)["v(x)"]
    entry, = gp.marginal_likelihood._sparse_cache.values()
    return {"v": float(v), "g": np.asarray(g), "pm": np.asarray(pm),
            "pv": np.asarray(pv),
            "iters": int(gp.kv.last_solve_info["iterations"]),
            "exchange": entry["schedule"][2].get("exchange")}


def _banded_schedule(nb, half=2):
    rows = np.repeat(np.arange(nb), 2 * half + 1)
    cols = np.clip(rows + np.tile(np.arange(-half, half + 1), nb), 0, nb - 1)
    return rows.astype(np.int32), cols.astype(np.int32)


def _spmm_errors(rank, world, mesh1, mesh2):
    """Each exchange's rows of A @ X against the one-rank product."""
    from fvgp_tpu_torch.ops import sparse_lml as SL
    from fvgp_tpu_torch.ops.hopper_kernels import chunked_spmm_reference
    from fvgp_tpu_torch.parallel import partition as pt
    rng = np.random.default_rng(0)
    nb, B, k = 32, 8, 3
    rows, cols = _banded_schedule(nb)
    keep = rng.random(len(rows)) < 0.8
    rows, cols = rows[keep], cols[keep]
    tiles = torch.as_tensor(rng.standard_normal((len(rows), B, B)))
    X = torch.as_tensor(rng.standard_normal((nb * B, k)))
    Y = chunked_spmm_reference(torch.as_tensor(rows), torch.as_tensor(cols),
                               tiles, X, nb, B)
    rows_p, cols_p, perm, per = pt.partition_schedule(rows, cols, nb, world)
    W = nb // world
    seg = slice(rank * per, (rank + 1) * per)
    rsl = slice(rank * W * B, (rank + 1) * W * B)
    live = perm[seg] >= 0
    t_loc = torch.zeros((per, B, B), dtype=tiles.dtype)
    t_loc[torch.as_tensor(live)] = tiles[torch.as_tensor(perm[seg][live])]
    r_loc = torch.as_tensor(rows_p[seg])
    errs = {"allgather": SL._spmv_for(nb, B, mesh1)(
        r_loc, torch.as_tensor(cols_p[seg]).clamp(max=nb - 1), t_loc,
        X[rsl])}
    for mode, mesh in (("on", mesh1), ("hier", mesh2)):
        ch = pt.choose_halo(rows_p, cols_p, nb, mesh, halo_mode=mode,
                            bucket=1)
        spmv = SL._spmv_for(nb, B, mesh, halo_S=ch["halo_S"])
        errs[ch["engaged"]] = spmv(
            r_loc, torch.as_tensor(ch["cols_remap"][seg]), t_loc, X[rsl],
            *(torch.as_tensor(p[rank]) for p in ch["plan"]))
    return {name: float((out - Y[rsl]).abs().max())
            for name, out in errs.items()}


def _exchanges_world(rank, world):
    """World (a)."""
    from fvgp_tpu_torch.parallel import mesh as pm
    _inject_probes()
    mesh1 = pm.make_mesh(layout="1d")
    mesh2 = pm.make_mesh_2d(2, 2)
    out = {"spmm": _spmm_errors(rank, world, mesh1, mesh2)}
    if rank == 0:       # the one-rank run: no collective
        out["single"] = _journey(_dry_gp(CONVERGED))
    for halo, mesh in (("off", mesh1), ("on", mesh1), ("hier", mesh2)):
        with pm.use_mesh(mesh):
            out[halo] = _journey(_dry_gp(
                {**CONVERGED, "gp2Scale_halo_exchange": halo}))
    out["ops"] = dict(mesh1.ops)
    return out


def _dryrun_world(rank, world):
    """World (b): ``__graft_entry__._facade_stage`` on the port."""
    from fvgp_tpu_torch.parallel import mesh as pm
    out = {}
    if rank == 0:
        out["single"] = _journey(_dry_gp())
    mesh = pm.make_mesh(world)
    with pm.use_mesh(mesh):
        gp = _dry_gp()
        out["mesh"] = _journey(gp)
        ctx = gp.kv._fast_sparse_solver()
        out["committed"] = (ctx is not None and ctx["tiles"] is not None
                            and ctx["mesh"] is mesh)
    return out


def _sparse_dataset(n, seed=3):
    from fvgp_tpu_torch.parallel.ordering import morton_order
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 40.0, (n, 2))
    y = np.sin(x[:, 0]) + 0.05 * rng.standard_normal(n)
    perm = morton_order(x)
    return x[perm], y[perm]


def _models_world(rank, world):
    """World (c)."""
    from fvgp_tpu_torch import GP, fvGP
    from fvgp_tpu_torch.models.gp_kv import GPkv
    from fvgp_tpu_torch.parallel import mesh as pm
    from fvgp_tpu_torch.parallel.sharded_cov import distributed_covariance
    warnings.simplefilter("ignore")
    hps = np.array([1.0, 1.5, 1.5])
    a = {"gp2Scale_block_size": 64}
    out = {}
    mesh = pm.make_mesh(layout="1d")
    # the auto layout reads FVGP_TPU_ASSUME_SLICES (set for this world)
    auto = pm.make_mesh()
    out["auto_shape"] = dict(auto.shape)
    x, y = _sparse_dataset(900)
    gp1 = GP(x, y, init_hyperparameters=hps, gp2Scale=True,
             compute_device="cpu", args=dict(a))
    v1, g1 = gp1.marginal_likelihood.log_likelihood_value_and_gradient(hps)
    with pm.use_mesh(auto):
        gp2 = GP(x, y, init_hyperparameters=hps, gp2Scale=True,
                 compute_device="cpu", args=dict(a))
        v2, g2 = gp2.marginal_likelihood.log_likelihood_value_and_gradient(
            hps)
    out["auto_2d"] = (v1, np.asarray(g1), v2, np.asarray(g2))
    # append under the mesh against a fresh model of the same points in the
    # same order (tests/test_scale.py:921; the appended chunk is Morton
    # ordered on its own, and the traced estimator's probes follow the
    # points' order).  Below N = 2,001 the auto mode is a direct one, whose
    # stored K is not on the mesh yet: the iterative mode keeps the traced
    # path
    x, y = _sparse_dataset(600)
    with pm.use_mesh(mesh):
        gp = GP(x[:500], y[:500], init_hyperparameters=hps, gp2Scale=True,
                compute_device="cpu", linalg_mode="sparseCGpre",
                args=dict(a))
        gp.log_likelihood()
        gp.update_gp_data(x[500:], y[500:], append=True)
        fresh = GP(gp.x_data.copy(), gp.y_data[:, 0].copy(),
                   init_hyperparameters=hps, gp2Scale=True,
                   compute_device="cpu", linalg_mode="sparseCGpre",
                   args={**a, "gp2Scale_reorder": False})
        out["append"] = (gp.log_likelihood(), fresh.log_likelihood())
    # fvGP multi-task gp2Scale (tests/test_fvgp_multitask.py:201)
    rng = np.random.default_rng(0)
    xm = rng.uniform(0, 25, (400, 2))
    ym = np.stack([np.sin(xm[:, 0]), np.cos(xm[:, 1])], axis=1)
    hm = np.array([1.0, 1.5, 1.5, 1.0])
    f1 = fvGP(xm, ym, init_hyperparameters=hm, gp2Scale=True,
              compute_device="cpu", linalg_mode="sparseCGpre", args=dict(a))
    with pm.use_mesh(mesh):
        f4 = fvGP(xm, ym, init_hyperparameters=hm, gp2Scale=True,
                  compute_device="cpu", linalg_mode="sparseCGpre",
                  args=dict(a))
        out["fvgp"] = (f1.log_likelihood(), f4.log_likelihood(),
                       f4.posterior_mean(xm[:4] + 0.02,
                                         x_out=np.array([0, 1]))["m(x)"])
    # two steps of the Adam chain at injected probes, mesh vs one rank
    bounds = np.array([[0.1, 10.0], [1.5, 2.5], [1.5, 2.5]])

    def probes_of(gpc):
        entry, = gpc.marginal_likelihood._sparse_cache.values()
        n_pad = entry["xb"].shape[0] * entry["xb"].shape[1]
        return lambda step: np.roll(ZF, step, axis=0)[:n_pad]

    chains = {}
    for name, m in (("single", None), ("mesh", mesh)):
        with pm.use_mesh(m):
            gpc = _dry_gp()
            ml = gpc.marginal_likelihood
            ml.log_likelihood_value_and_gradient(DRY_HPS)
            chains[name] = ml.sparse_adam_steps(
                DRY_HPS, np.zeros(3), np.zeros(3), 0, 2, bounds=bounds,
                probe_source=probes_of(gpc))
    out["adam"] = chains
    # the stored K on the mesh (ROADMAP item 1.8, second part): the three
    # calls, each rank holding the tiles of its own row blocks, against the
    # same calls on one rank
    stored = {}
    sa = {**a, "gp2Scale_traced_lml": False}
    for name, m in (("one", None), ("mesh", mesh)):
        with pm.use_mesh(m):
            gps = GP(x, y, init_hyperparameters=hps, gp2Scale=True,
                     compute_device="cpu", args=dict(sa))
            xs = np.asarray(gps.x_data)
            K = gps.K
            Kd = distributed_covariance(gps.prior, xs, xs, hps,
                                        symmetric=True, args=a, mesh=m)
            stored[name] = (gps.log_likelihood(), K.toarray(), Kd.toarray(),
                            K.mesh is m, K._store.rows_h.tolist(),
                            pm.owned_rows(K.nb, m))
    out["stored_k"] = stored
    # a tile list split over the ranks: each keeps its own segment
    from fvgp_tpu_torch.parallel.block_sparse import BlockSparseMatrix
    rows_s, cols_s = _banded_schedule(6, half=1)
    tiles_s = torch.arange(len(rows_s), dtype=torch.float64)[:, None, None] \
        * torch.ones((1, 8, 8), dtype=torch.float64)
    bsm = BlockSparseMatrix(48, 48, 8, rows_s[:16], cols_s[:16],
                            tiles_s[:16], device="cpu")
    part = pm.shard_tiles(bsm, mesh)
    out["shard"] = (part.rows.tolist(), part.cols.tolist(),
                    part.tiles[:, 0, 0].tolist())
    # one rank cannot hold the chunk: every rank retreats to half its width
    fits = GPkv._mesh_chunk_fits
    calls = []

    def refuse_once(ctx, c_eff):
        calls.append(c_eff)
        return len(calls) > 1 or rank != 1

    _, _, xp = _dry_data()
    with pm.use_mesh(mesh):
        gpo = _dry_gp()
        whole = gpo.posterior_covariance(xp, variance_only=True)["v(x)"]
        gpo = _dry_gp()
        GPkv._mesh_chunk_fits = staticmethod(refuse_once)
        try:
            halved = gpo.posterior_covariance(xp, variance_only=True)["v(x)"]
        finally:
            GPkv._mesh_chunk_fits = fits
        out["oom"] = (np.asarray(whole), np.asarray(halved),
                      gpo.kv.last_solve_info["chunks"])
    return out


# ---------------------------------------------------------------------------
# world (a): exchanges and parity with the JAX package
# ---------------------------------------------------------------------------

def _jax_mesh_runs():
    """``fvgp_tpu.GP`` on a 4-device mesh (1-D for the all-gather and the
    flat halo, 2 × 2 for the hierarchical one) at the injected probes."""
    import jax
    import jax.numpy as jnp

    from fvgp_tpu import GP as JaxGP
    from fvgp_tpu.parallel import mesh as pmesh
    x, y, xp = _dry_data()
    out = {}
    with pytest.MonkeyPatch.context() as mp, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mp.setattr(jax.random, "rademacher",
                   lambda key, shape, dtype=jnp.float64:
                   jnp.asarray(ZF[:shape[0], :shape[1]], dtype))
        for halo, make in (("off", lambda: pmesh.make_mesh(4)),
                           ("on", lambda: pmesh.make_mesh(4)),
                           ("hier", lambda: pmesh.make_mesh_2d(2, 2))):
            with pmesh.use_mesh(make()):
                gp = JaxGP(x, y, init_hyperparameters=DRY_HPS,
                           noise_variances=np.full(DRY_N, 1e-2),
                           gp2Scale=True, linalg_mode="sparseCGpre",
                           args={"gp2Scale_block_size": DRY_B, **CONVERGED,
                                 "gp2Scale_halo_exchange": halo})
                v, g = gp.marginal_likelihood \
                    .log_likelihood_value_and_gradient(DRY_HPS)
                out[halo] = {
                    "v": float(v), "g": np.asarray(g),
                    "pm": np.asarray(gp.posterior_mean(xp)["m(x)"]),
                    "pv": np.asarray(gp.posterior_covariance(
                        xp, variance_only=True)["v(x)"]),
                    "iters": int(gp.kv.last_solve_info["iterations"])}
    return out


@pytest.fixture(scope="module")
def exchanges():
    world = _World("_exchanges_world", 4)
    jax_runs = _jax_mesh_runs()          # while the ranks work
    return world.results(), jax_runs


def test_mesh_spmms_match_the_one_rank_product(exchanges):
    ranks, _ = exchanges
    for r, out in enumerate(ranks):
        assert set(out["spmm"]) == {"allgather", "flat", "hier"}
        for name, err in out["spmm"].items():
            assert err <= 1e-12, (r, name, err)
    assert ranks[0]["ops"]["all_gather"] >= 1
    assert ranks[0]["ops"]["all_to_all"] >= 1


@pytest.mark.parametrize("halo,engaged", [("off", "allgather"),
                                          ("on", "flat"), ("hier", "hier")])
def test_facade_on_four_ranks_matches_jax(exchanges, halo, engaged):
    """LML, gradient (relative 2-norm), posterior mean and variance of the
    port's 4-rank mesh within 1e-8 of ``fvgp_tpu.GP`` on a 4-device mesh,
    the committed CG's iterations equal, every rank the same result."""
    ranks, jax_runs = exchanges
    t, j = ranks[0][halo], jax_runs[halo]
    assert t["exchange"] == engaged
    assert abs(t["v"] - j["v"]) <= PARITY * abs(j["v"])
    assert np.linalg.norm(t["g"] - j["g"]) <= PARITY * np.linalg.norm(j["g"])
    np.testing.assert_allclose(t["pm"], j["pm"], rtol=0, atol=PARITY)
    np.testing.assert_allclose(t["pv"], j["pv"], rtol=0, atol=PARITY)
    assert t["iters"] == j["iters"]
    for other in ranks[1:]:
        o = other[halo]
        assert o["v"] == t["v"] and o["iters"] == t["iters"]
        np.testing.assert_array_equal(o["g"], t["g"])
        np.testing.assert_array_equal(o["pv"], t["pv"])


def test_four_rank_gradient_equals_the_one_rank_gradient(exchanges):
    """A gradient summed twice over the ranks (an all-reduce in a rule that
    every rank seeds) would be 4 times the one-rank gradient."""
    ranks, _ = exchanges
    single = ranks[0]["single"]
    for halo in ("off", "on", "hier"):
        g = ranks[0][halo]["g"]
        rel = np.linalg.norm(g - single["g"]) / np.linalg.norm(single["g"])
        assert rel <= RANKS_GRAD, (halo, rel)
        assert abs(ranks[0][halo]["v"] - single["v"]) \
            <= PARITY * abs(single["v"])


# ---------------------------------------------------------------------------
# world (b): the dryrun's facade stage on 8 ranks
# ---------------------------------------------------------------------------

def test_eight_rank_facade_meets_the_dryrun_bounds():
    ranks = _World("_dryrun_world", 8).results()
    one, mesh = ranks[0]["single"], ranks[0]["mesh"]
    errs = {
        "loss": abs(mesh["v"] - one["v"]) / max(abs(one["v"]), 1.0),
        "grad": float(np.max(np.abs(mesh["g"] - one["g"]))
                      / max(float(np.max(np.abs(one["g"]))), 1e-12)),
        "mean": float(np.max(np.abs(mesh["pm"] - one["pm"]))
                      / max(np.max(np.abs(one["pm"])), 1e-12)),
        "var": float(np.max(np.abs(mesh["pv"] - one["pv"]))
                     / max(np.max(np.abs(one["pv"])), 1e-12))}
    print("8-rank facade vs meshless (port, gloo, float64): " + ", ".join(
        f"{k} {errs[k]:.2e} (MULTICHIP_r05 {MULTICHIP_R05[k]:.2e}, bound "
        f"{DRY_BOUNDS[k]:g})" for k in errs))
    for k, bound in DRY_BOUNDS.items():
        assert errs[k] < bound, (k, errs[k])
    assert all(r["committed"] for r in ranks)
    for other in ranks[1:]:
        assert other["mesh"]["v"] == mesh["v"]
        np.testing.assert_array_equal(other["mesh"]["pm"], mesh["pm"])


# ---------------------------------------------------------------------------
# world (c): models, the Adam chain, the stored K, the retreat, the layout
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    return _World("_models_world", 4,
                  env={"FVGP_TPU_ASSUME_SLICES": "2"}).results()


def test_auto_layout_builds_a_2d_mesh_and_matches_meshless(models):
    """``tests/test_scale.py:1137``'s bounds on the auto-selected 2 × 2
    mesh."""
    assert models[0]["auto_shape"] == {"slice": 2, "tiles": 2}
    v1, g1, v2, g2 = models[0]["auto_2d"]
    np.testing.assert_allclose(v2, v1, rtol=1e-5)
    np.testing.assert_allclose(g2, g1, rtol=1e-4, atol=1e-6)


def test_append_under_the_mesh_matches_a_fresh_model(models):
    for out in models:
        v_app, v_fresh = out["append"]
        np.testing.assert_allclose(v_app, v_fresh, rtol=1e-6)


def test_fvgp_multitask_under_the_mesh(models):
    v1, v4, pm = models[0]["fvgp"]
    np.testing.assert_allclose(v4, v1, rtol=1e-6)
    assert pm.shape == (4, 2) and np.all(np.isfinite(pm))


def test_adam_chain_on_the_mesh_matches_one_rank(models):
    """Two chain steps at the same injected probes: values within the
    one-rank-vs-mesh agreement of the unconverged default solve (1e-7 of
    the gradient, which Adam's normalized step shrinks further)."""
    single, mesh = models[0]["adam"]["single"], models[0]["adam"]["mesh"]
    for a, b in zip(mesh, single):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)
    for out in models[1:]:
        for a, b in zip(out["adam"]["mesh"], mesh):
            np.testing.assert_array_equal(a, b)


def test_stored_k_path_raises_under_the_mesh(models):
    """The three stored-K calls that raised before ROADMAP item 1.8's
    second part are served on the 4-rank mesh: the LML off the traced path,
    ``gp.K`` and ``distributed_covariance(mesh=...)``, each rank holding
    only its own row blocks' tiles, the whole matrix and the LML equal to
    one rank's."""
    lml0 = models[0]["stored_k"]["mesh"][0]
    for out in models:
        one, got = out["stored_k"]["one"], out["stored_k"]["mesh"]
        lml, K, Kd, owned, rows, (r0, W) = got
        assert owned and one[3]
        nb = -(-len(K) // 64)
        assert all(r0 <= r < min(r0 + W, nb) or r == nb
                   for r in rows), (r0, W, sorted(set(rows)))
        np.testing.assert_allclose(lml, one[0], rtol=1e-10)
        assert lml == lml0
        np.testing.assert_array_equal(K, one[1])
        np.testing.assert_array_equal(Kd, one[1])


def test_shard_tiles_keeps_each_rank_its_segment(models):
    rows, cols = _banded_schedule(6, half=1)
    for r, out in enumerate(models):
        got_rows, got_cols, got_ids = out["shard"]
        seg = slice(4 * r, 4 * r + 4)
        assert got_rows == rows[:16][seg].tolist()
        assert got_cols == cols[:16][seg].tolist()
        assert got_ids == list(range(16))[seg]


def test_out_of_memory_retreat_is_agreed_by_every_rank(models):
    """Rank 1 alone refuses the first chunk: every rank halves its width
    (two chunks instead of one) and the variance is unchanged."""
    for out in models:
        whole, halved, chunks = out["oom"]
        assert chunks == 2
        np.testing.assert_allclose(halved, whole, rtol=0, atol=1e-10)


# ---------------------------------------------------------------------------
# no spawn
# ---------------------------------------------------------------------------

def test_make_mesh_layouts_on_one_rank(monkeypatch):
    """A one-rank gloo world (an in-process store: no torchrun
    environment), ``make_mesh``'s layout rules (``tests/test_scale.py:1137``:
    no node structure -> 1-D, ``layout='2d'`` raises, an override that does
    not divide the ranks raises), and the collectives' one-rank forms."""
    import torch.distributed as dist

    from fvgp_tpu_torch.parallel import mesh as pm
    for name in ("WORLD_SIZE", "RANK", "LOCAL_WORLD_SIZE",
                 "FVGP_TPU_ASSUME_SLICES"):
        monkeypatch.delenv(name, raising=False)
    assert not dist.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="gloo"):
            pm.make_mesh()
    try:
        mesh = pm.make_mesh(backend="gloo")
        assert mesh.shape == {pm.TILE_AXIS: 1} and mesh.size == 1
        assert pm.tile_device_count(mesh) == 1 and pm.tile_axes(mesh) == (
            pm.TILE_AXIS,)
        with pytest.raises(ValueError):
            pm.make_mesh(layout="2d")
        with pytest.raises(ValueError):
            pm.make_mesh(layout="3d")
        with pytest.raises(ValueError):
            pm.make_mesh(2)
        with pytest.raises(ValueError):
            pm.make_mesh(backend="nccl")
        monkeypatch.setenv("FVGP_TPU_ASSUME_SLICES", "2")
        with pytest.raises(ValueError):
            pm.make_mesh()
        monkeypatch.setenv("FVGP_TPU_ASSUME_SLICES", "1")
        assert pm.make_mesh().shape == {pm.TILE_AXIS: 1}
        t = torch.arange(6.0).reshape(3, 2)
        for fn in (pm.replicate, pm.global_sum, pm.gather_rows):
            assert fn(t, mesh) is t
        np.testing.assert_array_equal(pm.exchange_blocks(t, mesh=mesh), t)
        assert pm.all_agree(True, mesh) and not pm.all_agree(False, mesh)
        # a one-rank mesh runs the meshless program
        from fvgp_tpu_torch import GP
        x, y = _sparse_dataset(400)

        def lml():
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                gp = GP(x, y, init_hyperparameters=np.array([1.0, 1.5, 1.5]),
                        noise_variances=np.full(len(x), 1e-2), gp2Scale=True,
                        linalg_mode="sparseCGpre", compute_device="cpu",
                        args={"gp2Scale_block_size": 32})
            return gp.marginal_likelihood.log_likelihood(gp.hyperparameters)

        ref = lml()
        with pm.use_mesh(mesh):
            assert pm.current_mesh() is mesh
            assert lml() == ref
        assert pm.current_mesh() is None
    finally:
        dist.destroy_process_group()


def test_k1_twin_takes_its_own_output_block_count():
    """``chunked_spmm`` with ``nb_out`` (a rank's rows against a gathered
    X) is those rows of the square product, and its VJP those rows' tile
    cotangents and X cotangent."""
    from fvgp_tpu_torch.ops import hopper_kernels as hk
    rng = np.random.default_rng(1)
    nb, B, k, W, row0 = 12, 8, 3, 4, 4
    rows, cols = _banded_schedule(nb)
    mine = (rows >= row0) & (rows < row0 + W)
    r_all, c_all = torch.as_tensor(rows), torch.as_tensor(cols)
    tiles = torch.as_tensor(rng.standard_normal((len(rows), B, B)))
    X = torch.as_tensor(rng.standard_normal((nb * B, k)))
    Ybar = torch.as_tensor(rng.standard_normal((W * B, k)))
    r_loc = torch.as_tensor(np.append(rows[mine] - row0, W))  # a sentinel
    c_loc = torch.as_tensor(np.append(cols[mine], 0))
    t_loc = torch.cat([tiles[torch.as_tensor(mine)],
                       torch.zeros((1, B, B), dtype=tiles.dtype)])
    Y = hk.chunked_spmm(r_loc, c_loc, t_loc, X, nb, B, nb_out=W)
    Y_sq = hk.chunked_spmm(r_all, c_all, tiles, X, nb, B)
    rs = slice(row0 * B, (row0 + W) * B)
    torch.testing.assert_close(Y, Y_sq[rs], rtol=0, atol=1e-12)
    full_bar = torch.zeros((nb * B, k), dtype=Ybar.dtype)
    full_bar[rs] = Ybar
    tb, xb = hk.chunked_spmm_vjp(r_loc, c_loc, t_loc, X, Ybar, nb, B,
                                 nb_out=W)
    tb_sq, xb_sq = hk.chunked_spmm_vjp(r_all, c_all, tiles, X, full_bar, nb,
                                       B)
    torch.testing.assert_close(tb[:-1], tb_sq[torch.as_tensor(mine)],
                               rtol=0, atol=1e-12)
    assert float(tb[-1].abs().max()) == 0.0
    torch.testing.assert_close(xb, xb_sq, rtol=0, atol=1e-12)


def test_resolve_device_under_a_mesh_keeps_an_explicit_cpu():
    from fvgp_tpu_torch.config import resolve_device
    from fvgp_tpu_torch.parallel import mesh as pm
    fake = types.SimpleNamespace(device=torch.device("cuda", 1))
    with pm.use_mesh(fake):
        assert resolve_device("cpu").type == "cpu"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_resolve_device_under_a_mesh_takes_the_rank_card(cuda_device):
    from fvgp_tpu_torch.config import resolve_device
    from fvgp_tpu_torch.parallel import mesh as pm
    card = torch.device("cuda", torch.cuda.device_count() - 1)
    with pm.use_mesh(types.SimpleNamespace(device=card)):
        assert resolve_device("cuda") == card
        assert resolve_device("gpu") == card
        assert resolve_device("cuda:0") == torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_with_nb_out_on_card_matches_plain(cuda_device, dtype):
    """K1 launched with its own output block count: a rank's rows against
    a gathered X, equal to those rows of the square launch bit for bit and
    to the plain twin within the kernels' 1e-4 of the output scale."""
    from fvgp_tpu_torch.ops import hopper_kernels as hk
    rng = np.random.default_rng(2)
    nb, B, k, W = 12, 64, 17, 5
    rows, cols = _banded_schedule(nb)
    mine = rows < W
    r = torch.as_tensor(np.append(rows[mine], W)).to(cuda_device)
    c = torch.as_tensor(np.append(cols[mine], 0)).to(cuda_device)
    tiles = torch.as_tensor(rng.standard_normal((len(r), B, B))).to(
        cuda_device, torch.float32)
    tiles[-1] = 0.0
    X = torch.as_tensor(rng.standard_normal((nb * B, k))).to(
        cuda_device, torch.float32)
    mvd = None if dtype == torch.float32 else dtype
    got = hk.chunked_spmm(r, c, tiles, X, nb, B, mv_dtype=mvd, nb_out=W)
    square = hk.chunked_spmm(r, c, tiles, X, nb, B, mv_dtype=mvd)
    ref = hk.chunked_spmm_reference(r, c, tiles, X, nb, B, mv_dtype=mvd,
                                    nb_out=W)
    assert got.shape == (W * B, k)
    assert torch.equal(got, square[:W * B])
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=1e-4 * float(ref.abs().max()))
