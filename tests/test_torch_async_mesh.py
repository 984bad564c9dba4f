"""Asynchronous training under a mesh (the last of ROADMAP item 1.8) on
the CPU: a spawned 2-rank gloo world, float64, a dense GP.

Each rank runs its own actor thread on a mesh of its own
(``mesh.fork_mesh``), the ranks start from differently seeded numpy
states, poll at different times and draw from numpy's global state in
their main threads meanwhile; every poll still returns the same bits on
both ranks (the newest step both published), equal to the snapshot of a
one-rank run at that step, and a stop asked for at different times by the
two ranks ends both actors at the same step.  The one-rank ``"adam"`` run
to completion is held against ``fvgp_tpu.GP.train_async`` at 1e-8.  The
workers are functions of this module; JAX runs in the parent only."""

import datetime
import multiprocessing
import os
import pickle
import tempfile
import threading
import time
import traceback
import types
import warnings

import numpy as np
import pytest
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


WORLD_TIMEOUT = 300.0
COLLECTIVE_TIMEOUT = 240.0
BOUNDS = np.array([[0.1, 5.0], [0.2, 10.0], [0.2, 10.0]])
ITERS = {"adam": 60, "mcmc": 60}       # publishes stay within HISTORY
POLLS = 3


def _data():
    rng = np.random.default_rng(21)
    x = rng.uniform(0, 5, (40, 2))
    y = np.sin(x[:, 0]) + 0.1 * np.cos(3 * x[:, 1]) \
        + 0.05 * rng.standard_normal(40)
    return x, y


def _gp():
    from fvgp_tpu_torch import GP
    x, y = _data()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return GP(x, y, init_hyperparameters=np.array([1.0, 1.5, 1.5]),
                  noise_variances=np.full(len(x), 1e-2),
                  compute_device="cpu")


def _wait(opt, timeout=120.0):
    t0 = time.time()
    while not opt.is_done() and time.time() - t0 < timeout:
        time.sleep(0.01)
    assert opt.is_done()


def _run(gp, method, rank, polls=POLLS):
    """An asynchronous run polled ``polls`` times at this rank's own pace,
    then to its end; the main thread draws from numpy meanwhile."""
    opt = gp.train(hyperparameter_bounds=BOUNDS, method=method,
                   max_iter=ITERS[method], asynchronous=True)
    out = {"polls": [], "steps": []}
    for k in range(polls):
        time.sleep(0.004 * (k + 1) * (1 + 3 * rank))
        np.random.uniform(size=1 + 7 * rank)
        out["polls"].append(gp.update_hyperparameters(opt).copy())
        out["steps"].append(getattr(opt, "agreed_step", None))
    _wait(opt)
    out["final"] = gp.update_hyperparameters(opt).copy()
    out["published"] = opt.actor.published_steps()
    out["history"] = {s: dict(v) for s, v in opt.actor._history}
    return out


# ---------------------------------------------------------------------------
# the spawned world
# ---------------------------------------------------------------------------

def _world_main(rank, world, store, out_dir):
    torch.set_num_threads(1)
    try:
        import torch.distributed as dist
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, world), rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT))
        try:
            payload = {"ok": _async_rank(rank)}
        finally:
            dist.destroy_process_group()
    except BaseException:
        payload = {"error": traceback.format_exc()}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(payload, f)


def _async_rank(rank):
    import sys

    from fvgp_tpu_torch.parallel.mesh import make_mesh, use_mesh
    warnings.simplefilter("ignore")
    out = {"jax_loaded": "jax" in sys.modules}
    with use_mesh(make_mesh(backend="gloo")) as mesh:
        gp = _gp()
        for method in ("adam", "mcmc"):
            np.random.seed(100 + rank)        # rank 0's seed wins
            out[method] = _run(gp, method, rank)
        # a stop asked for by rank 0 first, by rank 1 later
        np.random.seed(7 + rank)
        opt = gp.train(hyperparameter_bounds=BOUNDS, method="mcmc",
                       max_iter=100_000, asynchronous=True)
        time.sleep(0.3 + 0.4 * rank)
        gp.stop_training(opt)
        _wait(opt)
        out["stop"] = {"published": opt.actor.published_steps(),
                       "trace": len(opt.actor._sampler.trace["f(x)"]),
                       "poll": gp.update_hyperparameters(opt).copy()}
        out["ops"] = dict(mesh.ops)
    return out


@pytest.fixture(scope="module")
def world():
    out_dir = tempfile.mkdtemp(prefix="fvgp_async_")
    store = os.path.join(out_dir, "store")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_world_main, args=(r, 2, store, out_dir))
             for r in range(2)]
    start = time.time()
    for p in procs:
        p.start()
    one = _one_rank()                     # while the ranks work
    for p in procs:
        p.join(max(0.0, WORLD_TIMEOUT - (time.time() - start)))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    ranks = []
    for r in range(2):
        path = os.path.join(out_dir, f"rank{r}.pkl")
        if not os.path.exists(path):
            pytest.fail(f"rank {r} wrote no result")
        with open(path, "rb") as f:
            payload = pickle.load(f)
        if "error" in payload:
            pytest.fail(f"rank {r} failed:\n{payload['error']}")
        ranks.append(payload["ok"])
    return ranks, one


def _one_rank():
    """The same runs on one rank (no mesh), from rank 0's seeds, and the
    JAX package's asynchronous Adam to its end."""
    from fvgp_tpu import GP as JaxGP
    out = {}
    gp = _gp()
    for method in ("adam", "mcmc"):
        np.random.seed(100)
        out[method] = _run(gp, method, 0, polls=0)
    x, y = _data()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jgp = JaxGP(x, y, init_hyperparameters=np.array([1.0, 1.5, 1.5]),
                    noise_variances=np.full(len(x), 1e-2))
        opt = jgp.train(hyperparameter_bounds=BOUNDS, method="adam",
                        max_iter=ITERS["adam"], asynchronous=True)
        _wait(opt)
        out["jax_adam"] = np.asarray(jgp.update_hyperparameters(opt))
    return out


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def _hps(snapshot):
    return np.asarray(snapshot.get("median(x)", snapshot.get("x")))


@pytest.mark.parametrize("method", ["adam", "mcmc"])
def test_polls_are_bitwise_equal_across_the_ranks(world, method):
    ranks, _ = world
    a, b = ranks[0][method], ranks[1][method]
    assert a["steps"] == b["steps"] and a["published"] == b["published"]
    for pa, pb in zip(a["polls"] + [a["final"]], b["polls"] + [b["final"]]):
        np.testing.assert_array_equal(pa, pb)
    assert all(np.all(np.isfinite(p)) for p in a["polls"])
    assert not any(r["jax_loaded"] for r in ranks)


@pytest.mark.parametrize("method", ["adam", "mcmc"])
def test_each_poll_is_the_one_rank_run_at_that_step(world, method):
    ranks, one = world
    ref = one[method]
    got = ranks[0][method]
    assert got["published"] == ref["published"]
    for step, poll in zip(got["steps"], got["polls"]):
        if step == 0:
            continue
        np.testing.assert_allclose(poll, _hps(ref["history"][step]),
                                   rtol=1e-10, atol=0)
    np.testing.assert_allclose(got["final"], ref["final"], rtol=1e-10,
                               atol=0)


def test_one_rank_adam_matches_the_jax_package(world):
    _, one = world
    np.testing.assert_allclose(one["adam"]["final"], one["jax_adam"],
                               rtol=1e-8, atol=0)
    assert one["adam"]["published"] == ITERS["adam"] + 1


def test_a_stop_ends_every_rank_at_the_same_step(world):
    ranks, _ = world
    a, b = ranks[0]["stop"], ranks[1]["stop"]
    assert a["published"] == b["published"] and a["trace"] == b["trace"]
    assert 0 < a["trace"] < 100_000
    np.testing.assert_array_equal(a["poll"], b["poll"])
    # each rank's actor ran on its own groups: the main mesh carried only
    # the syncs and the polls
    assert ranks[0]["ops"]["all_gather"] == 2 * (2 * (POLLS + 1) + 1)


def test_a_thread_mesh_is_the_threads_alone():
    """``thread_mesh`` overrides ``current_mesh`` in its thread only; the
    main thread's ``use_mesh`` neither sees nor changes it."""
    from fvgp_tpu_torch.parallel.mesh import (current_mesh, thread_mesh,
                                              use_mesh)
    actor_mesh = types.SimpleNamespace(size=2, name="actor")
    main_mesh = types.SimpleNamespace(size=2, name="main")
    seen, go, done = {}, threading.Event(), threading.Event()

    def actor():
        with thread_mesh(actor_mesh):
            seen["before"] = current_mesh()
            go.set()
            done.wait(10)
            seen["after"] = current_mesh()
        seen["left"] = current_mesh()

    t = threading.Thread(target=actor)
    with use_mesh(main_mesh):
        t.start()
        go.wait(10)
        assert current_mesh() is main_mesh
        with use_mesh(None):
            done.set()
            t.join(10)
        assert current_mesh() is main_mesh
    assert not t.is_alive()
    assert seen["before"] is seen["after"] is actor_mesh
    assert seen["left"] is None and current_mesh() is None
