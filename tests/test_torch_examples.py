"""The nine worked examples on the port (``fvgp_tpu_torch/examples/``,
ROADMAP item 1.9) against the JAX package, on the CPU in float64.

Each example runs in-process at a small size (fewer training iterations;
``gp2scale_sparse`` at 600 points), and its numbers at the first
hyperparameters — the LML, the posterior mean and variance it reports —
are held at 1e-8 against ``fvgp_tpu`` objects built on the same inputs
(the JAX examples' own kernels and constants, loaded from ``examples/``;
their ``main()``s are not run: ``tests/test_examples.py`` marks them slow).
After training, the LML is no worse than at the start.  ``multichip_mesh``
runs in a spawned 4-rank gloo world, so that its 2-D branch runs too;
``single_task`` once as ``python -m ... --device cpu`` in a subprocess,
which must not load JAX (nor must the ranks of the world: JAX is imported
only inside the parent's functions).  The sparse LMLs take injected probes
in both packages, and a converged CG (see ``tests/test_torch_mesh.py``)."""

import datetime
import importlib
import importlib.util
import multiprocessing
import os
import pickle
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
from pathlib import Path

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


ROOT = Path(__file__).resolve().parent.parent
NAMES = sorted(p.stem for p in (ROOT / "examples").glob("*.py"))
PARITY = 1e-8
WORLD_TIMEOUT = 300.0
COLLECTIVE_TIMEOUT = 240.0
PROBES = 16
ZF = np.random.default_rng(3).choice([-1.0, 1.0], size=(8192, PROBES))
CONVERGED = {"sparse_cg_maxiter": 128}
# the in-process examples' training budgets, cut to keep the file short
SMALL = {"single_task": {"max_iter": 20},
         "deep_kernel": {"pop_size": 4, "max_iter": 5},
         "multi_task": {"max_iter": 10},
         "non_euclidean": {"max_iter": 40},
         "gp2scale_sparse": {"n": 600, "max_iter": 2},
         "gplvm_latent": {"adam_iter": 20, "local_iter": 5, "mcmc_iter": 20},
         "manifold_gpm": {"max_iter": 20},
         "ggmp_multitask": {"max_iter": 5}}


def _port(name):
    return importlib.import_module(f"fvgp_tpu_torch.examples.{name}")


def _reference(name):
    """The JAX package's example module (its constants and kernels)."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inject_probes(mp):
    """Both packages' sparse LMLs draw ``ZF``'s first rows."""
    import jax
    import jax.numpy as jnp

    import fvgp_tpu_torch.models.gp_marginal_likelihood as TML
    mp.setattr(jax.random, "rademacher",
               lambda key, shape, dtype=jnp.float64:
               jnp.asarray(ZF[:shape[0], :shape[1]], dtype))
    mp.setattr(TML, "_rademacher_probes",
               lambda n, p, dtype, device, generator:
               torch.as_tensor(ZF[:n, :p], dtype=dtype).to(device))


# ---------------------------------------------------------------------------
# the JAX package's model of each example at its first hyperparameters
# ---------------------------------------------------------------------------

def _jax_single_task():
    from fvgp_tpu import GP
    x, y = _port("single_task").data()
    gp = GP(x, y, init_hyperparameters=_port("single_task").INIT)
    xp = gp.make_1d_x_pred([0, 10], res=200)
    return {"lml": gp.log_likelihood(), "mean": gp.posterior_mean(xp)["m(x)"],
            "var": gp.posterior_covariance(xp)["v(x)"]}


def _jax_deep_kernel():
    from fvgp_tpu import GP
    from fvgp_tpu.models.deep_kernel_network import WarpNet, make_deep_kernel
    x, y, init, xp = _port("deep_kernel").data()
    gp = GP(x, y, init_hyperparameters=init,
            kernel_function=make_deep_kernel(WarpNet(2, 4, 4, 2)))
    return {"lml": gp.log_likelihood(), "mean": gp.posterior_mean(xp)["m(x)"],
            "var": gp.posterior_covariance(xp, variance_only=True)["v(x)"]}


def _jax_multi_task():
    from fvgp_tpu import fvGP
    ex = _port("multi_task")
    x, y = ex.data()
    f = fvGP(x, y, init_hyperparameters=ex.INIT,
             kernel_function=_reference("multi_task").mt_kernel)
    cov = f.posterior_covariance(x[:3], x_out=ex.TASKS)
    return {"lml": f.log_likelihood(),
            "mean": f.posterior_mean(x[:5], x_out=ex.TASKS)["m(x)"],
            "S": cov["S"], "var": cov["v(x)"]}


def _jax_non_euclidean():
    from fvgp_tpu import GP
    ex, ref = _port("non_euclidean"), _reference("non_euclidean")
    assert ref.SEQUENCES == ex.SEQUENCES
    gp = GP(*ex.data(), init_hyperparameters=ex.INIT,
            kernel_function=ref.hamming_kernel)
    return {"lml": gp.log_likelihood(),
            "mean": gp.posterior_mean(ex.UNSEEN)["m(x)"],
            "var": gp.posterior_covariance(ex.UNSEEN)["v(x)"]}


def _jax_gp2scale_sparse():
    from fvgp_tpu import GP
    ex = _port("gp2scale_sparse")
    n = SMALL["gp2scale_sparse"]["n"]
    x, y, xp = ex.data(n)
    gp = GP(x, y, init_hyperparameters=ex.INIT, gp2Scale=True,
            linalg_mode="sparseCGpre", args={**ex.ARGS, **CONVERGED})
    gp.K
    return {"lml": gp.log_likelihood(), "mean": gp.posterior_mean(xp)["m(x)"],
            "var": gp.posterior_covariance(xp, variance_only=True)["v(x)"]}


def _jax_gplvm_latent():
    from fvgp_tpu import GPLVM
    ex = _port("gplvm_latent")
    m = GPLVM(ex.data()[1], latent_dim=1)
    zq = ex.queries(m)
    return {"lml": m.log_likelihood(), "mean": m.posterior_mean(zq)["m(x)"],
            "var": m.posterior_covariance(zq, variance_only=True)["v(x)"]}


def _jax_manifold_gpm():
    from fvgp_tpu import GPm
    x, y, x_test, _ = _port("manifold_gpm").data()
    m = GPm(x, y, manifold_dim=1)
    return {"lml": m.log_likelihood(), "mean": m.posterior_mean(x_test),
            "var": m.posterior_variance(x_test)}


def _jax_ggmp_multitask():
    from fvgp_tpu.models.ggmp import GGMP, hyperparameters
    ex = _port("ggmp_multitask")
    x, y_data = ex.data()
    hobj = hyperparameters(np.full(ex.K, 1 / ex.K),
                           np.tile([0.0, 1.0], (ex.K, 1)),
                           [np.ones(3) for _ in range(ex.K)],
                           [np.tile([0.01, 10.0], (3, 1))
                            for _ in range(ex.K)])
    g = GGMP(x, y_data, hps_obj=hobj, likelihood_terms=ex.K)
    g.initLikelihoods()
    g.initGPs()
    return {"lml": sum(gp.log_likelihood() for gp in g.gps),
            "mean": g.posterior_mean(ex.X_PRED),
            "var": g.posterior_variance(ex.X_PRED),
            "pdf": g.posterior_pdf(ex.X_PRED, ex.DOMAIN)}


def _hold(got, want, tag):
    assert set(want) <= set(got), tag
    for key, w in want.items():
        w = np.asarray(w, dtype=np.float64)
        g = np.asarray(got[key])
        assert g.shape == w.shape, (tag, key, g.shape, w.shape)
        if key == "lml":
            np.testing.assert_allclose(g, w, rtol=PARITY, err_msg=tag)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=PARITY,
                                       err_msg=f"{tag} {key}")


# ---------------------------------------------------------------------------
# the spawned world of multichip_mesh, started first: it runs while the
# in-process examples run
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
            payload = {"ok": _multichip_rank()}
        finally:
            dist.destroy_process_group()
    except BaseException:
        payload = {"error": traceback.format_exc()}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(payload, f)


def _multichip_rank():
    import fvgp_tpu_torch.models.gp_marginal_likelihood as TML
    from fvgp_tpu_torch.examples import multichip_mesh as ex
    from fvgp_tpu_torch.examples._cli import world_mesh
    warnings.simplefilter("ignore")
    TML._rademacher_probes = (
        lambda n, p, dtype, device, generator:
        torch.as_tensor(ZF[:n, :p], dtype=dtype).to(device))
    with world_mesh("cpu"):
        first = ex.first("cpu", args=CONVERGED)
    return {"first": first, "main": ex.main(device="cpu", max_iter=3),
            "jax_loaded": "jax" in sys.modules}


@pytest.fixture(scope="module", autouse=True)
def multichip_world():
    out_dir = tempfile.mkdtemp(prefix="fvgp_examples_")
    store = os.path.join(out_dir, "store")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_world_main, args=(r, 4, store, out_dir))
             for r in range(4)]
    start = time.time()
    for p in procs:
        p.start()

    def results():
        for p in procs:
            p.join(max(0.0, WORLD_TIMEOUT - (time.time() - start)))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        out = []
        for r in range(len(procs)):
            path = os.path.join(out_dir, f"rank{r}.pkl")
            if not os.path.exists(path):
                pytest.fail(f"rank {r} wrote no result")
            with open(path, "rb") as f:
                payload = pickle.load(f)
            if "error" in payload:
                pytest.fail(f"rank {r} failed:\n{payload['error']}")
            out.append(payload["ok"])
        return out

    return results


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def test_the_port_has_every_example():
    port = sorted(p.stem for p in (ROOT / "fvgp_tpu_torch" / "examples")
                  .glob("*.py") if not p.stem.startswith("_"))
    assert len(NAMES) == 9 and port == NAMES


@pytest.mark.parametrize("name", sorted(SMALL))
def test_example_matches_jax_at_its_first_hyperparameters(name):
    ex = _port(name)
    with pytest.MonkeyPatch.context() as mp, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _inject_probes(mp)
        np.random.seed(0)
        want = globals()[f"_jax_{name}"]()
        args = CONVERGED if name == "gp2scale_sparse" else None
        kw = {"n": SMALL[name]["n"]} if name == "gp2scale_sparse" else {}
        _hold(ex.first("cpu", args=args, **kw), want, name)
        np.random.seed(0)
        out = ex.main(device="cpu", **SMALL[name])
    _hold(out["first"], {k: v for k, v in want.items()
                         if not (name == "gp2scale_sparse" and k == "lml")},
          f"{name} main")
    assert np.isfinite(out["lml"])
    assert out["lml"] >= out["first"]["lml"] - 1e-9 * abs(
        out["first"]["lml"]), (name, out["first"]["lml"], out["lml"])


def _bitwise(got, want):
    assert got.keys() == want.keys()
    for key, value in want.items():
        if isinstance(value, dict):
            _bitwise(got[key], value)
        else:
            np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_multichip_mesh_on_four_ranks(multichip_world):
    """Every rank returns the same bits; the first numbers are the JAX
    package's on a 4-device mesh at the same probes; training does not
    lower the LML; the 2 x 2 branch ran."""
    from fvgp_tpu import GP
    from fvgp_tpu.parallel import mesh as pmesh
    ex = _port("multichip_mesh")
    x, y = ex.data()
    with pytest.MonkeyPatch.context() as mp, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _inject_probes(mp)
        with pmesh.use_mesh(pmesh.make_mesh(4)):
            gp = GP(x, y, init_hyperparameters=ex.INIT, gp2Scale=True,
                    args={**ex.ARGS, **CONVERGED})
            xp = x[:5] + 0.05
            want = {"lml": gp.log_likelihood(),
                    "mean": gp.posterior_mean(xp)["m(x)"],
                    "var": gp.posterior_covariance(
                        xp, variance_only=True)["v(x)"]}
    ranks = multichip_world()
    for r in ranks[1:]:
        _bitwise(r["first"], ranks[0]["first"])
        _bitwise(r["main"], ranks[0]["main"])
    assert not any(r["jax_loaded"] for r in ranks)
    _hold(ranks[0]["first"], want, "multichip_mesh")
    out = ranks[0]["main"]
    assert out["ranks"] == 4 and np.isfinite(out["lml_2d"])
    assert out["lml"] >= out["first"]["lml"]


def test_an_example_runs_as_a_module_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    code = ("import runpy, sys\n"
            "sys.argv = ['single_task', '--device', 'cpu']\n"
            "runpy.run_module('fvgp_tpu_torch.examples.single_task',"
            " run_name='__main__')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in"
            " ('jax', 'fvgp_tpu')]\n"
            "print('LOADED', bad)\n"
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "LOADED []" in proc.stdout and "initial LML:" in proc.stdout
    assert "crps:" in proc.stdout
