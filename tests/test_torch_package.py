"""Package rules of fvgp_tpu_torch: it never loads JAX or the JAX package,
its entry points run on the card unless the CPU is asked for, a card that
is not there is refused instead of quietly replaced by the CPU, unported
paths say so, and the chip smoke refuses to run without a card."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fvgp_tpu_torch import GP, NotPortedError


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


def _run(code_or_args, cwd=ROOT, timeout=240):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    args = code_or_args if isinstance(code_or_args, list) \
        else ["-c", code_or_args]
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_import_loads_neither_jax_nor_the_jax_package():
    proc = _run(
        "import sys, fvgp_tpu_torch\n"
        "import fvgp_tpu_torch.ops.sparse_lml, fvgp_tpu_torch.interop\n"
        "import fvgp_tpu_torch.ops.dense, fvgp_tpu_torch.ops.hopper_kernels\n"
        "import fvgp_tpu_torch.kernels, fvgp_tpu_torch.models.gp_mcmc\n"
        "import fvgp_tpu_torch.models.gp_bo, fvgp_tpu_torch.models.gp_actor\n"
        "import fvgp_tpu_torch.models.gp_training\n"
        "import fvgp_tpu_torch.models.fvgp, fvgp_tpu_torch.models.gp_kv\n"
        "import fvgp_tpu_torch.models.gp_likelihood\n"
        "import fvgp_tpu_torch.models.gp_marginal_likelihood\n"
        "import fvgp_tpu_torch.ops.krylov, fvgp_tpu_torch.ops.slq\n"
        "import fvgp_tpu_torch.ops.precond\n"
        "import fvgp_tpu_torch.parallel.block_sparse\n"
        "import fvgp_tpu_torch.parallel.sharded_cov\n"
        "import fvgp_tpu_torch.parallel.mesh\n"
        "import fvgp_tpu_torch.parallel.partition\n"
        "import chip_smoke\n"
        "import fvgp_tpu_torch.models.deep_kernel_network\n"
        "import fvgp_tpu_torch.models.gpm, fvgp_tpu_torch.models.gplvm\n"
        "import fvgp_tpu_torch.models.ggmp\n"
        "import fvgp_tpu_torch.utils.timing\n"
        "import fvgp_tpu_torch.examples.single_task\n"
        "import fvgp_tpu_torch.examples.deep_kernel\n"
        "import fvgp_tpu_torch.examples.multi_task\n"
        "import fvgp_tpu_torch.examples.non_euclidean\n"
        "import fvgp_tpu_torch.examples.gp2scale_sparse\n"
        "import fvgp_tpu_torch.examples.multichip_mesh\n"
        "import fvgp_tpu_torch.examples.gplvm_latent\n"
        "import fvgp_tpu_torch.examples.manifold_gpm\n"
        "import fvgp_tpu_torch.examples.ggmp_multitask\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'fvgp_tpu' or m.startswith('fvgp_tpu.')"
        " or m == 'optax' or m.startswith('optax.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)")
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_log_time_keeps_cumulative_totals(capsys):
    """``utils.log_time`` (the JAX package's ``utils/timing.py``): per-label
    totals and counts in ``timing_report``, printed only when enabled."""
    from fvgp_tpu_torch.utils import log_time, timing
    label = "test_torch_package block"
    before = timing.timing_report().get(label, {"total_s": 0.0, "count": 0})
    for _ in range(2):
        with log_time(label):
            sum(range(1000))
    assert capsys.readouterr().out == ""
    timing.enable()
    try:
        with log_time(label):
            pass
    finally:
        timing.disable()
    assert f"[fvgp_tpu_torch timing] {label}:" in capsys.readouterr().out
    report = timing.timing_report()[label]
    assert report["count"] == before["count"] + 3
    assert report["total_s"] >= before["total_s"]


def _tiny_data():
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 5, (40, 2))
    return x, np.sin(x[:, 0])


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    x, y = _tiny_data()
    for device in ("cuda", "gpu"):
        with pytest.raises(RuntimeError, match="CUDA"):
            GP(x, y, gp2Scale=True, compute_device=device)


def test_entry_points_default_to_the_card():
    """No ``compute_device``: the card — which raises on a machine without
    one, exactly like an explicit ``"cuda"``."""
    import inspect

    from fvgp_tpu_torch import GPLVM, GPm, fvGP, gp_from_numpy_state
    from fvgp_tpu_torch.config import resolve_device
    from fvgp_tpu_torch.interop import (ggmp_from_numpy_state,
                                        gplvm_from_numpy_state,
                                        gpm_from_numpy_state)
    from fvgp_tpu_torch.models.gp_data import GPdata
    for fn in (GP, fvGP, GPdata, gp_from_numpy_state, resolve_device, GPm,
               GPLVM, gpm_from_numpy_state, gplvm_from_numpy_state,
               ggmp_from_numpy_state):
        default = inspect.signature(fn).parameters["compute_device"].default
        assert default == "cuda", fn
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    x, y = _tiny_data()
    state = {"x_data": x, "y_data": y, "noise_variances": None,
             "hyperparameters": np.ones(3), "gp2Scale": False}
    # the stored-K slice's own entry points: a matrix from host arrays, its
    # two constructors, and the SLQ estimator on a closure (an operator with a
    # device of its own decides instead)
    from scipy import sparse

    from fvgp_tpu_torch.ops.slq import slq_logdet
    from fvgp_tpu_torch.parallel import block_sparse as tbs
    for fn in (tbs.BlockSparseMatrix, tbs.from_scipy, tbs.from_numpy_state,
               slq_logdet):
        assert inspect.signature(fn).parameters["device"].default is None, fn
    tile = np.eye(32)[None]
    bsm_state = dict(n=32, n_cols=32, block_size=32, rows=np.zeros(1, int),
                     cols=np.zeros(1, int), tiles=tile, diag=None)
    y2 = np.stack([y, 2 * y], axis=1)
    for make in (lambda: GP(x, y), lambda: GPdata(x, y), lambda: fvGP(x, y2),
                 lambda: GPm(x, y2), lambda: GPLVM(y2),
                 lambda: gp_from_numpy_state(state), resolve_device,
                 lambda: tbs.BlockSparseMatrix(32, 32, 32, [0], [0], tile),
                 lambda: tbs.from_scipy(sparse.identity(32, format="csr"), 32),
                 lambda: tbs.from_numpy_state(bsm_state),
                 lambda: slq_logdet(lambda X: X, 32)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    eye = torch.eye(32, dtype=torch.float64)
    assert abs(slq_logdet(lambda A, X: A @ X, 32, operator=eye,
                          degree=4)) < 1e-12
    assert resolve_device("cpu").type == "cpu"


def test_dense_path_and_unported_methods_raise():
    """The dense path and the gp2Scale path both build on the CPU; what is
    not ported yet on either raises with the ROADMAP item that brings
    it."""
    x, y = _tiny_data()
    with pytest.warns(UserWarning):
        dense = GP(x, y, compute_device="cpu")
    assert np.isfinite(dense.log_likelihood())
    # served since the training slice (item 1.5): hgdl trains
    bounds = np.array([[0.05, 5.0], [0.2, 10.0], [0.2, 10.0]])
    hps = dense.train(method="hgdl", hyperparameter_bounds=bounds,
                      pop_size=4, max_iter=5)
    assert hps.shape == (3,) and np.all(np.isfinite(hps))
    with pytest.raises(Exception, match="No Mode"):
        GP(x, y, compute_device="cpu", linalg_mode="sparseQR")
    # served since the posterior-API slice: custom modes, the posterior
    # gradients, the information suite and the metrics; item 1.5's names
    # since the training slice
    custom = GP(x, y, compute_device="cpu",
                linalg_mode=[lambda KV: KV, lambda f, b: b, lambda f: 0.0])
    assert np.isfinite(custom.log_likelihood())
    assert np.isfinite(dense.crps(x, y)[0])
    assert np.isfinite(dense.gp_entropy(x[:3]))
    assert hasattr(dense, "posterior_mean_grad")
    from fvgp_tpu_torch.models.gp import _NOT_PORTED
    assert _NOT_PORTED == {} and issubclass(NotPortedError,
                                            NotImplementedError)
    assert dense.bo_info is None
    for name in ("stop_training", "kill_client", "update_hyperparameters"):
        assert callable(getattr(dense, name))
    with pytest.warns(UserWarning):
        gp = GP(x, y, gp2Scale=True, compute_device="cpu")
    gp.train(method="bo", hyperparameter_bounds=bounds, max_iter=3,
             bo_args={"n_init": 2, "surrogate_train_max_iter": 5})
    assert gp.bo_info["n_evaluations"] == 3
    # served since the gp2Scale Hessian was ported: central differences of
    # the gradient, symmetric
    hess = gp.marginal_likelihood.neg_log_likelihood_hessian()
    assert hess.shape == (x.shape[1] + 1,) * 2 and np.all(np.isfinite(hess))
    np.testing.assert_array_equal(hess, hess.T)
    probability = gp.posterior_probability(x[:4], y[:4], np.eye(4))
    assert 0.0 <= probability["probability"] < np.inf
    with pytest.raises(AttributeError):
        gp.no_such_attribute
    # served since ROADMAP item 1.8: the multi-device layout; a one-rank
    # mesh gives the meshless matrix
    import types

    from scipy import sparse

    from fvgp_tpu_torch.parallel.sharded_cov import distributed_covariance
    one_rank = distributed_covariance(gp.prior, x, x, gp.hyperparameters,
                                      symmetric=True, args=gp.args,
                                      mesh=types.SimpleNamespace(size=1))
    assert one_rank.mesh is None
    meshless = distributed_covariance(gp.prior, x, x, gp.hyperparameters,
                                      symmetric=True, args=gp.args)
    np.testing.assert_array_equal(one_rank.toarray(), meshless.toarray())
    # served since item 1.6: list inputs (a host kernel takes the lists),
    # structured noise on a block-sparse K, a noise callable under
    # gp2Scale, the gradient callables and host callables' gradients
    def list_kernel(a, b, hps):
        return hps[0] * np.exp(-np.abs(np.asarray(a)[:, None, 0]
                                       - np.asarray(b)[None, :, 0]))

    host = GP(list(x), y, gp2Scale=True, compute_device="cpu",
              init_hyperparameters=np.ones(1), kernel_function=list_kernel)
    K = distributed_covariance(host.prior, list(x), list(x), np.ones(1),
                               symmetric=True, args=host.args)
    np.testing.assert_allclose(K.toarray(), list_kernel(x, x, np.ones(1)),
                               atol=1e-12)
    noise = sparse.identity(len(x), format="csr")
    for V in (noise, gp.K):
        np.testing.assert_allclose(gp.kv.addKV(gp.K, V).toarray(),
                                   gp.K.toarray() + (noise.toarray()
                                                     if V is noise
                                                     else gp.K.toarray()),
                                   atol=1e-12)
    noisy = GP(x, y, gp2Scale=True, compute_device="cpu",
               init_hyperparameters=np.ones(3),
               noise_function=lambda x, hps: hps[0] * torch.ones(len(x)))
    assert np.isfinite(noisy.log_likelihood())
    assert np.all(np.isfinite(noisy.posterior_mean(x[:3])["m(x)"]))
    grads = GP(x, y, compute_device="cpu", init_hyperparameters=np.ones(3),
               kernel_function=lambda a, b, h: h[0] * np.exp(-np.abs(
                   np.asarray(a)[:, None, 0] - np.asarray(b)[None, :, 0])),
               kernel_function_grad=lambda a, b, h: np.stack([
                   np.exp(-np.abs(np.asarray(a)[:, None, 0]
                                  - np.asarray(b)[None, :, 0])),
                   np.zeros((len(a), len(b))), np.zeros((len(a), len(b)))]),
               noise_function=lambda x, h: np.full(len(x), 0.1 * h[1]),
               noise_function_grad=lambda x, h: np.stack([
                   np.zeros(len(x)), np.full(len(x), 0.1), np.zeros(len(x))]),
               prior_mean_function=lambda x, h: np.zeros(len(x)),
               prior_mean_function_grad=lambda x, h: np.zeros((3, len(x))))
    fd, an = grads.test_log_likelihood_gradient(np.ones(3), epsilon=1e-7)
    np.testing.assert_allclose(fd, an, rtol=1e-4, atol=1e-4)


def test_sparse_modes_and_gp2scale_appends_are_served():
    """What the stored-K slice turned from raising sites into paths: the
    sparse linalg modes on a dense model, ``gp.K`` and ``update_gp_data``
    under gp2Scale, a full posterior covariance, a prior mean function."""
    x, y = _tiny_data()
    with pytest.warns(UserWarning):
        dense = GP(x, y, compute_device="cpu")
        cg = GP(x, y, compute_device="cpu", linalg_mode="sparseCGpre",
                args={"sparse_cg_tol": 1e-12,
                      "sparse_preconditioner_block_size": 16})
    np.testing.assert_allclose(cg.posterior_mean(x[:5])["m(x)"],
                               dense.posterior_mean(x[:5])["m(x)"],
                               atol=1e-8)
    assert cg.kv.last_solve_info["preconditioned"]
    with pytest.warns(UserWarning):
        gp = GP(x, y, gp2Scale=True, compute_device="cpu",
                prior_mean_function=lambda x, hps: 0.1 * x[:, 0],
                init_hyperparameters=np.array([1.0, 2.0, 2.0]),
                args={"gp2Scale_block_size": 16})
    assert gp.K.shape == (40, 40)
    gp.update_gp_data(x[:8] + 0.01, y[:8])
    assert gp.K.shape == (48, 48) and len(gp.m) == 48
    assert gp.posterior_covariance(x[:5])["S"].shape == (5, 5)
    assert np.isfinite(gp.log_likelihood(gp.hyperparameters))


def test_package_exports_the_mcmc_sampler():
    """``gpMCMC`` and ``ProposalDistribution`` come through the package
    name, and a short chain equals the JAX package's at the same seed."""
    import fvgp_tpu
    import fvgp_tpu_torch
    bounds = np.array([[-3.0, 3.0], [-3.0, 3.0]])

    def log_like(x, args):
        return -0.5 * float(np.sum((x - np.array([0.5, -0.2])) ** 2) / 0.3)

    traces = {}
    for name, pkg in (("jax", fvgp_tpu), ("torch", fvgp_tpu_torch)):
        prop = pkg.ProposalDistribution(
            np.arange(2), init_prop_Sigma=0.05 * np.eye(2))
        sampler = pkg.gpMCMC(log_like, bounds=bounds,
                             proposal_distributions=[prop])
        np.random.seed(12)
        info = sampler.run_mcmc(x0=np.zeros(2), n_updates=60)
        traces[name] = (np.asarray(sampler.trace["x"]),
                        np.asarray(sampler.trace["f(x)"]), info)
    # the JAX package's whole public surface comes through the package name
    assert set(fvgp_tpu_torch.__all__) >= set(fvgp_tpu.__all__)
    for name in fvgp_tpu.__all__:
        assert getattr(fvgp_tpu_torch, name).__name__.rsplit(".", 1)[-1] \
            == getattr(fvgp_tpu, name).__name__.rsplit(".", 1)[-1]
    np.testing.assert_array_equal(traces["torch"][0], traces["jax"][0])
    np.testing.assert_array_equal(traces["torch"][1], traces["jax"][1])
    assert traces["torch"][0].shape == (60, 2)
    assert len(np.unique(traces["torch"][0], axis=0)) > 5


def test_concurrent_first_use_builds_both_load(tmp_path):
    """Two processes (the ranks of a mesh starting together) build the
    native library into one empty directory at once: each compiles into a
    file of its own and renames it into place, so both load a whole
    library and no temporary file is left."""
    code = ("import ctypes, sys\n"
            "from fvgp_tpu_torch import native\n"
            "lib = ctypes.CDLL(str(native._build(sys.argv[1])))\n"
            "print(bool(lib.tile_live))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and out.strip() == "True", err
    assert [f.name for f in tmp_path.iterdir()] == ["libfvgp_structure.so"]


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = _run([str(ROOT / "chip_smoke.py")])
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def _code_strings(tree):
    """String constants of a module that are not docstrings."""
    docs = {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                 ast.AsyncFunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}
    return [node for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and id(node) not in docs]


def test_port_builds_no_path_into_the_jax_package():
    """The native runtime builds from the port's own source, and no module
    of the port names a file of the JAX package in its code (docstrings
    may cite one as the reference)."""
    from fvgp_tpu_torch import native
    pkg = ROOT / "fvgp_tpu_torch"
    assert native._SRC.resolve().is_relative_to(pkg), native._SRC
    assert native._SRC.is_file()
    bad = []
    for py in sorted(pkg.rglob("*.py")):
        for node in _code_strings(ast.parse(py.read_text())):
            v = node.value.replace("\\", "/")
            if v.strip("/") == "fvgp_tpu" or "fvgp_tpu/" in v:
                bad.append(f"{py.relative_to(ROOT)}:{node.lineno}: {v!r}")
    assert not bad, bad


# ---------------------------------------------------------------------------
# the JAX package's whole surface, and the op-level public functions
# ---------------------------------------------------------------------------

# TPU-only names of the JAX package, each with the reason it has no
# counterpart in the port
SURFACE_ALLOWLIST = {
    "fvgp_tpu.config.asarray":
        "a jnp array in the linalg dtype; the port's counterpart is "
        "config.to_tensor, which takes the device explicitly",
    "fvgp_tpu.parallel.mesh.tile_spec":
        "a jax.sharding.PartitionSpec; a torch.distributed rank holds its "
        "own tiles and has no sharding spec",
    "fvgp_tpu.ops.pallas_kernels":
        "the Pallas module: its kernels are ops/hopper_kernels.py's "
        "chunked_spmm, row_chunk_sums, dense_covariance, block_spmv and "
        "row_aligned_schedule, and chunked_spmm_fits is the TPU's VMEM gate",
}


def _public_names(mod):
    """A module's public top-level names: ``__all__``, what it defines, its
    public non-callable values, and in a package's ``__init__`` what it
    re-exports from its own submodules."""
    import inspect
    import types
    names = set(getattr(mod, "__all__", ()))
    is_pkg = hasattr(mod, "__path__")
    for name, value in vars(mod).items():
        if name.startswith("_") or isinstance(value, types.ModuleType):
            continue
        if not (inspect.isfunction(value) or inspect.isclass(value)) \
                and not (callable(value) and hasattr(value, "__module__")):
            names.add(name)
            continue
        owner = str(getattr(value, "__module__", ""))
        if owner == mod.__name__ or (is_pkg and owner.startswith(
                mod.__name__ + ".")):
            names.add(name)
    return names


# parameters the port adds to a JAX signature: where the work runs and in
# what precision (ROADMAP §3, "extra device parameters")
EXTRA_PARAMETERS = {"device", "compute_device", "dtype"}

# public functions and methods whose parameters differ otherwise, each with
# the ROADMAP §3 deviation that records why: (deviation, reason)
SIGNATURE_ALLOWLIST = {
    "fvgp_tpu.ops.slq.slq_logdet":
        ("generators", "probes from a torch.Generator in place of a JAX "
                       "PRNG key"),
    "fvgp_tpu.parallel.mesh.make_mesh":
        ("mesh-backend", "a torch.distributed world: backend, group and "
                         "timeout in place of a list of JAX devices"),
    "fvgp_tpu.parallel.mesh.make_mesh_2d":
        ("mesh-backend", "a torch.distributed world: group and timeout in "
                         "place of a list of JAX devices"),
    "fvgp_tpu.parallel.block_sparse.BlockSparseMatrix.__init__":
        ("mesh-argument", "a row-owned matrix names its mesh"),
    "fvgp_tpu.parallel.sharded_cov.distributed_covariance":
        ("mesh-argument", "a row-owned K names its mesh"),
    "fvgp_tpu.models.gpm.GPm.__init__":
        ("gpm-args", "GPm takes the args dict of its GP"),
    "fvgp_tpu.ops.dense.check_factor":
        ("factor-info", "the failure flag of torch.linalg.cholesky_ex"),
    "fvgp_tpu.models.gp_marginal_likelihood.GPMarginalLikelihood"
    ".sparse_adam_steps":
        ("probe-source", "injected probes for the parity tests"),
}


def _jax_modules():
    """(JAX module, its port counterpart) for every module of ``fvgp_tpu``
    but the TPU-only ones."""
    import importlib
    import pkgutil

    import fvgp_tpu
    for info in pkgutil.walk_packages(fvgp_tpu.__path__, "fvgp_tpu."):
        if info.name in SURFACE_ALLOWLIST:
            continue
        yield (importlib.import_module(info.name), importlib.import_module(
            info.name.replace("fvgp_tpu", "fvgp_tpu_torch", 1)))


def _public_members(cls):
    """A class's public methods and properties (inherited ones too)."""
    return [name for name in dir(cls) if not name.startswith("_")]


def test_the_port_has_every_public_name_of_the_jax_package():
    """Every module of ``fvgp_tpu`` has its counterpart in the port with
    each public top-level name, and every public class each public method
    and property (properties as properties); only the TPU-only names of
    the allowlist are missing."""
    import importlib
    import inspect

    import fvgp_tpu
    import fvgp_tpu_torch
    missing = []
    for jax_mod, port_mod in _jax_modules():
        for name in sorted(_public_names(jax_mod)):
            qual = f"{jax_mod.__name__}.{name}"
            if qual in SURFACE_ALLOWLIST:
                continue
            if not hasattr(port_mod, name):
                missing.append(qual)
                continue
            cls = getattr(jax_mod, name)
            if not (inspect.isclass(cls)
                    and cls.__module__ == jax_mod.__name__):
                continue
            port_cls = getattr(port_mod, name)
            for member in _public_members(cls):
                if not hasattr(port_cls, member):
                    missing.append(f"{qual}.{member}")
                elif isinstance(inspect.getattr_static(cls, member),
                                property) and not isinstance(
                        inspect.getattr_static(port_cls, member), property):
                    missing.append(f"{qual}.{member} (not a property)")
    for name in fvgp_tpu.__all__:
        cls = getattr(fvgp_tpu, name)
        if inspect.isclass(cls):
            port_cls = getattr(fvgp_tpu_torch, name)
            missing += [f"{name}.{m}" for m in _public_members(cls)
                        if not hasattr(port_cls, m)]
    assert not missing, missing
    assert fvgp_tpu_torch.__version__ == fvgp_tpu.__version__
    for name in SURFACE_ALLOWLIST:                 # no stale entries
        module, _, attr = name.rpartition(".")
        if module == "fvgp_tpu.ops":
            importlib.import_module(name)
        else:
            assert hasattr(importlib.import_module(module), attr), name


def _parameters(fn):
    import inspect
    try:
        return list(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        return None


def _signature_pairs():
    """(qualified JAX name, JAX callable, port callable) for every public
    function of every module and every public method of every class."""
    import inspect
    for jax_mod, port_mod in _jax_modules():
        for name, value in sorted(vars(jax_mod).items()):
            qual = f"{jax_mod.__name__}.{name}"
            if name.startswith("_") or qual in SURFACE_ALLOWLIST \
                    or getattr(value, "__module__", None) != jax_mod.__name__:
                continue
            port = getattr(port_mod, name)
            if not inspect.isclass(value):
                if callable(value):
                    yield qual, value, port
                continue
            for member in ["__init__", *_public_members(value)]:
                raw = inspect.getattr_static(value, member)
                if isinstance(raw, property) or not callable(
                        getattr(value, member)):
                    continue
                yield f"{qual}.{member}", getattr(value, member), \
                    getattr(port, member)


def test_every_public_signature_takes_the_jax_parameters():
    """Every public function and method of the port takes the JAX
    package's parameters by the same names in the same order; the port's
    ``device`` / ``compute_device`` / ``dtype`` parameters aside, every
    other difference is on the allowlist with the ROADMAP §3 deviation
    that records it."""
    from _torch_reference import DEVIATIONS, ROADMAP
    differ, seen = [], set()
    for qual, jax_fn, port_fn in _signature_pairs():
        seen.add(qual)
        jax_params = _parameters(jax_fn)
        port_params = [p for p in _parameters(port_fn) or ()
                       if p not in EXTRA_PARAMETERS
                       or p in (jax_params or ())]
        if jax_params is not None and jax_params != port_params \
                and qual not in SIGNATURE_ALLOWLIST:
            differ.append((qual, jax_params, port_params))
    assert not differ, differ
    roadmap = ROADMAP.read_text()
    for qual, (key, reason) in SIGNATURE_ALLOWLIST.items():
        assert qual in seen, qual                   # no stale entries
        assert reason and DEVIATIONS[key] in roadmap, (qual, key)


def wendland_anisotropic_gp2Scale_gpu(x1, x2, hps):
    """A reference user's own Wendland kernel, under fvGP's name."""
    from fvgp_tpu_torch.kernels import wendland_anisotropic
    return wendland_anisotropic(x1, x2, hps)


def test_a_wendland_kernel_named_by_fvgp_is_pruned_as_in_jax():
    """``support_geometry`` knows the Wendland kernel by its names, as the
    JAX package does: a user's function named
    ``wendland_anisotropic_gp2Scale_gpu`` gives the same pruned tile set,
    no "support is unknown" warning, and the JAX package's LML."""
    import warnings

    import jax.numpy as jnp

    from fvgp_tpu import GP as JaxGP
    from fvgp_tpu.kernels import wendland_anisotropic as jax_wendland

    def jax_kernel(x1, x2, hps):
        return jax_wendland(x1, x2, jnp.asarray(hps))

    jax_kernel.__name__ = "wendland_anisotropic_gp2Scale_gpu"
    rng = np.random.default_rng(8)
    x = rng.uniform(0, 30, (300, 2))
    y = np.sin(x[:, 0]) + 0.05 * rng.standard_normal(300)
    kw = dict(init_hyperparameters=np.array([1.0, 1.5, 1.5]), gp2Scale=True,
              args={"gp2Scale_block_size": 32, "gp2Scale_traced_lml": False})
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        gp = GP(x, y, kernel_function=wendland_anisotropic_gp2Scale_gpu,
                compute_device="cpu", **kw)
        K, lml = gp.K, gp.log_likelihood()
    assert not [w for w in seen if "support is unknown" in str(w.message)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jgp = JaxGP(x, y, kernel_function=jax_kernel, **kw)
        jK, jlml = jgp.K, jgp.log_likelihood()
    nb = -(-300 // 32)
    # the live tile counts (the padding of the two layouts differs)
    assert K.nnz // 32 ** 2 == jK.nnz // 32 ** 2 < nb * nb
    np.testing.assert_allclose(lml, jlml, rtol=1e-8)


def test_set_linalg_dtype_priority_chain_matches_jax():
    """``args['dtype']`` > ``set_linalg_dtype`` > the device default, as in
    ``fvgp_tpu.config``; ``default_backend`` reports the device."""
    import jax.numpy as jnp

    from fvgp_tpu import config as jconfig
    from fvgp_tpu_torch import config
    names = {torch.float64: "float64", torch.float32: "float32",
             torch.bfloat16: "bfloat16"}
    assert config.default_backend() == (
        "cuda" if torch.cuda.is_available() else "cpu")
    cases = [(None, None), ({"dtype": "float64"}, None)]
    try:
        for forced in (None, "float32"):
            config.set_linalg_dtype(forced)
            jconfig.set_linalg_dtype(forced)
            for args in (None, {"dtype": "float64"}, {"dtype": "float32"},
                         {"kernel_dtype": "bfloat16"}):
                assert names[config.linalg_dtype(args, "cpu")] \
                    == jnp.dtype(jconfig.linalg_dtype(args)).name
                assert names[config.kernel_compute_dtype(args, "cpu")] \
                    == jnp.dtype(jconfig.kernel_compute_dtype(args)).name
            cases.append(config.linalg_dtype(None, "cuda"))
        # a model built under the override solves in it
        config.set_linalg_dtype("float32")
        x, y = _tiny_data()
        with pytest.warns(UserWarning):
            gp = GP(x, y, compute_device="cpu")
        assert gp.prior.dtype == gp.kv.KVinvY.dtype == torch.float32
    finally:
        config.set_linalg_dtype(None)
        jconfig.set_linalg_dtype(None)
    assert cases[2:] == [torch.float32, torch.float32]
    assert config.linalg_dtype(None, "cpu") == torch.float64


def test_op_level_assembler_and_tile_maxabs_match_jax():
    """``ops.sparse_lml.assemble_tiles`` / ``tile_maxabs`` against the JAX
    package on unclamped indices: the sentinel rows (== nb) gather the last
    block in both, and the maxima drive the same zero-tile filter."""
    import jax.numpy as jnp

    from fvgp_tpu.kernels import wendland_anisotropic as jw
    from fvgp_tpu.ops import sparse_lml as jsl
    from fvgp_tpu_torch.kernels import wendland_anisotropic as tw
    from fvgp_tpu_torch.ops import sparse_lml as tsl
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 20, (150, 2))
    B, hps = 16, np.array([1.0, 1.3, 0.8])
    nb = -(-len(x) // B)
    rows = np.concatenate([np.repeat(np.arange(nb), nb), [nb, nb]])
    cols = np.concatenate([np.tile(np.arange(nb), nb), [nb, 0]])
    jxb, jmask, *_ = jsl.make_padded_inputs(
        x, np.zeros(len(x)), np.full(len(x), 1e-2), B, dtype=jnp.float64)
    txb = torch.as_tensor(np.asarray(jxb))
    tmask = torch.as_tensor(np.asarray(jmask))
    jt = np.asarray(jsl.assemble_tiles(jw, jxb, jmask, jnp.asarray(rows),
                                       jnp.asarray(cols), jnp.asarray(hps)))
    tt = tsl.assemble_tiles(tw, txb, tmask, rows, cols, hps)
    assert tt.shape == jt.shape and tt.dtype == torch.float64
    np.testing.assert_allclose(tt.numpy(), jt, rtol=0, atol=1e-12)
    assert tsl.assemble_tiles(tw, txb, tmask, rows, cols, hps,
                              out_dtype="float32").dtype == torch.float32
    jm = np.asarray(jsl.tile_maxabs(jw, jxb, jmask, jnp.asarray(rows),
                                    jnp.asarray(cols), jnp.asarray(hps)))
    tm = tsl.tile_maxabs(tw, txb, tmask, rows, cols, hps).numpy()
    np.testing.assert_allclose(tm, jm, rtol=0, atol=1e-12)
    assert 0 < np.count_nonzero(tm) < len(tm)
    # differentiable in the hyperparameters, as the LML's assembler is
    h = torch.tensor(hps, requires_grad=True)
    torch.sum(tsl.assemble_tiles(tw, txb, tmask, rows, cols, h)).backward()
    assert torch.all(torch.isfinite(h.grad)) and h.grad[0] > 0


def test_dense_matvec_and_the_preconditioner_factories():
    """``make_dense_matvec`` drives ``cg`` as in the JAX suite
    (``tests/test_linalg.py``), and the Schwarz / two-level factories
    are the apply functions that ``build_*_op`` return."""
    from fvgp_tpu_torch.ops import krylov, precond
    rng = np.random.default_rng(2)
    M = rng.standard_normal((40, 40))
    A = torch.as_tensor(M @ M.T + 40 * np.eye(40))
    b = torch.as_tensor(rng.standard_normal(40))
    x = krylov.cg(krylov.make_dense_matvec(A), b, tol=1e-12)
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(A.numpy(),
                                                          b.numpy()),
                               atol=1e-9)
    args = {"sparse_preconditioner_block_size": 8}
    X = torch.as_tensor(rng.standard_normal((40, 3)))
    fn, Winv = precond.build_schwarz_op(A, args)
    np.testing.assert_array_equal(
        precond.schwarz_apply_factory(5, 8, 40)(Winv, X).numpy(),
        fn(Winv, X).numpy())
    fn, data = precond.build_two_level_op(A, args)
    np.testing.assert_array_equal(
        precond.two_level_apply_factory(5, 8, 40)(data, X).numpy(),
        fn(data, X).numpy())
