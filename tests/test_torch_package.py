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
