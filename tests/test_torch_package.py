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
        "import fvgp_tpu_torch.ops.krylov, fvgp_tpu_torch.ops.slq\n"
        "import fvgp_tpu_torch.ops.precond\n"
        "import fvgp_tpu_torch.parallel.block_sparse\n"
        "import fvgp_tpu_torch.parallel.sharded_cov\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'fvgp_tpu' or m.startswith('fvgp_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)")
    assert proc.returncode == 0, proc.stdout + proc.stderr


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

    from fvgp_tpu_torch import gp_from_numpy_state
    from fvgp_tpu_torch.config import resolve_device
    from fvgp_tpu_torch.models.gp_data import GPdata
    for fn in (GP, GPdata, gp_from_numpy_state, resolve_device):
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
    for make in (lambda: GP(x, y), lambda: GPdata(x, y),
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
    with pytest.raises(NotImplementedError, match="ROADMAP item 1.5"):
        dense.train(method="hgdl")
    with pytest.raises(NotImplementedError, match="ROADMAP item 1.2"):
        GP(x, y, compute_device="cpu",
           linalg_mode=[lambda KV: KV, lambda f, b: b, lambda f: 0.0])
    with pytest.raises(Exception, match="No Mode"):
        GP(x, y, compute_device="cpu", linalg_mode="sparseQR")
    with pytest.raises(NotPortedError, match="ROADMAP item 1.6"):
        dense.crps(x, y)
    with pytest.raises(NotPortedError, match="ROADMAP item 1.2"):
        dense.gp_entropy(x)
    assert not hasattr(dense, "posterior_mean_grad")
    with pytest.warns(UserWarning):
        gp = GP(x, y, gp2Scale=True, compute_device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP item 1.5"):
        gp.train(method="bo")
    # served since the gp2Scale Hessian was ported: central differences of
    # the gradient, symmetric
    hess = gp.marginal_likelihood.neg_log_likelihood_hessian()
    assert hess.shape == (x.shape[1] + 1,) * 2 and np.all(np.isfinite(hess))
    np.testing.assert_array_equal(hess, hess.T)
    with pytest.raises(NotPortedError, match="ROADMAP item 1.2"):
        gp.posterior_probability(x, y)
    with pytest.raises(AttributeError):
        gp.no_such_attribute
    # the stored-K slice's own raising sites: the multi-device layout,
    # structured noise, list inputs
    from scipy import sparse

    from fvgp_tpu_torch.parallel.sharded_cov import distributed_covariance
    with pytest.raises(NotImplementedError, match="ROADMAP item 1.8"):
        distributed_covariance(gp.prior, x, x, gp.hyperparameters,
                               symmetric=True, args=gp.args, mesh=object())
    with pytest.raises(NotImplementedError, match="ROADMAP item 1.6"):
        distributed_covariance(gp.prior, list(x), list(x),
                               gp.hyperparameters, symmetric=True,
                               args=gp.args)
    for V in (sparse.identity(len(x), format="csr"), gp.K):
        with pytest.raises(NotImplementedError, match="ROADMAP item 1.6"):
            gp.kv.addKV(gp.K, V)
    with pytest.raises(NotImplementedError, match="ROADMAP item 1.6"):
        GP(x, y, gp2Scale=True, compute_device="cpu",
           init_hyperparameters=np.ones(3),
           noise_function=lambda x, hps: hps[0] * torch.ones(len(x)))


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
    assert set(fvgp_tpu_torch.__all__) >= {"GP", "gpMCMC",
                                           "ProposalDistribution"}
    np.testing.assert_array_equal(traces["torch"][0], traces["jax"][0])
    np.testing.assert_array_equal(traces["torch"][1], traces["jax"][1])
    assert traces["torch"][0].shape == (60, 2)
    assert len(np.unique(traces["torch"][0], axis=0)) > 5


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
