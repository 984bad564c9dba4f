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
    for make in (lambda: GP(x, y), lambda: GPdata(x, y),
                 lambda: gp_from_numpy_state(state), resolve_device):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
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
    with pytest.raises(NotImplementedError, match="ROADMAP item 1.4"):
        GP(x, y, compute_device="cpu", linalg_mode="sparseCG")
    with pytest.raises(NotPortedError, match="ROADMAP item 1.6"):
        dense.crps(x, y)
    with pytest.raises(NotPortedError, match="ROADMAP item 1.2"):
        dense.gp_entropy(x)
    assert not hasattr(dense, "posterior_mean_grad")
    with pytest.warns(UserWarning):
        gp = GP(x, y, gp2Scale=True, compute_device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP item 1.3"):
        gp.update_gp_data(x, y)
    with pytest.raises(NotImplementedError, match="ROADMAP item 1.5"):
        gp.train(method="bo")
    with pytest.raises(AttributeError):
        gp.no_such_attribute


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
