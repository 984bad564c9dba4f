"""Package rules of fvgp_tpu_torch: it never loads JAX or the JAX package,
a card that is not there is refused instead of quietly replaced by the CPU,
unported paths say so, and the chip smoke refuses to run without a card."""

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


def test_dense_path_and_unported_methods_raise():
    x, y = _tiny_data()
    with pytest.raises(NotImplementedError, match="ROADMAP item 1.2"):
        GP(x, y, gp2Scale=False)
    with pytest.warns(UserWarning):
        gp = GP(x, y, gp2Scale=True)
    with pytest.raises(NotImplementedError, match="ROADMAP item 1.5"):
        gp.train(method="mcmc")
    with pytest.raises(NotPortedError, match="ROADMAP item 1.6"):
        gp.rmse(x, y)
    assert not hasattr(gp, "joint_gp_prior")
    with pytest.raises(AttributeError):
        gp.no_such_attribute


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = _run([str(ROOT / "chip_smoke.py")])
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
