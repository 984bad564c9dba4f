"""The control of ``correct`` at a size a test run holds: the reference
in TF32 in the program's place reads far above (30 times and more) the
program's own float64 answers on the CPU.  On the card,
``gpbench/control.py`` reads both at the cells' own sizes; there the
harness's own gate must pass the program and fail the control."""

import pytest
from gpbench_toy import REPO, spec, toy_checkout

from gpbench import control

SEEDS = (2 ** 31 + 3, 11)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    return toy_checkout(tmp_path_factory.mktemp("toyctl"))


@pytest.fixture(autouse=True)
def _one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["dense-train", "dense-predict",
                                  "gp2scale-train"])
@pytest.mark.parametrize("seed", SEEDS)
def test_control_reads_far_above_the_program(toy, name, seed):
    r = control.read(spec(toy), name, seed, 0.3, "cpu")
    for k, ctl in r["control"].items():
        assert ctl > 30 * max(r["program"][k], 1e-16), (k, r)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dense-train", "dense-predict",
                                  "gp2scale-train"])
def test_control_fails_the_cell_gate_on_the_card(card, name):
    r = control.read(spec(REPO), name, SEEDS[0], 2.0, "cuda")
    assert r["program_correct"] is True, r
    assert r["control_correct"] is False, r


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
