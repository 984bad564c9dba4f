"""The operation and byte formulas of gpbench/counts against hand counts."""

import importlib

import pytest
from gpbench_toy import REPO  # noqa: F401


def _count(name):
    return importlib.import_module(f"gpbench.counts.{name}")


def test_k1_hand_count():
    k1 = _count("k1")
    # 2 tiles of 32x32 float32, 3 blocks, k = 2 columns
    by_hand = 2 * 32 * 32 * 4 + 2 * 4 + 4 * 4 + 3 * 32 * 2 * 4 \
        + 3 * 32 * 2 * 4
    assert k1.launch_bytes(2, 3, 32, 2, "float32") == by_hand
    assert k1.launch_ops(2, 32, 2) == 2 * 2 * 32 * 32 * 2
    # bf16 tiles and X take two bytes
    assert k1.launch_bytes(2, 3, 32, 2, "bfloat16") == \
        2 * 32 * 32 * 2 + 2 * 4 + 4 * 4 + 3 * 32 * 2 * 2 + 3 * 32 * 2 * 4


def test_k1_bound_at_the_cell_shape():
    """219,631 float32 tiles of 128²: the bytes bound it (14.4 GB at 3.35
    TB/s is 4.3 ms; 3 × 2 · 3.6e9 · 17 at 495 TFLOP/s is 0.74 ms)."""
    k1 = _count("k1")
    t = k1.bound_s(219_631, 7_813, 128, 17, "float32")
    assert t == pytest.approx(k1.launch_bytes(219_631, 7_813, 128, 17,
                                              "float32") / 3.35e12)
    assert 4.2e-3 < t < 4.5e-3


def test_k3_hand_count():
    k3 = _count("k3")
    # 4 x 3 block, D = 2, float32: bytes (4 + 3)·2·4 + 3·4 + 12·4
    assert k3.bound_s(4, 3, 2) == pytest.approx(
        max(((4 + 3) * 2 * 4 + 3 * 4 + 12 * 4) / 3.35e12,
            12 * (3 * 2 + 7) / 67e12))
    # the dense cell's largest request is bound by its output write
    assert k3.bound_s(10_000, 1024, 3) == pytest.approx(
        (11_024 * 3 * 4 + 16 + 10_000 * 1024 * 4) / 3.35e12)


def test_dense_step_and_request_counts():
    dense = _count("lml_grad_dense")
    N, D = 10, 3
    assert dense.ops(N, D) == pytest.approx(
        N ** 3 + 2 * N * N + N * N * (4 * D + 6 + (D + 1) * 4))
    pred = _count("predict_dense")
    assert pred.ops(10, 2, 3) == 10 * 2 * 18 + 2 * 10 * 2 + 100 * 2 \
        + 2 * 10 * 2


def test_gp2scale_step_count():
    g = _count("lml_grad_gp2scale")
    assert g.element_ops(3) == 9 + 2 + 1 + 14
    tiles, nb, B, D, P, it = 5, 2, 4, 3, 2, 3
    fwd = 26
    bwd = fwd + 12 + 6 + 1 + 8
    k = 3
    elems = 5 * 16
    want = elems * (fwd + bwd) + it * (2 * elems * k + 2 * nb * 16 * k) \
        + 2 * elems * k + nb * (16 * fwd + 64 / 3 + 64)
    assert g.ops(tiles, nb, B, D, P, it) == pytest.approx(want)


def test_peaks_are_the_published_ones():
    p = _count("peaks")
    assert p.PEAK_FLOPS == {"bfloat16": 989e12, "tf32": 495e12,
                            "float32": 67e12, "float64": 34e12}
    assert p.HBM_BYTES_PER_S == 3.35e12


def test_cell_level_counts_read_the_configuration():
    cfg = {"data": {"n": 10, "dim": 3}}
    dense, pred = _count("lml_grad_dense"), _count("predict_dense")
    assert dense.step_ops(cfg, None) == dense.ops(10, 3)
    assert pred.request_ops(cfg, {"xq": [[0.0] * 3] * 2}) == \
        pred.ops(10, 2, 3)

    class Structure:
        def live_tiles(self, h):
            assert list(h) == [1.0, 2.0, 2.0, 2.0]
            return 5

    g = _count("lml_grad_gp2scale")
    gcfg = {"data": {"n": 8, "dim": 3},
            "gp": {"init_hyperparameters": [1.0, 2.0, 2.0, 2.0],
                   "args": {"gp2Scale_block_size": 4,
                            "random_logdet_fixed_probes": 2,
                            "sparse_cg_maxiter": 3}}}
    assert g.step_ops(gcfg, Structure()) == g.ops(5, 2, 4, 3, 2, 3)
