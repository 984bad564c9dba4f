"""The two gp2Scale training cells that the benchmark's float32
gp2scale-train leaves out, on the CPU at small N with seeded data.

* gp2scale-bf16-train (configuration ``gp2scale-wendland-1m-bf16``): the
  port's bfloat16 LML and gradient land within the cell's limits of the
  exact reference (``gpbench/reference/gp2scale_bf16_lml_grad.py``), and
  its control, the reference with every tile value and product operand in
  FP8 E4M3, lands outside them; the E4M3 rounding on hand-worked cases;
  the bfloat16 exit floor's default, and the counter of solves that stop
  at it.
* gp2scale-train-far (traffic ``lml-walk-far``): every request leaves the
  drift band of the one before; a model walked through far steps gives,
  in float64, what a fresh model gives at each step; the structure
  counters count one cold pass and one schedule per far step, and none
  inside the band."""

import itertools
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fvgp_tpu_torch import GP
from fvgp_tpu_torch.ops.sparse_lml import _freeze_tol_sq
from fvgp_tpu_torch.utils import trace

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from gpbench.harness.inputs import Traffic, make_data, rng  # noqa: E402
from gpbench.harness.spec import Spec  # noqa: E402
from gpbench.reference import gp2scale_bf16_lml_grad  # noqa: E402
from gpbench.reference.gp2scale_bf16 import round_e4m3  # noqa: E402

SPEC = Spec(REPO)
BF16_CELL = json.loads((REPO / "gpbench/cells/gp2scale-bf16-train.json")
                       .read_text())


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(name, n):
    """The benchmark configuration ``name`` at ``n`` points, its box cut
    to keep ~40 points inside each point's support at lengthscale 2."""
    cfg = SPEC.config(name)
    cfg["data"]["n"] = n
    cfg["data"]["box"] = [0.0, (n * 4.19 * 8 / 40) ** (1 / 3)]
    return cfg


def _gp(cfg, data, **args):
    gp = dict(cfg["gp"])
    h0 = np.asarray(gp.pop("init_hyperparameters"), float)
    gp["args"] = {**gp["args"], **args}
    return GP(data["x"], data["y"], init_hyperparameters=h0,
              noise_variances=data["noise"], compute_device="cpu", **gp)


def _rel(answer, ref):
    (v, g), (rv, rg) = answer, ref
    return {"lml_rel": abs(v - rv) / abs(rv),
            "grad_rel": float(np.max(np.abs(np.asarray(g) - rg))
                              / np.max(np.abs(rg)))}


def _worst(rels):
    return {k: max(r[k] for r in rels) for k in rels[0]}


# -- gp2scale-bf16-train -------------------------------------------------

def test_bf16_program_within_the_limits_and_e4m3_control_outside():
    """The card's precisions on the CPU: bfloat16 tiles and float32
    vectors.  Among the steps, a signal variance just short of a bfloat16
    rounding midpoint, where the program's error is largest."""
    cfg = _config("gp2scale-wendland-1m-bf16", 2000)
    data = make_data(SPEC, cfg, 2 ** 31 + 21)
    h0 = np.asarray(cfg["gp"]["init_hyperparameters"], float)
    hs = [h0 * np.exp(rng(5, 1).uniform(-0.03, 0.03, 4)),
          np.r_[1.0 + 2 ** -8 * 0.999, h0[1:]]]
    model = _gp(cfg, data, dtype="float32").marginal_likelihood
    model.log_likelihood_value_and_gradient(h0)
    got = [model.log_likelihood_value_and_gradient(h) for h in hs]
    calls = [1, 2]
    exact = gp2scale_bf16_lml_grad.make(cfg, data, "cpu").lml_grads(hs,
                                                                    calls)
    ctl = gp2scale_bf16_lml_grad.make(cfg, data, "cpu", "tf32").lml_grads(
        hs, calls)
    limits = BF16_CELL["limits"]
    program = _worst([_rel(a, e) for a, e in zip(got, exact)])
    control = _worst([_rel(c, e) for c, e in zip(ctl, exact)])
    assert all(program[k] <= limits[k] for k in limits), (program, limits)
    assert any(control[k] > limits[k] for k in limits), (control, limits)


def test_e4m3_rounding_by_hand():
    """Round to nearest, ties to even; ±448 saturation; subnormals of step
    2⁻⁹ below the least normal 2⁻⁶; NaN kept; float64 in, float64 out."""
    cases = [
        (1.0, 1.0), (1.0625, 1.0),          # a tie between 1 and 1.125: even
        (1.1875, 1.25),                     # a tie between 1.125, 1.25: even
        (1.07, 1.125), (-1.07, -1.125), (0.3, 0.3125),
        (240.0, 240.0), (250.0, 256.0), (448.0, 448.0),
        (460.0, 448.0), (1e6, 448.0), (-1e6, -448.0),
        (2 ** -6, 2 ** -6), (2 ** -6 * 1.0625, 2 ** -6),  # least normal
        (2 ** -9, 2 ** -9), (3 * 2 ** -10, 2 ** -8),      # subnormal tie
        (2 ** -10, 0.0), (1.5 * 2 ** -10, 2 ** -9),       # tie to 0 / up
        (7 * 2 ** -9, 7 * 2 ** -9), (0.0, 0.0)]
    for dtype in (torch.float32, torch.float64):
        t = torch.tensor([c[0] for c in cases], dtype=dtype)
        got = round_e4m3(t)
        assert got.dtype == dtype
        assert got.tolist() == [c[1] for c in cases]
    assert torch.isnan(round_e4m3(torch.tensor([float("nan")]))).all()
    # every E4M3 value is its own rounding
    mant = torch.arange(8, dtype=torch.float64) / 8
    normals = torch.cat([(1 + mant) * 2.0 ** e for e in range(-6, 9)])
    values = torch.cat([mant * 2.0 ** -6, normals[normals <= 448]])
    assert torch.equal(round_e4m3(values), values)


def test_bf16_exit_floor_default_and_the_others_unchanged():
    assert _freeze_tol_sq(None, torch.bfloat16, torch.float32) == 2.5e-3
    assert _freeze_tol_sq(None, torch.float16, torch.float32) == 2.5e-3
    assert _freeze_tol_sq(None, None, torch.float32) == 1e-8
    assert _freeze_tol_sq(None, torch.float32, torch.float32) == 1e-8
    assert _freeze_tol_sq(None, None, torch.float64) == 1e-14
    assert _freeze_tol_sq(1e-3, torch.bfloat16, torch.float32) == \
        pytest.approx(1e-6)
    cfg = SPEC.config("gp2scale-wendland-1m-bf16")
    assert "sparse_cg_tol" not in cfg["gp"]["args"]
    assert cfg["cg_exit_floor_sq"] == _freeze_tol_sq(None, torch.bfloat16,
                                                     torch.float32)


def test_mbcg_floor_exits_counts_solves_stopped_at_the_floor():
    cfg = _config("gp2scale-wendland-1m-bf16", 1200)
    data = make_data(SPEC, cfg, 7)
    h0 = np.asarray(cfg["gp"]["init_hyperparameters"], float)
    for args, exits in (({}, 1), ({"sparse_cg_tol": 0.0}, 0)):
        ml = _gp(cfg, data, dtype="float32", **args).marginal_likelihood
        before = trace.counters()
        ml.log_likelihood_value_and_gradient(h0)
        after = trace.counters()
        trips = after["mbcg_iterations"] - before.get("mbcg_iterations", 0)
        assert after.get("mbcg_floor_exits", 0) \
            - before.get("mbcg_floor_exits", 0) == exits
        assert (trips < 32) == bool(exits)


# -- gp2scale-train-far --------------------------------------------------

FAR = SPEC.traffic("lml-walk-far")
FAR_OP = SPEC.op(FAR["op"])


def _outside(h, prev, drift=0.05):
    return int(np.sum(np.abs(h[1:] / prev[1:] - 1.0) > drift))


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 5, 2 ** 40 + 3])
def test_far_requests_leave_the_band_and_never_repeat(seed):
    cfg = SPEC.config("gp2scale-wendland-1m")
    t = Traffic(FAR, cfg, seed, FAR_OP)
    h0 = np.asarray(cfg["gp"]["init_hyperparameters"], float)
    steps = t.warmup() + list(itertools.islice(iter(t), 300))
    assert np.array_equal(steps[0]["h"], h0)
    perms = {tuple(p) for p in FAR_OP.permutations(FAR)}
    assert len(perms) == 6
    prev = h0
    orders = []
    for r in steps[1:]:
        u = np.log(r["h"] / h0)
        assert abs(u[0]) <= FAR["variance_half_width"]
        assert tuple(np.round(u[1:], 12)) in {
            tuple(np.round(p, 12)) for p in perms}
        # at constant support volume
        assert abs(np.sum(u[1:])) < 1e-12
        assert _outside(r["h"], prev) >= 2
        orders.append(tuple(np.round(u[1:], 12)))
        prev = r["h"]
    assert all(a != b for a, b in zip(orders, orders[1:]))
    assert len(set(orders)) == 6


def test_far_steps_equal_a_fresh_model_and_count_their_passes():
    """float64 on the CPU: a model walked from h0 through far steps gives
    at each step, to 1e-10, what a fresh model gives there on the same
    probes (its evaluation of the same index).  Each far step runs one
    cold structure pass and one new schedule; a step inside the band
    neither.  Blocks of 32 points, so that (as at the cell's size) the
    live tiles differ from step to step."""
    cfg = _config("gp2scale-wendland-1m", 1500)
    cfg["gp"]["args"]["gp2Scale_block_size"] = 32
    data = make_data(SPEC, cfg, 2 ** 33 + 1)
    walk = Traffic(FAR, cfg, 11, FAR_OP)
    hs = [r["h"] for r in walk.warmup()][1:] + \
        [r["h"] for r in itertools.islice(iter(walk), 2)]
    h0 = np.asarray(cfg["gp"]["init_hyperparameters"], float)
    ml = _gp(cfg, data).marginal_likelihood
    ml.log_likelihood_value_and_gradient(h0)

    def moved(fn):
        before = trace.counters()
        out = fn()
        after = trace.counters()
        return out, {k: after.get(k, 0) - before.get(k, 0)
                     for k in ("structure_passes", "schedule_rebuilds")}

    walked = []
    for h in hs:
        out, n = moved(lambda h=h: ml.log_likelihood_value_and_gradient(h))
        assert n == {"structure_passes": 1, "schedule_rebuilds": 1}
        walked.append(out)
    _, n = moved(lambda: ml.log_likelihood_value_and_gradient(
        hs[-1] * np.exp([0.01, 0.02, -0.02, 0.01])))
    assert n == {"structure_passes": 0, "schedule_rebuilds": 0}
    for i, (h, (v, g)) in enumerate(zip(hs, walked), start=1):
        fresh = _gp(cfg, data).marginal_likelihood
        for _ in range(i + 1):      # its i-th evaluation draws walk's probes
            fv, fg = fresh.log_likelihood_value_and_gradient(h)
        assert abs(v - fv) <= 1e-10 * abs(fv)
        assert np.max(np.abs(g - fg)) <= 1e-10 * np.max(np.abs(fg))


def test_a_new_schedule_has_its_span_inside_the_structure_check():
    from torch.profiler import ProfilerActivity, profile
    cfg = _config("gp2scale-wendland-1m", 1200)
    cfg["gp"]["args"]["gp2Scale_block_size"] = 32
    data = make_data(SPEC, cfg, 3)
    ml = _gp(cfg, data).marginal_likelihood
    h0 = np.asarray(cfg["gp"]["init_hyperparameters"], float)
    ml.log_likelihood_value_and_gradient(h0)

    def spans(h):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            ml.log_likelihood_value_and_gradient(h)
        return [(e.name(), e.start_ns(), e.end_ns())
                for e in prof.profiler.kineto_results.events()
                if e.name().startswith("fvgp.sparse_lml.s")]

    far = spans(h0 * np.exp([0.0, 0.1, 0.0, -0.1]))
    names = [n for n, _, _ in far]
    assert names.count("fvgp.sparse_lml.schedule") == 1
    (_, s0, e0), = [t for t in far if t[0] == "fvgp.sparse_lml.structure"]
    (_, s1, e1), = [t for t in far if t[0] == "fvgp.sparse_lml.schedule"]
    assert s0 <= s1 <= e1 <= e0
    near = spans(h0 * np.exp([0.0, 0.11, 0.0, -0.1]))
    assert "fvgp.sparse_lml.schedule" not in [n for n, _, _ in near]


def test_in_band_structure_is_the_last_one_until_a_cache_moves(
        monkeypatch):
    """Inside the drift band, with neither the candidates nor the dead set
    recomputed, ``TileStructure.training`` filters the cached candidates by
    the cached dead pairs: the same structure as the pass that made them,
    under the same stamp.  Given that stamp, it runs no filter and gives
    None: the caller's structure stands.  A step out of the band makes a
    new structure and stamp, which steps inside its own band keep."""
    cfg = _config("gp2scale-wendland-1m", 1500)
    cfg["gp"]["args"]["gp2Scale_block_size"] = 32
    data = make_data(SPEC, cfg, 5)
    gp = _gp(cfg, data)
    tiles = gp.marginal_likelihood.data.tile_structure
    h0 = np.asarray(cfg["gp"]["init_hyperparameters"], float)
    ls0, radius = tiles.support(gp.prior, h0)
    nb = -(-1500 // 32)
    filters = []
    isin = np.isin
    monkeypatch.setattr(np, "isin", lambda *a, **k: filters.append(1)
                        or isin(*a, **k))

    def passes(ls, since=None):
        before = trace.counters().get("structure_passes", 0)
        out = tiles.training(ls, radius, 32, nb, since=since)
        return out, trace.counters()["structure_passes"] - before

    first, n = passes(ls0)
    assert n == 1
    near, n = passes(ls0 * 1.02)
    assert n == 0 and filters == [1] and near[2] == first[2]
    assert np.array_equal(near[0], first[0])
    assert np.array_equal(near[1], first[1])
    assert passes(ls0 * 0.98, since=first[2]) == ((None, None, first[2]), 0)
    assert filters == [1]
    ls_far = ls0 * np.exp([0.1, 0.0, -0.1])
    far, n = passes(ls_far, since=first[2])
    assert n == 1 and far[2] != first[2]
    assert not (len(far[0]) == len(first[0])
                and np.array_equal(far[0], first[0])
                and np.array_equal(far[1], first[1]))
    again, n = passes(ls_far * 1.01, since=first[2])
    assert n == 0 and again[2] == far[2]
    assert np.array_equal(again[0], far[0])
    assert np.array_equal(again[1], far[1])
    assert passes(ls_far * 1.01, since=far[2])[0] == (None, None, far[2])
    # unfiltered, no stamp to keep
    monkeypatch.setitem(tiles.data.args, "gp2Scale_tile_filter", False)
    rows, cols, stamp = tiles.training(ls_far, radius, 32, nb, since=far[2])
    assert stamp is None and len(rows) > len(far[0])


def test_in_band_steps_keep_the_schedule_without_the_filter(monkeypatch):
    """The LML's in-band steps run neither the dead-pair filter nor the
    schedule comparison (the stamp stands), and give what a model that
    filters and compares at every step gives, in float64 on the same
    probes."""
    cfg = _config("gp2scale-wendland-1m", 1500)
    cfg["gp"]["args"]["gp2Scale_block_size"] = 32
    data = make_data(SPEC, cfg, 9)
    h0 = np.asarray(cfg["gp"]["init_hyperparameters"], float)
    hs = [h0 * np.exp(u) for u in ([0.0, 0.0, 0.0, 0.0],
                                   [0.01, 0.02, -0.02, 0.01],
                                   [-0.02, -0.01, 0.03, 0.02])]
    ml = _gp(cfg, data).marginal_likelihood
    filters, equal = [], []
    isin, array_equal = np.isin, np.array_equal
    monkeypatch.setattr(np, "isin", lambda *a, **k: filters.append(1)
                        or isin(*a, **k))
    monkeypatch.setattr(np, "array_equal", lambda *a, **k: equal.append(1)
                        or array_equal(*a, **k))
    got = [ml.log_likelihood_value_and_gradient(h) for h in hs]
    assert filters == [] and equal == []
    monkeypatch.undo()
    ref = _gp(cfg, data).marginal_likelihood
    tiles = ref.data.tile_structure
    training = tiles.training
    monkeypatch.setattr(tiles, "training",
                        lambda *a, since=None: training(*a))
    for (v, g), h in zip(got, hs):
        rv, rg = ref.log_likelihood_value_and_gradient(h)
        assert v == rv and np.array_equal(g, rg)
