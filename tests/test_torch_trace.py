"""The port's spans and counters (``fvgp_tpu_torch.utils.trace``): the
documented spans appear in a ``torch.profiler`` trace with their nesting,
the counters count what they name, and with no profiler recording a span
never opens a ``record_function`` range."""

import logging
import warnings

import numpy as np
import pytest
import torch

import fvgp_tpu_torch.ops.sparse_lml as SL
from fvgp_tpu_torch import GP
from fvgp_tpu_torch.utils import logging as flog
from fvgp_tpu_torch.utils import log_time, phase_timer, trace

H_DENSE = np.array([1.0, 1.5, 1.5])
H_SPARSE = np.array([1.0, 2.0, 2.0, 2.0])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (the suite's parallel
    workers would oversubscribe the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _dense_gp():
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 10, (120, 2))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return GP(x, np.sin(x[:, 0]), init_hyperparameters=H_DENSE,
                  noise_variances=np.full(120, 1e-2), compute_device="cpu")


def _sparse_gp(args=None):
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 16, (2000, 3))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return GP(x, np.sin(x[:, 0]), init_hyperparameters=H_SPARSE,
                  gp2Scale=True, noise_variances=np.full(2000, 1e-2),
                  linalg_mode="sparseCGpre", compute_device="cpu",
                  args={"gp2Scale_block_size": 64, **(args or {})})


def _spans(fn):
    """[(name, start_ns, end_ns)] of the ``fvgp.*`` spans while ``fn``
    runs under the profiler, in order of start."""
    with torch.profiler.profile() as prof:
        fn()
    out = [(e.name(), int(e.start_ns()), int(e.end_ns()))
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith("fvgp.")]
    return sorted(out, key=lambda s: s[1])


def _names(spans):
    return [n for n, _, _ in spans]


def _inside(spans, child, parent):
    """Every ``child`` span lies inside some ``parent`` span."""
    ps = [(s, e) for n, s, e in spans if n == parent]
    cs = [(s, e) for n, s, e in spans if n == child]
    return bool(cs) and all(any(ps_ <= s and e <= pe for ps_, pe in ps)
                            for s, e in cs)


def _disjoint(spans, a, b):
    """No ``a`` span overlaps a ``b`` span."""
    return all(e1 <= s2 or e2 <= s1
               for n1, s1, e1 in spans if n1 == a
               for n2, s2, e2 in spans if n2 == b)


def _syncs(fn):
    before = trace.counters().get("host_syncs", 0)
    fn()
    return trace.counters().get("host_syncs", 0) - before


def test_dense_lml_spans_and_syncs():
    """One dense LML + gradient: a forward then a backward span, the
    gradient's host copy after both; three host syncs (the factor's info,
    the value, the gradient)."""
    gp = _dense_gp()
    ml = gp.marginal_likelihood
    ml.log_likelihood_value_and_gradient(H_DENSE)
    spans = _spans(lambda: ml.log_likelihood_value_and_gradient(
        H_DENSE * 1.01))
    assert _names(spans) == ["fvgp.dense_lml.forward",
                             "fvgp.dense_lml.backward", "fvgp.to_host"]
    (_, _, f_end), (_, b_start, b_end), (_, h_start, _) = spans
    assert f_end <= b_start and b_end <= h_start
    assert _syncs(lambda: ml.log_likelihood_value_and_gradient(
        H_DENSE * 1.02)) == 3


def test_posterior_spans_and_syncs():
    """``posterior_mean`` then ``posterior_covariance(variance_only=True)``:
    each checks its inputs first, K3's cross-covariance is computed once
    (the memo serves the variance), the prior and the solve follow, each
    answer leaves through ``fvgp.to_host``; three host syncs in all (the
    mean's product and prior mean, the variance's S)."""
    gp = _dense_gp()
    xp = np.random.default_rng(2).uniform(0, 10, (25, 2))

    def call():
        gp.posterior_mean(xp)
        gp.posterior_covariance(xp, variance_only=True)

    spans = _spans(call)
    assert _names(spans) == [
        "fvgp.posterior.inputs", "fvgp.posterior.cross_cov",
        "fvgp.posterior.solve", "fvgp.to_host", "fvgp.posterior.prior",
        "fvgp.to_host",
        "fvgp.posterior.inputs", "fvgp.posterior.cross_cov",
        "fvgp.posterior.prior", "fvgp.posterior.solve", "fvgp.to_host"]
    for a in ("fvgp.posterior.inputs", "fvgp.posterior.cross_cov",
              "fvgp.posterior.prior"):
        assert _disjoint(spans, a, "fvgp.posterior.solve")
        assert _disjoint(spans, a, "fvgp.to_host")
    assert _syncs(call) == 3


def test_gp2scale_mean_sweep_has_its_own_span():
    """Above its batch size a gp2Scale model's ``posterior_mean`` fuses
    kᵀ(K+V)⁻¹(y − m) into the chunked kernel sweep, marked
    ``fvgp.posterior.cross_sweep`` inside ``fvgp.posterior.cross_cov``;
    the variance's build of k(X, x*) is a ``cross_cov`` of its own and
    holds no sweep."""
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 16, (2000, 3))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        gp = GP(x, np.sin(x[:, 0]), init_hyperparameters=H_SPARSE,
                gp2Scale=True, gp2Scale_batch_size=1000,
                noise_variances=np.full(2000, 1e-2),
                linalg_mode="sparseCGpre", compute_device="cpu",
                args={"gp2Scale_block_size": 64,
                      "gp2Scale_structure_cache_dir": False})
    xp = rng.uniform(0, 16, (20, 3))
    gp.posterior_mean(xp + 1.0)        # the commit's solve, off the trace
    mean = _spans(lambda: gp.posterior_mean(xp))
    assert _names(mean).count("fvgp.posterior.cross_sweep") == 1
    assert _inside(mean, "fvgp.posterior.cross_sweep",
                   "fvgp.posterior.cross_cov")
    var = _spans(lambda: gp.posterior_covariance(xp, variance_only=True))
    assert "fvgp.posterior.cross_cov" in _names(var)
    assert "fvgp.posterior.cross_sweep" not in _names(var)
    assert gp.kv.last_solve_info["method"] == "committed_pcg"


def test_gp2scale_lml_spans_nesting_and_counters():
    """A gp2Scale LML + gradient at N = 2,000: the structure pass (its
    cache-miss phases inside it on the first call only), the probe draw,
    assembly, preconditioner and mBCG solve, then the backward with the
    mBCG's and the assembly's backward inside it.  Host syncs: one per
    exit test of the mBCG loop (its trips, plus the test that ended it
    where it ended before the cap) and three (the estimator's variance,
    the value, the gradient)."""
    gp = _sparse_gp()
    ml = gp.marginal_likelihood
    cold = _spans(lambda: ml.log_likelihood_value_and_gradient(H_SPARSE))
    for child in ("fvgp.sparse_lml.candidates",
                  "fvgp.sparse_lml.padded_inputs",
                  "fvgp.sparse_lml.liveness"):
        assert _inside(cold, child, "fvgp.sparse_lml.structure"), child

    before = trace.counters()
    warm = _spans(lambda: ml.log_likelihood_value_and_gradient(
        H_SPARSE * 1.01))
    after = trace.counters()
    assert _names(warm) == [
        "fvgp.sparse_lml.structure", "fvgp.sparse_lml.probes",
        "fvgp.sparse_lml.assemble", "fvgp.sparse_lml.precond",
        "fvgp.sparse_lml.mbcg", "fvgp.sparse_lml.backward",
        "fvgp.sparse_lml.mbcg_bwd", "fvgp.sparse_lml.assemble_bwd",
        "fvgp.to_host"]
    for child in ("fvgp.sparse_lml.mbcg_bwd", "fvgp.sparse_lml.assemble_bwd"):
        assert _inside(warm, child, "fvgp.sparse_lml.backward")
    for a in ("fvgp.sparse_lml.structure", "fvgp.sparse_lml.probes",
              "fvgp.sparse_lml.assemble", "fvgp.sparse_lml.mbcg"):
        assert _disjoint(warm, a, "fvgp.sparse_lml.backward")
    trips = after["mbcg_iterations"] - before.get("mbcg_iterations", 0)
    cap = ml._sparse_settings()["cg_iters"]
    assert 0 < trips <= cap
    tests = trips + (trips < cap)
    assert after["host_syncs"] - before["host_syncs"] == tests + 3


def test_mbcg_iterations_count_the_trips(monkeypatch):
    """With a loose ``sparse_cg_tol`` the mBCG loop exits before its cap;
    ``mbcg_iterations`` advances by the trips it ran, read off the
    coefficients it recorded (an executed trip writes CG coefficients, an
    unexecuted one keeps the pre-filled alpha = 1)."""
    gp = _sparse_gp({"sparse_cg_tol": 1e-2})
    ml = gp.marginal_likelihood
    seen = []
    inner = SL._pcg_coeffs

    def recording(*a, **k):
        out = inner(*a, **k)
        seen.append(int(torch.any(out[1] != 1.0, dim=1).sum()))
        return out

    monkeypatch.setattr(SL, "_pcg_coeffs", recording)
    before = trace.counters().get("mbcg_iterations", 0)
    ml.log_likelihood_value_and_gradient(H_SPARSE)
    ran = trace.counters()["mbcg_iterations"] - before
    assert len(seen) == 1 and ran == seen[0]
    assert 0 < ran < ml._sparse_settings()["cg_iters"]


def test_cg_iterations_count_the_trips():
    """``cg_iterations`` advances by the trip count ``_cg_fixed``
    returns; each exit test is one host sync."""
    rng = np.random.default_rng(3)
    A = rng.standard_normal((40, 40))
    A = torch.as_tensor(A @ A.T + 40 * np.eye(40))
    b = torch.as_tensor(rng.standard_normal((40, 2)))
    before = trace.counters()
    X, it = SL._cg_fixed(lambda v: A @ v, b, 30, tol=1e-6, with_iters=True)
    after = trace.counters()
    assert 0 < it < 30
    assert after["cg_iterations"] - before.get("cg_iterations", 0) == it
    assert after["host_syncs"] - before.get("host_syncs", 0) == it + 1
    assert torch.allclose(A @ X, b, atol=1e-4)


def test_span_without_profiler_never_opens_a_range(monkeypatch):
    """With no profiler recording a span is one check: a
    ``record_function`` that raises is never reached, through a whole
    dense LML + gradient and a prediction; under the profiler it is."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) opened")

    monkeypatch.setattr(trace, "record_function", refuse)
    gp = _dense_gp()
    gp.marginal_likelihood.log_likelihood_value_and_gradient(H_DENSE)
    gp.posterior_covariance(np.zeros((3, 2)), variance_only=True)
    with trace.span("fvgp.unit"):
        pass
    with pytest.raises(AssertionError, match="fvgp.unit"):
        with torch.profiler.profile():
            with trace.span("fvgp.unit"):
                pass


def test_counters_copy_and_reset():
    """``counters()`` is a copy; ``count`` adds; ``reset`` clears."""
    trace.count("unit_counter", 2)
    trace.count("unit_counter")
    snap = trace.counters()
    assert snap["unit_counter"] >= 3
    snap["unit_counter"] = -1
    assert trace.counters()["unit_counter"] >= 3
    trace.reset()
    assert "unit_counter" not in trace.counters()


def test_phase_timer_and_log_time_are_spans(capsys):
    """``phase_timer`` keeps its debug line and ``log_time`` its totals;
    both are spans of ``utils.trace`` under their labels."""
    flog.enable()
    try:
        with phase_timer("fvgp.unit_phase"):
            pass
        assert "fvgp.unit_phase: " in capsys.readouterr().err
    finally:
        flog.disable()
    assert not flog.logger.isEnabledFor(logging.DEBUG)

    def both():
        with phase_timer("fvgp.unit_phase"):
            with log_time("fvgp.unit_block"):
                pass

    spans = _spans(both)
    assert _inside(spans, "fvgp.unit_block", "fvgp.unit_phase")
