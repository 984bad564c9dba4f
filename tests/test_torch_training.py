"""The training methods of the public GP: the same seeded data through the
JAX ``GP`` and the port's ``GP`` (CPU, float64) — the Hessian-using local
optimizers, the batched value-and-gradient, ``hgdl`` (lockstep phase and
polish), ``adam`` (host loop; the gp2Scale device chain at injected probes),
``bo`` (the run, its acquisition and its Laplace curvature), a callable
method, and the asynchronous actors' polling contract.  Each tolerance is
stated where it is used."""

import pickle
import time
import warnings

import numpy as np
import pytest
import torch

import fvgp_tpu_torch.models.gp_marginal_likelihood as TML
from fvgp_tpu import GP as JaxGP
from fvgp_tpu_torch import GP

N = 50
BOUNDS = np.array([[0.05, 20.0], [0.2, 20.0], [0.2, 20.0]])
H0 = np.array([1.0, 1.5, 1.5])


def _data():
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 6, (N, 2))
    y = np.sin(x[:, 0]) + np.cos(x[:, 1]) + 0.1 * rng.standard_normal(N)
    return x, y


def _pair(h0=H0):
    """(JAX GP, port GP) on the same data and start."""
    x, y = _data()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (JaxGP(x, y, init_hyperparameters=h0,
                      noise_variances=np.full(N, 1e-2)),
                GP(x, y, init_hyperparameters=h0,
                   noise_variances=np.full(N, 1e-2), compute_device="cpu"))


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=tol, atol=tol)


def _train(gp, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return gp.train(hyperparameter_bounds=BOUNDS, **kw)


def test_local_hessian_optimizer_matches_jax():
    """``trust-exact`` runs on the LML Hessian, the facade's default, in
    both packages (equal to 1e-8)."""
    start = np.array([4.30417494, 5.79590577, 7.0112561])  # 1.3 x optimum
    jgp, tgp = _pair(start)
    kw = dict(method="local", local_optimizer="trust-exact", max_iter=5)
    ref = _train(jgp, **kw)
    got = _train(tgp, **kw)
    _close(got, ref, 1e-8)
    assert np.abs(got - start).max() > 0.5          # it moved


def test_batched_value_and_grad_matches_jax():
    """Five members, one of them with a negative signal variance (K+V not
    positive definite): values and gradients equal to 1e-10, NaN in the
    same row."""
    jgp, tgp = _pair()
    P = np.array([H0, [2.0, 1.0, 3.0], [-1.0, 1.5, 1.5], [0.5, 4.0, 0.7],
                  [3.0, 2.5, 2.5]])
    jv, jg = jgp.marginal_likelihood.batched_value_and_grad_device()(
        np.asarray(P))
    tv, tg = tgp.marginal_likelihood.batched_value_and_grad_device()(
        torch.as_tensor(P))
    jv, jg, tv, tg = (np.asarray(a) for a in (jv, jg, tv, tg))
    np.testing.assert_array_equal(np.isnan(tv), np.isnan(jv))
    assert np.isnan(tv[2]) and np.isfinite(np.delete(tv, 2)).all()
    ok = np.isfinite(jv)
    _close(tv[ok], jv[ok], 1e-10)
    _close(tg[ok], jg[ok], 1e-10)


def test_hgdl_lockstep_phase_and_polish_match_jax():
    """The lockstep Adam phase's end points and values after 10 epochs
    (1e-8), then ``train(method="hgdl")``'s hyperparameters after the
    polish (1e-6)."""
    jgp, tgp = _pair()
    starts = np.random.default_rng(7).uniform(BOUNDS[:, 0], BOUNDS[:, 1],
                                              (4, 3))
    starts[0] = H0
    out = [gp.trainer._device_multistart_phase(
        gp.marginal_likelihood.batched_value_and_grad_device(), BOUNDS,
        starts, epochs=10) for gp in (jgp, tgp)]
    _close(out[1][0], out[0][0], 1e-8)
    _close(out[1][1], out[0][1], 1e-8)
    assert np.abs(out[1][0] - starts).max() > 0.1
    kw = dict(method="hgdl", pop_size=4, max_iter=10)
    _close(_train(tgp, **kw), _train(jgp, **kw), 1e-6)
    _close(tgp.hyperparameters, jgp.hyperparameters, 1e-6)


def test_hgdl_with_a_user_objective_polishes_every_start():
    """A user objective and gradient: no lockstep phase, every start is
    polished in turn (1e-8); without a gradient the facade raises."""
    target = np.array([1.0, 2.0, 3.0])

    def obj(h):
        return float(np.sum((h - target) ** 2))

    def grad(h):
        return 2.0 * (h - target)

    out = [_train(gp, method="hgdl", pop_size=4, max_iter=40,
                  objective_function=obj, objective_function_gradient=grad)
           for gp in _pair()]
    _close(out[1], out[0], 1e-8)
    _close(out[1], target, 1e-5)
    with pytest.raises(Exception, match="gradient"):
        _train(_pair()[1], method="hgdl", objective_function=obj)


def test_adam_matches_jax():
    """The host Adam over the fused value-and-gradient, 30 steps (1e-8)."""
    jgp, tgp = _pair()
    kw = dict(method="adam", max_iter=30)
    _close(_train(tgp, **kw), _train(jgp, **kw), 1e-8)


def test_adam_chain_respects_small_max_iter():
    """max_iter < adam_chain_steps: one chunk of max_iter steps, never more
    (the JAX package's test of the same name)."""
    x, y = _data()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        gp = GP(x, y, init_hyperparameters=H0, compute_device="cpu",
                args={"adam_chain_steps": 8})
    seen = []

    def fake_chain(theta, m, v, t, k, bounds):
        seen.append((t, k))
        return theta + 0.1, m, v, np.zeros(k)

    for max_iter, chunks in ((3, [(0, 3)]), (17, [(0, 8), (8, 8)])):
        seen.clear()
        gp.trainer.train(objective_function=lambda h: 0.0,
                         objective_function_gradient=lambda h: np.zeros(3),
                         hyperparameter_bounds=BOUNDS, init_hyperparameters=H0,
                         method="adam", max_iter=max_iter,
                         adam_chain_runner=fake_chain)
        assert seen == chunks


# ---------------------------------------------------------------------------
# the gp2Scale Adam chain
# ---------------------------------------------------------------------------

SN, SB, SP = 2000, 64, 8
SHPS = np.array([1.0, 2.0, 2.0, 2.0])
SBOUNDS = np.array([[0.05, 5.0], [1.9, 2.1], [1.9, 2.1], [1.9, 2.1]])


def _sparse_model(cls, **kw):
    rng = np.random.default_rng(11)
    x = rng.uniform(0, 18, (SN, 3))
    y = np.sin(0.5 * x[:, 0]) + 0.05 * rng.standard_normal(SN)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return cls(x, y, init_hyperparameters=SHPS,
                   noise_variances=np.full(SN, 1e-2), gp2Scale=True,
                   linalg_mode="sparseCGpre",
                   args={"gp2Scale_block_size": SB,
                         "random_logdet_fixed_probes": SP,
                         "sparse_cg_maxiter": 64}, **kw)


@pytest.fixture(scope="module")
def sparse_gp():
    return _sparse_model(GP, compute_device="cpu")


def test_sparse_adam_chain_matches_jax():
    """Two chunks of two chain steps in both packages: the port is given
    the JAX chain's own probes, ``rademacher(fold_in(fold_in(fold_in(
    PRNGKey(seed), counter), t_start), i))``, through ``probe_source``.
    theta, m, v and the per-step values agree to 1e-10."""
    import jax

    seed, chunks = 3, (0, 2)
    kw = dict(seed=seed, bounds=SBOUNDS)
    jml = _sparse_model(JaxGP).marginal_likelihood
    tml = _sparse_model(GP, compute_device="cpu").marginal_likelihood
    for ml in (jml, tml):
        ml.log_likelihood_value_and_gradient(SHPS)     # builds the program
    jstate = tstate = (SHPS, np.zeros(4), np.zeros(4))
    jf, tf = [], []
    for t_start in chunks:
        jstate = jml.sparse_adam_steps(*jstate[:3], t_start, 2, **kw)
        entry = next(iter(jml._sparse_cache.values()))
        assert entry["chain_ctx"]["nb_eff"] == entry["chain_ctx"]["nb"]
        key = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(seed), entry["counter"]), t_start)
        n_pad = entry["chain_ctx"]["nb"] * SB

        def probes(step, key=key, t_start=t_start, n_pad=n_pad):
            return np.array(jax.random.rademacher(
                jax.random.fold_in(key, step - t_start), (n_pad, SP),
                dtype=np.float64))
        tstate = tml.sparse_adam_steps(*tstate[:3], t_start, 2,
                                       probe_source=probes, **kw)
        jf.append(jstate[3])
        tf.append(tstate[3])
    for got, ref in zip(tstate[:3] + (np.concatenate(tf),),
                        jstate[:3] + (np.concatenate(jf),)):
        _close(got, ref, 1e-10)
    assert np.abs(jstate[0] - SHPS).max() > 0.01


def test_sparse_adam_chain_matches_a_host_loop(sparse_gp, monkeypatch):
    """Four chain steps at injected probes against a host loop of the
    port's own LML value-and-gradient at the same probes followed by the
    JAX chain's Adam arithmetic (1e-10)."""
    ml = sparse_gp.marginal_likelihood
    ml.log_likelihood_value_and_gradient(SHPS)         # builds the program
    entry = next(iter(ml._sparse_cache.values()))
    n_pad = entry["xb"].shape[0] * SB
    rng = np.random.default_rng(4)
    Zs = [rng.choice([-1.0, 1.0], (n_pad, SP)) for _ in range(4)]
    theta, m, v, fvals = ml.sparse_adam_steps(
        SHPS, np.zeros(4), np.zeros(4), 0, 4, bounds=SBOUNDS,
        probe_source=lambda step: Zs[step])

    current = {}
    monkeypatch.setattr(TML, "_rademacher_probes",
                        lambda n, p, dtype, device, generator: torch.as_tensor(
                            current["Z"], dtype=dtype).to(device))
    th, mh_, vh_ = SHPS.copy(), np.zeros(4), np.zeros(4)
    ref_f = []
    lr, b1, b2, eps = 1e-2, 0.9, 0.999, 1e-8
    for i in range(4):
        current["Z"] = Zs[i]
        val, grad = ml.log_likelihood_value_and_gradient(th)
        g = -grad
        t = i + 1
        mh_ = b1 * mh_ + (1.0 - b1) * g
        vh_ = b2 * vh_ + (1.0 - b2) * g * g
        th = np.clip(th - lr * (mh_ / (1.0 - b1 ** t))
                     / (np.sqrt(vh_ / (1.0 - b2 ** t)) + eps),
                     SBOUNDS[:, 0], SBOUNDS[:, 1])
        ref_f.append(-val)
    _close(theta, th, 1e-10)
    _close(m, mh_, 1e-10)
    _close(v, vh_, 1e-10)
    _close(fvals, ref_f, 1e-10)
    assert np.abs(theta - SHPS).max() > 0.01


def test_sparse_adam_chain_draws_fresh_probes_per_absolute_step(
        sparse_gp, monkeypatch):
    """Chunk k+1 does not replay chunk k's probes: every step's generator
    is seeded by the absolute step index, and the same step index draws the
    same probes again."""
    ml = sparse_gp.marginal_likelihood
    drawn = []
    real = TML._rademacher_probes

    def recording(n, p, dtype, device, generator):
        Z = real(n, p, dtype, device, generator)
        drawn.append(Z.clone())
        return Z

    monkeypatch.setattr(TML, "_rademacher_probes", recording)
    state = (SHPS, np.zeros(4), np.zeros(4))
    ml.sparse_adam_steps(*state, 0, 2, bounds=SBOUNDS)
    first = drawn[-2:]
    ml.sparse_adam_steps(*state, 2, 2, bounds=SBOUNDS)
    second = drawn[-2:]
    ml.sparse_adam_steps(*state, 0, 2, bounds=SBOUNDS)
    again = drawn[-2:]
    assert not torch.equal(first[0], second[0])
    assert not torch.equal(first[0], first[1])
    assert torch.equal(first[0], again[0]) and torch.equal(first[1],
                                                           again[1])
    # settings that build another program are not run on the cached one
    sparse_gp.args["random_logdet_fixed_probes"] = 4
    try:
        ml.sparse_adam_steps(*state, 4, 1, bounds=SBOUNDS)
    finally:
        sparse_gp.args["random_logdet_fixed_probes"] = SP
    assert drawn[-1].shape[1] == 4


def test_gp2scale_adam_runs_the_chain_and_bo_stays_off_the_traced_path(
        sparse_gp, monkeypatch):
    """``train(method="adam")`` under gp2Scale runs the device chain in
    full chunks; off the traced path ``"bo"`` is let through (not switched
    to MCMC) on the stored-K LML."""
    calls = []
    real = TML.GPMarginalLikelihood.sparse_adam_steps

    def spy(self, theta, m, v, t, steps, **kw):
        calls.append((t, steps))
        return real(self, theta, m, v, t, steps, **kw)

    monkeypatch.setattr(TML.GPMarginalLikelihood, "sparse_adam_steps", spy)
    sparse_gp.args["adam_chain_steps"] = 2
    try:
        out = sparse_gp.train(hyperparameter_bounds=SBOUNDS, method="adam",
                              max_iter=4)
    finally:
        sparse_gp.args.pop("adam_chain_steps")
    assert calls == [(0, 2), (2, 2)] and np.isfinite(out).all()
    x, y = _data()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        gp = GP(x, y, init_hyperparameters=H0, gp2Scale=True,
                compute_device="cpu", noise_variances=np.full(N, 1e-2),
                args={"gp2Scale_traced_lml": False,
                      "gp2Scale_block_size": 16})
        hps = gp.train(hyperparameter_bounds=BOUNDS, method="bo",
                       max_iter=4, bo_args={"n_init": 3})
    assert not any("switched to MCMC" in str(w.message) for w in rec)
    assert gp.bo_info["n_evaluations"] == 4 and gp.mcmc_info is None
    assert hps.shape == (3,)


# ---------------------------------------------------------------------------
# Bayesian optimization
# ---------------------------------------------------------------------------

def test_bo_matches_jax():
    """A fixed seed, 12 evaluations: the same ``bo_info`` keys, the same
    trace and the same returned hyperparameters (1e-6)."""
    jgp, tgp = _pair()
    kw = dict(method="bo", max_iter=12, bo_args={"seed": 3, "n_init": 9})
    ref = _train(jgp, **kw)
    got = _train(tgp, **kw)
    _close(got, ref, 1e-6)
    j, t = jgp.bo_info, tgp.bo_info
    assert sorted(t) == sorted(j)
    assert t["n_evaluations"] == j["n_evaluations"] == 12
    assert t["stopping reason"] == j["stopping reason"]
    for key in ("trace x", "trace f(x)", "ei history",
                "surrogate hyperparameters", "curvature"):
        _close(t[key], j[key], 1e-6)
    assert isinstance(t["surrogate"], GP)
    assert t["surrogate"].device == tgp.device
    # a pickle drops the surrogate, as the JAX package's does
    back = pickle.loads(pickle.dumps(tgp))
    assert "surrogate" not in back.bo_info
    _close(back.bo_info["trace x"], t["trace x"], 0)


def test_bo_acquisition_and_laplace_match_jax():
    """On the same design: the surrogate, its noisy-EI values and
    gradients at fixed points, the lockstep ascent and the Laplace
    curvature (1e-8)."""
    import jax
    import jax.numpy as jnp

    from fvgp_tpu.models import gp_bo as jbo
    from fvgp_tpu_torch.models import gp_bo as tbo
    rng = np.random.default_rng(2)
    U = rng.random((14, 2))
    Y = -np.sum((U - 0.4) ** 2, axis=1) + 0.01 * rng.standard_normal(14)
    space = tbo._SearchSpace.create(np.array([[0.1, 10.0], [-1.0, 1.0]]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jgp = jbo._fit_surrogate(U, Y, None, 2, 30)
        tgp = tbo._fit_surrogate(U, Y, None, 2, 30, torch.device("cpu"))
    _close(tgp.hyperparameters, jgp.hyperparameters, 1e-8)
    ybs = Y.max() + 0.01 * rng.standard_normal(8)
    jn, jasc, jpm = jbo._make_acquisition(jgp, ybs, 2, 10, 0.05)
    tn, tasc, tpm = tbo._make_acquisition(tgp, ybs, 2, 10, 0.05)
    pts = rng.random((6, 2))
    _close(tn(pts).numpy(), np.asarray(jn(jnp.asarray(pts))), 1e-8)
    jg = np.asarray(jax.vmap(jax.grad(
        lambda u: jn(u[None, :])[0]))(jnp.asarray(pts)))
    ut = torch.as_tensor(pts).requires_grad_(True)
    grad = torch.autograd.grad(tn(ut).sum(), ut)[0]
    _close(grad.numpy(), jg, 1e-8)
    jU, jv = jasc(jnp.asarray(pts[:3]))
    tU, tv = tasc(pts[:3])
    _close(tU.numpy(), np.asarray(jU), 1e-8)
    _close(tv.numpy(), np.asarray(jv), 1e-8)
    jcov, jcurv = jbo._laplace_posterior(jpm, pts[0], space)
    tcov, tcurv = tbo._laplace_posterior(tpm, pts[0], space,
                                         torch.device("cpu"))
    _close(tcurv, jcurv, 1e-8)


# ---------------------------------------------------------------------------
# a callable method and the asynchronous actors
# ---------------------------------------------------------------------------

def test_callable_method_receives_the_trainer():
    """A callable ``method(trainer)`` returns the hyperparameters, which the
    facade commits."""
    _, gp = _pair()
    target = np.array([0.5, 1.5, 2.5])
    seen = []

    def method(trainer):
        seen.append(trainer)
        return target

    np.testing.assert_array_equal(_train(gp, method=method), target)
    np.testing.assert_array_equal(gp.hyperparameters, target)
    assert seen == [gp.trainer]


def _poll(opt, seconds=20.0):
    deadline = time.time() + seconds
    latest = opt.get_latest()
    while not latest and time.time() < deadline:
        time.sleep(0.05)
        latest = opt.get_latest()
    return latest


@pytest.mark.parametrize("method", ["mcmc", "adam", "hgdl", "bo"])
def test_async_training_polling(method):
    """``asynchronous=True`` returns a proxy at once; a result is published
    while the run goes on, ``update_hyperparameters`` commits it, and
    ``stop_training`` / ``kill_client`` end the thread (the JAX package's
    test of the same name, with shorter budgets)."""
    _, gp = _pair()
    kwargs = {"bo_args": {"n_init": 4, "patience": 2}} if method == "bo" \
        else {}
    opt = _train(gp, method=method, max_iter=8 if method == "bo" else 150,
                 pop_size=4, asynchronous=True, **kwargs)
    assert not isinstance(opt, np.ndarray)
    assert _poll(opt), f"async {method} never published a result"
    hps = gp.update_hyperparameters(opt)
    assert hps.shape == (3,) and np.all(np.isfinite(hps))
    np.testing.assert_array_equal(gp.hyperparameters, hps)
    gp.stop_training(opt)
    gp.kill_client(opt)
    opt.actor.join(timeout=20)
    assert opt.is_done() and not opt.actor._thread.is_alive()
    assert "error" not in opt.actor.get_latest()


def test_async_stop_before_first_optimum_terminates():
    """A stop issued at once must not strand the poller: the actor publishes
    the failure and ``is_done()`` flips (the JAX package's test of the same
    name)."""
    _, gp = _pair()
    opt = _train(gp, method="hgdl", max_iter=200, pop_size=4,
                 asynchronous=True)
    gp.stop_training(opt)
    for _ in range(200):
        if opt.actor.is_done():
            break
        time.sleep(0.05)
    assert opt.actor.is_done()


def test_async_run_keeps_the_sequential_state_gate_for_its_lifetime():
    """The linear-algebra gate wraps the whole background run: warm starts
    stay off while the thread runs and come back when it ends."""
    _, gp = _pair()
    gp.args["sparse_krylov_warm_start"] = True
    seen = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        opt = gp.train(hyperparameter_bounds=BOUNDS, method="adam",
                       max_iter=40, asynchronous=True,
                       objective_function=lambda h: seen.append(
                           gp.args["sparse_krylov_warm_start"]) or 0.0,
                       objective_function_gradient=lambda h: h - 1.0)
    opt.actor.join(timeout=20)
    assert seen and not any(seen)
    assert gp.args["sparse_krylov_warm_start"] is True


def test_update_hyperparameters_result_parsing():
    """The poll's result forms: an optima list, ``median(x)``, ``x``; a
    raising poll keeps the current hyperparameters, an empty one warns, the
    rest raise (the JAX package's test of the same name)."""
    _, gp = _pair()
    cur = gp.hyperparameters.copy()

    class Fake:
        def __init__(self, out):
            self.out = out

        def get_latest(self):
            if isinstance(self.out, Exception):
                raise self.out
            return self.out

    np.testing.assert_array_equal(
        gp.update_hyperparameters(Fake(RuntimeError("down"))), cur)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = gp.update_hyperparameters(Fake([]))
    np.testing.assert_array_equal(out, cur)
    assert any("empty optima" in str(w.message) for w in rec)
    target = np.array([2.0, 3.0, 4.0])
    for latest in ([{"x": target, "f(x)": 0.0}], {"median(x)": target},
                   {"x": target}):
        np.testing.assert_array_equal(
            gp.update_hyperparameters(Fake(latest)), target)
    for bad in ({"bogus": 1}, "nonsense"):
        with pytest.raises(Exception):
            gp.update_hyperparameters(Fake(bad))
    with pytest.raises(AssertionError):
        gp.update_hyperparameters(Fake({"x": np.ones((2, 2))}))


def test_stop_training_without_async_warns():
    _, gp = _pair()
    for call in (gp.stop_training, gp.kill_client):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            call(object())
        assert any("No asynchronous training" in str(w.message)
                   for w in rec)


def test_async_method_guard():
    """The facade warns and runs ``local`` synchronously; gp2Scale runs
    synchronously too; the trainer itself refuses an unsupported method
    (the JAX package's test of the same name)."""
    _, gp = _pair()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = gp.train(method="local", asynchronous=True,
                       hyperparameter_bounds=BOUNDS, max_iter=3)
    assert any("not supported" in str(w.message) for w in rec)
    assert isinstance(out, np.ndarray)
    with pytest.raises(AssertionError):
        gp.trainer.train_async(
            objective_function=lambda h: 0.0,
            objective_function_gradient=lambda h: np.zeros(3),
            hyperparameter_bounds=BOUNDS, init_hyperparameters=H0,
            method="local", max_iter=2)
    x, y = _data()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        sgp = GP(x, y, init_hyperparameters=H0, gp2Scale=True,
                 compute_device="cpu", noise_variances=np.full(N, 1e-2),
                 args={"gp2Scale_block_size": 16})
        out = sgp.train(method="adam", asynchronous=True,
                        hyperparameter_bounds=BOUNDS, max_iter=2)
    assert any("does not allow asynchronous" in str(w.message) for w in rec)
    assert isinstance(out, np.ndarray)

