"""Non-Euclidean inputs and the multi-task ``fvGP`` in the port against the
JAX package (CPU, float64, the same seeded data).

* Non-Euclidean: lists of arbitrary (ragged) objects with a host kernel —
  the dense GP (LML, gradient, posteriors, MCMC, appends) and gp2Scale
  (every tile pair scheduled, the host tile loop, the exact zero-tile
  filter; stored-operator LML, posteriors, an append), and the raising
  sites of that input space.
* ``fvGP``: the task-major NaN-skipping transform, construction, the
  task-major posteriors, ``update_gp_data`` with its validate-before-mutate
  order, training, gp2Scale, list inputs, pickling and
  ``gp_from_numpy_state``.

Bounds: 1e-8 for exact paths; 1e-6 where both packages take difference
quotients (a host kernel's gradient); trained hyperparameters 1e-5."""

import pickle
import warnings

import numpy as np
import pytest
import torch

from fvgp_tpu_torch import GP, fvGP, gp_from_numpy_state

try:
    from fvgp_tpu import GP as JaxGP
    from fvgp_tpu import fvGP as JaxFvGP
except ImportError:     # a card's machine without JAX runs the cuda cases
    JaxGP = JaxFvGP = None

warnings.simplefilter("ignore")

EXACT = 1e-8
QUOTIENT = 1e-6
TRAINED = 1e-5


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=tol, atol=tol)


# -- non-Euclidean inputs ------------------------------------------------------

def string_kernel(x1, x2, hps):
    """Gram matrix over strings: hps[0]·exp(-edit-ish distance / hps[1])."""
    K = np.empty((len(x1), len(x2)))
    for i, a in enumerate(x1):
        for j, b in enumerate(x2):
            d = abs(len(a) - len(b)) + sum(c1 != c2 for c1, c2 in zip(a, b))
            K[i, j] = np.exp(-d / hps[1])
    return hps[0] * K


WORDS = ["gaussian", "process", "kernel", "matern", "wendland", "tpu",
         "pallas", "mesh", "shard", "jit"]
Y = np.array([float(len(w)) for w in WORDS])
H_WORDS = np.array([1.0, 4.0])


def _word_pair(n=10):
    return (JaxGP(WORDS[:n], Y[:n], init_hyperparameters=H_WORDS,
                  kernel_function=string_kernel),
            GP(WORDS[:n], Y[:n], init_hyperparameters=H_WORDS,
               kernel_function=string_kernel, compute_device="cpu"))


def test_non_euclidean_gp_matches_jax():
    jgp, tgp = _word_pair()
    assert not tgp.data.Euclidean and tgp.index_set_dim == 1
    assert tgp.prior._x_dev is None and not tgp.prior.kernel_traceable
    _close(tgp.log_likelihood(), jgp.log_likelihood(), EXACT)
    _close(tgp.log_likelihood(H_WORDS * 1.1), jgp.log_likelihood(H_WORDS * 1.1),
           EXACT)
    xp = ["gauss", "proc"]
    _close(tgp.posterior_mean(xp)["m(x)"], jgp.posterior_mean(xp)["m(x)"],
           EXACT)
    _close(tgp.posterior_covariance(xp)["S"],
           jgp.posterior_covariance(xp)["S"], EXACT)
    assert tgp.posterior_mean(xp)["x"] == xp
    _close(tgp.neg_log_likelihood_gradient(),
           jgp.neg_log_likelihood_gradient(), QUOTIENT)
    _close(tgp.neg_log_likelihood_gradient(H_WORDS * 1.1),
           jgp.neg_log_likelihood_gradient(H_WORDS * 1.1), QUOTIENT)


def test_non_euclidean_raising_sites():
    """The input space's own exceptions: no kernel, no hyperparameters,
    default bounds."""
    with pytest.raises(Exception, match="non-Euclidean"):
        GP(WORDS, Y, init_hyperparameters=H_WORDS, compute_device="cpu")
    with pytest.raises(Exception, match="init_hyperparameters"):
        GP(WORDS, Y, kernel_function=string_kernel, compute_device="cpu")
    _, tgp = _word_pair()
    with pytest.raises(Exception, match="non-Euclidean"):
        tgp.train(method="local", max_iter=2)


def test_non_euclidean_update_data_and_training():
    """An append of a list equals the model built on all the data; MCMC
    and local training run on the host kernel."""
    _, tgp = _word_pair(7)
    tgp.update_gp_data(WORDS[7:], Y[7:], append=True, rank_n_update=False)
    assert tgp.data.point_number == 10 and tgp.x_data == WORDS
    jgp, fresh = _word_pair()
    _close(tgp.log_likelihood(), fresh.log_likelihood(), EXACT)
    bounds = np.array([[0.1, 20.0], [0.5, 20.0]])
    before = tgp.log_likelihood()
    np.random.seed(0)
    tgp.train(method="mcmc", hyperparameter_bounds=bounds, max_iter=100)
    assert tgp.log_likelihood() >= before - 1.0
    kw = dict(hyperparameter_bounds=bounds, method="local", max_iter=10,
              init_hyperparameters=H_WORDS)
    _close(fresh.train(**kw), jgp.train(**kw), TRAINED)


def ragged_objects(n, seed=0):
    """Ragged sequences whose first letter decides the covariance, the
    letters in runs (so that far-apart blocks share no support)."""
    letters = "abcdefghij"
    return [[letters[(i * 10 // n + seed) % 10]] * (1 + i % 3)
            for i in range(n)]


def compact_kernel(x1, x2, hps):
    """A compactly supported kernel over first letters, vectorized per
    tile."""
    a = np.array([ord(p[0]) for p in x1])[:, None]
    b = np.array([ord(p[0]) for p in x2])[None, :]
    d = np.where(a == b, 0.0, np.minimum(np.abs(a - b) / (8.0 * hps[1]),
                                         1.0))
    return hps[0] * (1.0 - d) ** 8 * (32.0 * d ** 3 + 25.0 * d ** 2
                                      + 8.0 * d + 1.0)


def _gp2(pkg, x, y, **kw):
    return pkg(x, y, init_hyperparameters=np.array([1.0, 0.5]),
               gp2Scale=True, gp2Scale_batch_size=10,
               kernel_function=compact_kernel,
               args={"gp2Scale_block_size": 8}, **kw)


def test_gp2scale_with_non_euclidean_object_points():
    """Ragged objects through the block-sparse engine: the assembly equals
    the direct evaluation and the JAX package's K, the dead tiles are
    dropped, and the LML and posteriors equal the JAX package's, also after
    an append, where they equal a model's built on all the data (the port's
    appended model used to solve with the factor from before the
    append)."""
    rng = np.random.default_rng(0)
    x = ragged_objects(40)
    y = rng.random(40)
    tgp = _gp2(GP, x, y, compute_device="cpu")
    jgp = _gp2(JaxGP, x, y)
    K = tgp.prior.K
    _close(K.toarray(), compact_kernel(x, x, np.array([1.0, 0.5])), 1e-12)
    _close(K.toarray(), np.asarray(jgp.prior.K.to_dense()), 1e-12)
    assert K.nnz == jgp.prior.K.nnz < 25 * 64       # dead tiles dropped
    _close(tgp.log_likelihood(), jgp.log_likelihood(), EXACT)
    xp = [["a"], ["b", "b"], ["j"]]
    _close(tgp.posterior_mean(xp)["m(x)"], jgp.posterior_mean(xp)["m(x)"],
           EXACT)
    _close(tgp.posterior_covariance(xp)["v(x)"],
           jgp.posterior_covariance(xp)["v(x)"], EXACT)
    x_new, y_new = [["z", "z", "z"], ["a"]], np.array([0.5, 0.1])
    for gp in (tgp, jgp):
        gp.update_gp_data(x_new, y_new, append=True)
    assert tgp.prior.K.shape == (42, 42)
    _close(tgp.log_likelihood(), jgp.log_likelihood(), EXACT)
    _close(tgp.log_likelihood(), _gp2(GP, x + x_new, np.concatenate(
        [y, y_new]), compute_device="cpu").log_likelihood(), EXACT)


def test_distributed_covariance_takes_lists_with_a_host_kernel():
    """``distributed_covariance`` on lists: every tile pair scheduled (the
    upper triangle when symmetric), the rectangular cross covariance
    against another list."""
    from fvgp_tpu_torch.parallel.sharded_cov import distributed_covariance
    x = ragged_objects(30)
    tgp = _gp2(GP, x, np.zeros(30), compute_device="cpu")
    hps = np.array([1.0, 0.5])
    K = distributed_covariance(tgp.prior, x, x, hps, symmetric=True,
                               args={"gp2Scale_block_size": 8})
    _close(K.toarray(), compact_kernel(x, x, hps), 1e-14)
    xp = ragged_objects(11, seed=3)
    C = distributed_covariance(tgp.prior, x, xp, hps,
                               args={"gp2Scale_block_size": 8})
    assert C.shape == (30, 11)
    _close(C.toarray(), compact_kernel(x, xp, hps), 1e-14)


def test_host_kernel_receives_lists_unchanged():
    """A host kernel sees the ragged list itself, not an array of it."""
    seen = []

    def kernel(x1, x2, hps):
        seen.append((type(x1), type(x2)))
        return compact_kernel(x1, x2, hps)

    x = ragged_objects(12)
    gp = GP(x, np.arange(12.0), init_hyperparameters=np.array([1.0, 0.5]),
            noise_variances=np.full(12, 0.1), kernel_function=kernel,
            compute_device="cpu")
    gp.prior.compute_covariances(x, x[:3], gp.hyperparameters)
    gp.posterior_covariance([["a", "a"], ["c"]])
    assert seen and all(t == (list, list) for t in seen)


# -- fvGP ---------------------------------------------------------------------

def _mt_data(n=30, nan=True, seed=42):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 5, (n, 2))
    y = np.stack([np.sin(x[:, 0]), np.cos(x[:, 1]), x[:, 0] * 0.1], axis=1)
    if nan:
        y[2, 1] = np.nan
        y[7, 2] = np.nan
    return x, y


def _fv_pair(x, y, hps=np.ones(4), **kw):
    return (JaxFvGP(x, y, init_hyperparameters=hps, **kw),
            fvGP(x, y, init_hyperparameters=hps, compute_device="cpu", **kw))


@pytest.mark.parametrize("nan", [False, True])
def test_fvgp_transform_and_construction_match_jax(nan):
    x, y = _mt_data(nan=nan)
    jf, tf = _fv_pair(x, y)
    assert tf.data.point_number == (88 if nan else 90)
    _close(tf.x_data, jf.x_data, 0.0)
    _close(tf.y_data, jf.y_data, 0.0)
    assert tf.input_set_dim == 2 and tf.index_set_dim == 3
    np.testing.assert_array_equal(tf.fvgp_x_data, x)
    np.testing.assert_array_equal(tf.fvgp_y_data, y)
    _close(tf.log_likelihood(), jf.log_likelihood(), EXACT)
    _close(tf.neg_log_likelihood_gradient(), jf.neg_log_likelihood_gradient(),
           EXACT)
    with pytest.raises(ValueError):
        fvGP(x, y[:, 0], init_hyperparameters=np.ones(4), compute_device="cpu")


def test_fvgp_posteriors_are_task_major_and_match_jax():
    x, y = _mt_data()
    jf, tf = _fv_pair(x, y)
    xp, x_out = x[:4] + 0.1, np.arange(3.0)
    tm, jm = (f.posterior_mean(xp, x_out=x_out) for f in (tf, jf))
    tc, jc = (f.posterior_covariance(xp, x_out=x_out) for f in (tf, jf))
    assert tm["m(x)"].shape == (4, 3) and tc["S"].shape == (4, 4, 3, 3)
    _close(tm["m(x)"], jm["m(x)"], EXACT)
    _close(tc["v(x)"], jc["v(x)"], EXACT)
    _close(tc["S"], jc["S"], EXACT)
    _close(tc["S"][1, 2, 0, 1], tc["S_flat"][1, 2 + 4 * 1], 1e-12)
    _close(tf.posterior_mean(xp)["m(x)"], tm["m(x)"], 1e-12)   # default x_out
    _close(tf.posterior_mean_grad(xp, x_out=x_out, direction=0)["dm/dx"],
           jf.posterior_mean_grad(xp, x_out=x_out, direction=0)["dm/dx"],
           EXACT)


def test_fvgp_update_gp_data_matches_jax_and_validates_first():
    x, y = _mt_data(nan=False)
    jf, tf = _fv_pair(x[:20], y[:20])
    for f in (jf, tf):
        f.update_gp_data(x[20:], y[20:], append=True, rank_n_update=False)
    assert tf.data.point_number == 90
    _close(tf.log_likelihood(), jf.log_likelihood(), EXACT)
    nv = np.full_like(y, 1e-2)
    f = fvGP(x, y, init_hyperparameters=np.ones(4), noise_variances=nv,
             compute_device="cpu")
    x2 = x[:4] + 0.3
    with pytest.raises(Exception):
        f.update_gp_data(x2, y[:4], append=True)    # noise given at init
    np.testing.assert_array_equal(f.fvgp_x_data, x)
    np.testing.assert_array_equal(f.fvgp_noise_variances, nv)
    assert f.data.point_number == 90
    f.update_gp_data(x2, y[:4], noise_variances_new=np.full((4, 3), 2e-2),
                     append=True)
    assert f.fvgp_x_data.shape == (34, 2) and f.data.point_number == 102
    f.update_gp_data(x2, y[:4], noise_variances_new=np.full((4, 3), 3e-2),
                     append=False)
    assert f.fvgp_x_data.shape == (4, 2)
    _close(f.fvgp_noise_variances, 3e-2, 0.0)


def test_fvgp_training_matches_jax():
    x, y = _mt_data()
    jf, tf = _fv_pair(x, y)
    bounds = np.array([[0.01, 10.0], [0.1, 10.0], [0.1, 10.0], [0.1, 10.0]])
    kw = dict(method="local", hyperparameter_bounds=bounds, max_iter=20,
              init_hyperparameters=np.ones(4))
    before = tf.log_likelihood()
    _close(tf.train(**kw), jf.train(**kw), TRAINED)
    assert tf.log_likelihood() > before


def test_fvgp_gp2scale_multitask_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 25, (200, 2))
    y = np.stack([np.sin(x[:, 0]), np.cos(x[:, 1])], axis=1)
    hps = np.array([1.0, 1.5, 1.5, 1.0])
    kw = dict(gp2Scale=True, args={"gp2Scale_block_size": 64})
    jf, tf = _fv_pair(x, y, hps, **kw)
    assert len(tf.x_data) == 400
    _close(tf.x_data, jf.x_data, 0.0)
    xp = x[:5] + 0.02
    pm = tf.posterior_mean(xp, x_out=np.array([0, 1]))["m(x)"]
    assert pm.shape == (5, 2)
    _close(pm, jf.posterior_mean(xp, x_out=np.array([0, 1]))["m(x)"], 1e-7)


def obj_kernel(a, b, hps, args=None):
    av = np.asarray([np.mean(p[0]) + 0.1 * p[1] for p in a])
    bv = np.asarray([np.mean(p[0]) + 0.1 * p[1] for p in b])
    return np.exp(-np.abs(av[:, None] - bv[None, :]))


def test_fvgp_with_list_inputs_matches_jax():
    """Object points in the multi-task space are ``[object, task]`` pairs;
    an append of objects extends the lists."""
    rng = np.random.default_rng(42)
    xs = [rng.uniform(0, 1, 3) for _ in range(6)]
    ys = np.stack([np.array([np.mean(p), np.std(p)]) for p in xs])
    kw = dict(kernel_function=obj_kernel)
    jf, tf = _fv_pair(xs, ys, np.ones(1), **kw)
    assert tf.x_data[7][1] == 1 and tf.data.point_number == 12
    _close(tf.log_likelihood(), jf.log_likelihood(), EXACT)
    xp = [rng.uniform(0, 1, 3)]
    _close(tf.posterior_mean(xp, x_out=np.array([0, 1]))["m(x)"],
           jf.posterior_mean(xp, x_out=np.array([0, 1]))["m(x)"], EXACT)
    xs2 = [rng.uniform(0, 1, 3) for _ in range(2)]
    ys2 = np.stack([np.array([np.mean(p), np.std(p)]) for p in xs2])
    for f in (jf, tf):
        f.update_gp_data(xs2, ys2, append=True, rank_n_update=False)
    assert len(tf.fvgp_x_data) == 8
    _close(tf.log_likelihood(), jf.log_likelihood(), EXACT)


def test_fvgp_pickles_and_carries_across_from_a_jax_state():
    x, y = _mt_data()
    jf, tf = _fv_pair(x, y, noise_variances=np.full_like(y, 1e-2))
    back = pickle.loads(pickle.dumps(tf))
    assert back.output_num == 3
    np.testing.assert_array_equal(back.fvgp_y_data, y)
    _close(back.log_likelihood(), tf.log_likelihood(), 1e-12)
    state = dict(x_data=np.asarray(jf.x_data), y_data=np.asarray(jf.y_data),
                 noise_variances=np.asarray(jf.noise_variances),
                 hyperparameters=np.asarray(jf.hyperparameters),
                 output_num=jf.output_num, fvgp_x_data=jf.fvgp_x_data,
                 fvgp_y_data=jf.fvgp_y_data,
                 fvgp_noise_variances=jf.fvgp_noise_variances,
                 args={}, gp2Scale=False)
    carried = gp_from_numpy_state(state, compute_device="cpu")
    assert isinstance(carried, fvGP)
    xp = x[:3] + 0.2
    _close(carried.posterior_mean(xp, x_out=np.arange(3.0))["m(x)"],
           jf.posterior_mean(xp, x_out=np.arange(3.0))["m(x)"], EXACT)
    words = dict(x_data=list(WORDS), y_data=Y, noise_variances=None,
                 hyperparameters=H_WORDS, args={}, gp2Scale=False)
    gp = gp_from_numpy_state(words, compute_device="cpu",
                             kernel_function=string_kernel)
    _close(gp.log_likelihood(), _word_pair()[0].log_likelihood(), EXACT)


@pytest.mark.cuda
def test_fvgp_default_kernel_runs_k3_on_the_card():
    """fvGP's default kernel at D + 1 = 3 columns: its committed
    covariances launch K3, and the LML agrees with the CPU in float64 (the
    dense float32 bound, 1e-4 relative)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from fvgp_tpu_torch.ops import hopper_kernels as hk
    x, y = _mt_data(n=200)
    before = hk.dense_covariance.launches
    card = fvGP(x, y, init_hyperparameters=np.ones(4), compute_device="cuda",
                noise_variances=np.full_like(y, 1e-2))
    assert hk.dense_covariance.launches > before
    cpu = fvGP(x, y, init_hyperparameters=np.ones(4), compute_device="cpu",
               noise_variances=np.full_like(y, 1e-2))
    assert abs(card.log_likelihood() - cpu.log_likelihood()) \
        <= 1e-4 * abs(cpu.log_likelihood())
