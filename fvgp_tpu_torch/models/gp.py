"""GP facade — the single-task user API on PyTorch (counterpart of
``fvgp_tpu/models/gp.py``).

``GP(x, y)`` is the dense exact GP on the card: the default Matérn-3/2 ARD
kernel (its covariances built by the K3 kernel), the ``Chol`` / ``CholInv``
/ ``Inv`` factorizations, the autograd LML + gradient, ``train`` with
``"global"``, ``"local"``, ``"hgdl"``, ``"mcmc"`` (the default), ``"adam"``,
``"bo"`` or a callable, synchronously or in a thread
(``asynchronous=True``), posterior means, covariances and variances, and
``update_gp_data``.  ``GP(x, y, gp2Scale=True)`` runs the block-sparse
engine: the differentiable mBCG LML (K1 SpMM) and posterior means and
variances through the committed-state solver (K2 SpMM); off the traced path (``args["gp2Scale_traced_lml"] =
False``, a multi-column y, a prior mean function, ``gp.K``,
``update_gp_data``, a full posterior covariance) it stores the covariance as
a ``BlockSparseMatrix`` and solves against it with the Krylov / SLQ /
preconditioner stack, the stored product again on K1.  On both: the
posterior gradients, the information-theory suite, the validation metrics
and pickling (the pickle holds host arrays and the device's name; it loads
back onto that device).  ``compute_device="cpu"`` runs the same code with
the kernels' plain versions, in float64 by default.
"""

import warnings

import numpy as np
from scipy.stats import norm

from ..parallel.mesh import sync_host_random
from .gp_data import GPdata
from .gp_kv import GPkv, sequential_linalg_state
from .gp_likelihood import GPlikelihood
from .gp_marginal_likelihood import GPMarginalLikelihood
from .gp_posterior import GPposterior
from .gp_prior import GPprior
from .gp_training import GPtraining

warnings.filterwarnings("once", category=UserWarning,
                        module=r"fvgp_tpu_torch(\..*)?")


def out_of_bounds(x, bounds):
    x = np.asarray(x)
    bounds = np.asarray(bounds)
    return bool(np.any(x < bounds[:, 0]) or np.any(x > bounds[:, 1]))


class GP:
    """Single-task Gaussian process.

    Parameters follow the JAX package's ``GP``.  ``compute_device`` is
    ``"cuda"``/``"gpu"`` (the default) or ``"cpu"`` and decides where every
    tensor lives; asking for a card that is not there raises.
    ``args["dtype"]`` sets the solve dtype (default float64 on the CPU,
    float32 on CUDA); ``args["gp2Scale_solver_dtype"] = "bfloat16"`` streams
    the gp2Scale covariance tiles in bfloat16 through the kernels.  Kernels
    are torch callables ``k(x1, x2, hps)`` (or ``k(x1, x2, hps, args)``)
    that broadcast over a leading batch dimension (default: the anisotropic
    Matérn-3/2, or the anisotropic Wendland kernel under gp2Scale); means
    ``m(x, hps)`` and noise ``noise(x, hps)`` likewise.  A callable may
    instead be a host (numpy) function, which takes numpy points and
    hyperparameters; a noise callable may return a ``scipy.sparse`` matrix
    or a ``BlockSparseMatrix``.  Such models train on the formula gradient
    (``kernel_function_grad``, ``prior_mean_function_grad`` and
    ``noise_function_grad`` — numpy in, numpy or a tensor out — supply its
    derivatives; ``ram_economy=True`` asks for them one direction at a
    time).  ``x_data`` may be a list of arbitrary objects (a non-Euclidean
    input space): a host kernel and ``init_hyperparameters`` are then
    required.
    """

    def __init__(self, x_data, y_data, init_hyperparameters=None,
                 noise_variances=None, compute_device="cuda",
                 kernel_function=None, kernel_function_grad=None,
                 noise_function=None, noise_function_grad=None,
                 prior_mean_function=None, prior_mean_function_grad=None,
                 gp2Scale=False, dask_client=None, gp2Scale_batch_size=10000,
                 gp2Scale_distribution="blockwise", linalg_mode=None,
                 ram_economy=False, args=None):
        if not (isinstance(noise_variances, np.ndarray)
                or noise_variances is None):
            raise AssertionError("wrong format in noise_variances")
        if not (init_hyperparameters is None
                or isinstance(init_hyperparameters, np.ndarray)):
            raise AssertionError("wrong init_hyperparameters")
        if not isinstance(compute_device, str):
            raise AssertionError("wrong format in compute_device")
        for fn, name in ((kernel_function, "kernel_function"),
                         (kernel_function_grad, "kernel_function_grad"),
                         (noise_function, "noise_function"),
                         (noise_function_grad, "noise_function_grad"),
                         (prior_mean_function, "prior_mean_function"),
                         (prior_mean_function_grad,
                          "prior_mean_function_grad")):
            if not (callable(fn) or fn is None):
                raise AssertionError(f"wrong format in {name}")
        if len(x_data) != len(y_data):
            raise AssertionError("x_data and y_data do not have the same "
                                 "lengths.")
        if args is None:
            args = {}
        self.data = GPdata(x_data, y_data, args=args,
                           noise_variances=noise_variances,
                           ram_economy=ram_economy, gp2Scale=gp2Scale,
                           compute_device=compute_device,
                           gp2Scale_batch_size=gp2Scale_batch_size)
        hyperparameters = init_hyperparameters
        if hyperparameters is None and self.data.Euclidean:
            if callable(kernel_function) or callable(prior_mean_function) \
                    or callable(noise_function):
                raise Exception(
                    "You have provided callables for kernel, mean, or noise "
                    "functions but no initial hyperparameters.")
            hyperparameters = np.ones(self.index_set_dim + 1)
            warnings.warn("Hyperparameters initialized to a vector of ones.")
        if hyperparameters is None:
            raise Exception("'init_hyperparameters' not provided and could "
                            "not be calculated. Please provide them.")

        self.trainer = GPtraining(self.data, hyperparameters)
        self.prior = GPprior(self.data, self.trainer,
                             kernel=kernel_function,
                             prior_mean_function=prior_mean_function,
                             kernel_grad=kernel_function_grad,
                             prior_mean_function_grad=prior_mean_function_grad,
                             gp2Scale_batch_size=gp2Scale_batch_size,
                             gp2Scale_distribution=gp2Scale_distribution)
        self.likelihood = GPlikelihood(self.data, self.trainer,
                                       noise_function=noise_function,
                                       noise_function_grad=noise_function_grad)
        self.kv = GPkv(self.data, self.prior, self.likelihood,
                       linalg_mode=linalg_mode)
        self.marginal_likelihood = GPMarginalLikelihood(
            self.data, self.prior, self.likelihood, self.trainer, self.kv)
        self.posterior = GPposterior(self.data, self.prior, self.trainer,
                                     self.kv, self.likelihood)

    # ----------------------------------------------------------------------
    @property
    def x_data(self):
        return self.data.x_data

    @property
    def y_data(self):
        return self.data.y_data

    @property
    def noise_variances(self):
        return self.data.noise_variances

    @property
    def index_set_dim(self):
        return self.data.index_set_dim

    @property
    def input_set_dim(self):
        return self.data.input_set_dim

    @property
    def args(self):
        return self.data.args

    @args.setter
    def args(self, args):
        self.data.args = args

    @property
    def device(self):
        return self.data.device

    @property
    def K(self):
        return self.prior.K

    @property
    def m(self):
        return self.prior.m

    @property
    def V(self):
        return self.likelihood.V

    @property
    def hyperparameters(self):
        return self.trainer.hyperparameters

    @property
    def gp2Scale(self):
        return self.data.gp2Scale

    @property
    def mcmc_info(self):
        return self.trainer.mcmc_info

    @property
    def bo_info(self):
        """Diagnostics of the last ``train(method="bo")``."""
        return self.trainer.bo_info

    @property
    def dask_client(self):
        """Always None: the port has no Dask (kept for API parity)."""
        return None

    def initialize_gp2Scale_dask_client(self, gp2Scale=None, dask_client=None):
        """No-op kept for API parity: the gp2Scale covariance is computed on
        the card, so there is no client to create.  Returns the (ignored)
        ``dask_client`` argument."""
        return dask_client

    def get_hyperparameters(self):
        """Deprecated accessor of ``hyperparameters``."""
        warnings.warn("`get_hyperparameters()` is deprecated. Please use "
                      "`hyperparameters`", DeprecationWarning, stacklevel=2)
        return self.hyperparameters

    def get_prior_pdf(self):
        """The prior covariance and mean at the data points."""
        return {"prior covariance (K)": self.prior.K,
                "prior mean": self.prior.m}

    def set_args(self, new_args):
        """Change the advanced-settings dict (cached state is kept)."""
        self.args = new_args

    def set_hyperparameters(self, hps):
        """Commit a hyperparameter vector and refresh the dependent state."""
        if not (isinstance(hps, np.ndarray) and hps.ndim == 1):
            raise AssertionError("wrong format in hyperparameters")
        self.trainer.hyperparameters = np.asarray(hps, dtype=np.float64)
        self.prior.update_state_hyperparameters()
        self.likelihood.update_state()
        self.kv.update_state_hyperparameters()

    def update_gp_data(self, x_new, y_new, noise_variances_new=None,
                       append=True, rank_n_update=None):
        """Replace or extend the training data without rebuilding the GP.

        With ``append=True`` the new points are appended: the prior computes
        only the new (old × new) and (new × new) covariance blocks, and the
        factor (or inverse) is extended by a blocked rank-n update
        (``rank_n_update``, default ``append``) unless the old-data block
        moved.  ``append=False`` replaces the dataset.  Under gp2Scale a
        stored K is extended by the new tile sets when the old point count is
        a multiple of the tile size and recomputed otherwise; the linear
        algebra state stays lazy."""
        if not isinstance(x_new, (list, np.ndarray)):
            raise AssertionError("wrong format in x_new")
        if not (isinstance(y_new, np.ndarray) and y_new.ndim in (1, 2)):
            raise AssertionError("wrong format in y_new")
        if not (isinstance(noise_variances_new, np.ndarray)
                or noise_variances_new is None):
            raise AssertionError("wrong format in noise_variances_new")
        if len(x_new) != len(y_new):
            raise AssertionError("updated x and y do not have the same "
                                 "lengths.")
        if (isinstance(noise_variances_new, np.ndarray)
                and len(noise_variances_new) != len(y_new)):
            raise AssertionError("noise_variances_new and y_new do not have "
                                 "the same lengths.")
        # reject a column-count mismatch BEFORE delegating: GPdata stacks x
        # first, so a failure in the y stack would leave the data half-updated
        y_cols_new = 1 if y_new.ndim == 1 else y_new.shape[1]
        y_cols_old = np.asarray(self.data.y_data).shape[1]
        if append and y_cols_new != y_cols_old:
            raise AssertionError(
                f"y_new has {y_cols_new} column(s) but the stored y_data has "
                f"{y_cols_old}; appended outputs must match.")
        if rank_n_update is None:
            rank_n_update = append
        if not append and rank_n_update:
            warnings.warn("`rank_n_update=True` is invalid when "
                          "`append=False` (the previous factorization belongs "
                          "to data that no longer exists). Forcing "
                          "`rank_n_update=False`.")
            rank_n_update = False
        self.data.update(x_new, y_new, noise_variances_new, append=append)
        if append:
            self.prior.augment_state_data()
        else:
            self.prior.update_state_data()
        self.likelihood.update_state()
        self.kv.update_state_data(rank_n_update)

    def _get_default_hyperparameter_bounds(self):
        """Data-driven bounds for the default kernel."""
        if not self.data.Euclidean:
            raise Exception("Please provide custom hyperparameter bounds to "
                            "the training in the non-Euclidean setting")
        if len(self.hyperparameters) != self.index_set_dim + 1:
            raise Exception("Please provide custom hyperparameter_bounds when "
                            "kernel, mean or noise functions are customized")
        bounds = np.zeros((self.index_set_dim + 1, 2))
        bounds[0] = np.array([np.var(self.y_data) / 100.,
                              np.var(self.y_data) * 10.])
        for i in range(self.index_set_dim):
            range_xi = np.max(self.x_data[:, i]) - np.min(self.x_data[:, i])
            bounds[i + 1] = np.array([range_xi / 100., range_xi * 10.])
        return bounds

    # ----------------------------------------------------------------------
    def train(self, hyperparameter_bounds=None, objective_function=None,
              objective_function_gradient=None,
              objective_function_hessian=None, init_hyperparameters=None,
              method="mcmc", pop_size=20, tolerance=0.0001, max_iter=10000,
              mcmc_prior=None, mcmc_prop_distrs="normal", mcmc_args=None,
              bo_args=None, local_optimizer="L-BFGS-B",
              global_optimizer="genetic", constraints=(), dask_client=None,
              info=False, asynchronous=False):
        """Find hyperparameters by maximizing the log marginal likelihood
        (or minimizing a user objective), commit them, and return them.

        ``method``:

        * ``"mcmc"`` (the default) — adaptive Metropolis on the LML; fills
          ``mcmc_info``;
        * ``"global"`` — differential evolution, ``pop_size`` × H members,
          the population evaluated in batched chunks;
        * ``"local"`` — scipy ``local_optimizer`` on the fused LML value and
          gradient (and its Hessian, for the optimizers that take one);
        * ``"hgdl"`` — multistart: ``max(pop_size, 4)`` Adam runs in
          lockstep on one batched value-and-gradient (dense models), then
          scipy polishes the best three;
        * ``"adam"`` — Adam; under gp2Scale in chunks of
          ``args["adam_chain_steps"]`` (default 8) device steps;
        * ``"bo"`` — Bayesian optimization for the noisy stochastic-logdet
          LML (the estimator's variance feeds the surrogate); fills
          ``bo_info``;
        * a callable ``method(trainer)`` returning the hyperparameters.

        ``asynchronous=True`` (hgdl, mcmc, adam, bo; not under gp2Scale)
        returns at once with an optimizer proxy whose run goes on in a
        thread: poll it with ``update_hyperparameters``, end it with
        ``stop_training`` / ``kill_client``.  ``global_optimizer`` and
        ``dask_client`` are accepted and ignored."""
        if mcmc_args is None:
            mcmc_args = {}
        # under a mesh every rank draws the random start below (and the
        # chain after it) from rank 0's numpy random state
        sync_host_random()
        ml = self.marginal_likelihood
        if self.gp2Scale and asynchronous:
            asynchronous = False
            warnings.warn(f"gp2Scale does not allow asynchronous training "
                          f"(method=`{method}`)! `asynchronous` set to False.")
        if self.gp2Scale and method not in ("mcmc", "bo") \
                and not ml._sparse_traced_ready():
            # off the traced path the sparse LML has a value and no gradient
            warnings.warn("gp2Scale off the traced LML path (a kernel that "
                          "does not run on tensors, a mean function, a noise "
                          "function, non-Euclidean inputs, a multi-column y "
                          "or gp2Scale_traced_lml=False). Method switched to "
                          "MCMC!")
            method = "mcmc"
        _async_methods = {"hgdl", "mcmc", "adam", "bo"}
        if asynchronous and method not in _async_methods:
            warnings.warn(f"Asynchronous execution is not supported for "
                          f"method=`{method}`. Supported: "
                          f"{sorted(_async_methods)}. `asynchronous` set to "
                          f"False.")
            asynchronous = False
        if hyperparameter_bounds is None:
            hyperparameter_bounds = self._get_default_hyperparameter_bounds()
            warnings.warn("Default hyperparameter_bounds initialized because "
                          "none were provided. This will fail for custom "
                          "kernel, mean, or noise functions")
        if init_hyperparameters is None:
            if out_of_bounds(self.hyperparameters, hyperparameter_bounds):
                init_hyperparameters = np.random.uniform(
                    low=hyperparameter_bounds[:, 0],
                    high=hyperparameter_bounds[:, 1],
                    size=len(hyperparameter_bounds))
            else:
                init_hyperparameters = self.hyperparameters
        elif out_of_bounds(init_hyperparameters, hyperparameter_bounds):
            warnings.warn("Your init_hyperparameters are out of bounds. They "
                          "will be over-written")
            init_hyperparameters = np.random.uniform(
                low=hyperparameter_bounds[:, 0],
                high=hyperparameter_bounds[:, 1],
                size=len(hyperparameter_bounds))
        user_provided_obj = objective_function is not None
        if method == "mcmc":
            if user_provided_obj:
                warnings.warn("MCMC always optimizes the log marginal "
                              "likelihood; the user-defined "
                              "objective_function is ignored.")
                user_provided_obj = False
            objective_function = ml.log_likelihood
        elif objective_function is None:
            objective_function = ml.neg_log_likelihood
        if user_provided_obj and objective_function_gradient is None \
                and method in ("local", "hgdl"):
            raise Exception("A gradient (and Hessian) of the objective "
                            "function must be provided for method='local' "
                            "or method='hgdl'.")
        if objective_function_gradient is None:
            objective_function_gradient = ml.neg_log_likelihood_gradient
        if objective_function_hessian is None:
            objective_function_hessian = ml.neg_log_likelihood_hessian
        if method == "bo" and not user_provided_obj:
            # the stochastic estimator reports its own precision: feed it to
            # the surrogate as the observation noise
            bo_args = dict(bo_args or {})
            if "noise_function" not in bo_args \
                    and "noise_variance" not in bo_args:
                bo_args["noise_function"] = \
                    lambda hps, _ml=ml: _ml.log_likelihood_variance()
        if method == "bo":
            self._warn_about_bo_suitability(hyperparameter_bounds, max_iter,
                                            bo_args)
        fused_vg = batched_objective = batched_vg = adam_chain_runner = None
        if not user_provided_obj and (ml._traced_ready()
                                      or ml._sparse_traced_ready()):
            def fused_vg(hps, _ml=ml):
                val, grad = _ml.log_likelihood_value_and_gradient(hps)
                return -val, -grad
        if not user_provided_obj and ml._traced_ready():
            batched_objective = ml.batched_neg_log_likelihood
            batched_vg = ml.batched_value_and_grad_device()
        if not user_provided_obj and ml._sparse_traced_ready():
            def adam_chain_runner(theta, m, v, t, steps, bounds, _ml=ml):
                return _ml.sparse_adam_steps(theta, m, v, t, steps,
                                             bounds=bounds)
        common = dict(
            objective_function=objective_function,
            objective_function_gradient=objective_function_gradient,
            objective_function_hessian=objective_function_hessian,
            hyperparameter_bounds=np.asarray(hyperparameter_bounds,
                                             dtype=np.float64),
            init_hyperparameters=np.asarray(init_hyperparameters,
                                            dtype=np.float64),
            method=method, pop_size=pop_size, tolerance=tolerance,
            max_iter=max_iter, mcmc_prior=mcmc_prior,
            mcmc_prop_distrs=mcmc_prop_distrs, mcmc_args=mcmc_args,
            bo_args=bo_args, local_optimizer=local_optimizer,
            global_optimizer=global_optimizer, constraints=constraints,
            info=info, fused_value_and_grad=fused_vg)
        if asynchronous:
            # the sequential-state gate must live as long as the background
            # run: the actor wraps its whole thread in it
            return self.trainer.train_async(
                run_context=lambda: sequential_linalg_state(self.args,
                                                            method),
                **common)
        with sequential_linalg_state(self.args, method):
            hyperparameters = self.trainer.train(
                batched_objective=batched_objective,
                batched_value_and_grad=batched_vg,
                adam_chain_runner=adam_chain_runner, **common)
            self.set_hyperparameters(hyperparameters)
        return hyperparameters

    @staticmethod
    def _warn_about_bo_suitability(hyperparameter_bounds, max_iter, bo_args):
        """Warnings before a ``method="bo"`` run that cannot do well: a
        budget the initial design eats whole, or too many
        hyperparameters."""
        from .gp_bo import default_initial_design_size
        n_hps = len(hyperparameter_bounds)
        n_init = int((bo_args or {}).get(
            "n_init", default_initial_design_size(n_hps, max_iter)))
        n_init = max(2, min(n_init, max_iter))
        if n_init >= max_iter:
            warnings.warn(
                f"method='bo' has a budget of {max_iter} evaluations but its "
                f"space-filling initial design alone needs {n_init} for "
                f"{n_hps} hyperparameters, so the entire budget goes to that "
                f"design and no Bayesian optimization is performed — this is "
                f"random search. Raise max_iter well above {n_init}, or "
                f"lower bo_args['n_init'].")
        if n_hps > 20:
            warnings.warn(
                f"method='bo' is being asked to tune {n_hps} hyperparameters. "
                f"Bayesian optimization is intended for a handful up to "
                f"roughly 20; beyond that the result degrades without any "
                f"error being raised. Consider 'mcmc' or 'global', or reduce "
                f"the number of trained hyperparameters.")
        elif n_hps > 10:
            warnings.warn(
                f"method='bo' is being asked to tune {n_hps} hyperparameters, "
                f"which is at the edge of what it does well. Expect a less "
                f"precise optimum than at 2-5 and give it a larger max_iter.")

    def stop_training(self, opt_obj):
        """Ask an asynchronous training run to stop."""
        self.trainer.stop_training(opt_obj)

    def kill_client(self, opt_obj):
        """Stop an asynchronous training run and wait for its thread."""
        self.trainer.kill_client(opt_obj)

    def update_hyperparameters(self, opt_obj):
        """Pull the latest hyperparameters from a running asynchronous
        optimizer, commit them and return them."""
        hps = self.trainer.update_hyperparameters(opt_obj)
        self.set_hyperparameters(hps)
        return hps

    def log_likelihood(self, hyperparameters=None):
        if hyperparameters is not None and not (
                isinstance(hyperparameters, np.ndarray)
                and hyperparameters.ndim == 1):
            raise AssertionError("wrong format in hyperparameters")
        return self.marginal_likelihood.log_likelihood(
            hyperparameters=hyperparameters)

    def neg_log_likelihood_gradient(self, hyperparameters=None, component=0):
        return self.marginal_likelihood.neg_log_likelihood_gradient(
            hyperparameters=hyperparameters, component=component)

    def test_log_likelihood_gradient(self, hyperparameters, epsilon=1e-6):
        """Forward differences of the LML beside its analytic gradient:
        ``(finite differences, analytic)``."""
        if not (isinstance(hyperparameters, np.ndarray)
                and hyperparameters.ndim == 1):
            raise AssertionError("wrong format in hyperparameters")
        return self.marginal_likelihood.test_log_likelihood_gradient(
            hyperparameters, epsilon=epsilon)

    # ----------------------------------------------------------------------
    def posterior_mean(self, x_pred, hyperparameters=None, x_out=None):
        """Posterior mean ``m(x*) + k(x*, X)ᵀ (K+V)⁻¹ (y − m)``; returns a
        dict with ``"x"``, ``"m(x)"``, ``"m(x)_flat"`` and ``"x_pred"``."""
        return self.posterior.posterior_mean(
            x_pred, hyperparameters=hyperparameters, x_out=x_out)

    def posterior_covariance(self, x_pred, x_out=None, variance_only=False,
                             add_noise=False):
        """Posterior covariance ``S = k(x*,x*) − k(x*,X)ᵀ(K+V)⁻¹k(x*,X)``;
        returns a dict with ``"v(x)"`` (variances, clipped at 0 with a
        warning), ``"S"`` (None when ``variance_only``) and the flattened
        ``"v_flat"`` / ``"S_flat"``.  ``add_noise`` adds a noise callable's
        noise at ``x_pred``."""
        return self.posterior.posterior_covariance(
            x_pred, x_out=x_out, variance_only=variance_only,
            add_noise=add_noise)

    def posterior_mean_grad(self, x_pred, hyperparameters=None, x_out=None,
                            direction=None, component=0):
        """Gradient of the posterior mean with respect to the input:
        ``direction=i`` gives ``dm/dx_i`` (shape ``(M,)``), ``None`` all
        directions (``(M, D)``).  Dict with ``"x"``, ``"direction"``,
        ``"dm/dx"``."""
        return self.posterior.posterior_mean_grad(
            x_pred, hyperparameters=hyperparameters, x_out=x_out,
            direction=direction, component=component)

    def posterior_covariance_grad(self, x_pred, x_out=None, direction=None):
        """Gradient of the posterior (co)variance with respect to the input:
        dict with ``"dv/dx"`` and, for one ``direction``, ``"dS/dx"``."""
        return self.posterior.posterior_covariance_grad(
            x_pred, x_out=x_out, direction=direction)

    def joint_gp_prior(self, x_pred, x_out=None):
        """The joint prior over data and prediction points: dict with the
        blocks ``"K"``, ``"k"``, ``"kappa"``, the joint ``"prior mean"``
        and the joint covariance ``"S"``."""
        return self.posterior.joint_gp_prior(x_pred, x_out=x_out)

    def joint_gp_prior_grad(self, x_pred, direction, x_out=None):
        """Input gradient of the joint prior's blocks."""
        return self.posterior.joint_gp_prior_grad(x_pred, direction,
                                                  x_out=x_out)

    def gp_entropy(self, x_pred, x_out=None):
        """Differential entropy of the joint prior over data and
        prediction points."""
        return self.posterior.gp_entropy(x_pred, x_out=x_out)

    def gp_entropy_grad(self, x_pred, direction, x_out=None):
        """Input-direction gradient of :meth:`gp_entropy`."""
        return self.posterior.gp_entropy_grad(x_pred, direction, x_out=x_out)

    def gp_kl_div(self, x_pred, comp_mean, comp_cov, x_out=None):
        """KL divergence between the posterior at ``x_pred`` and
        ``N(comp_mean, comp_cov)``: dict with ``"kl-div"`` and the moments
        used."""
        return self.posterior.gp_kl_div(x_pred, comp_mean, comp_cov,
                                        x_out=x_out)

    def gp_mutual_information(self, x_pred, x_out=None, add_noise=False):
        """Mutual information between the data and the prediction points
        under the joint prior."""
        return self.posterior.gp_mutual_information(x_pred, x_out=x_out,
                                                    add_noise=add_noise)

    def gp_total_correlation(self, x_pred, x_out=None, add_noise=False):
        """Total correlation of data and prediction points under the joint
        prior."""
        return self.posterior.gp_total_correlation(x_pred, x_out=x_out,
                                                   add_noise=add_noise)

    def gp_relative_information_entropy(self, x_pred, x_out=None,
                                        add_noise=False):
        """KL divergence of the posterior from the prior at ``x_pred``:
        dict with ``"RIE"``."""
        return self.posterior.gp_relative_information_entropy(
            x_pred, x_out=x_out, add_noise=add_noise)

    def gp_relative_information_entropy_set(self, x_pred, x_out=None,
                                            add_noise=False):
        """One relative information entropy per prediction point, each
        point a set of its own."""
        return self.posterior.gp_relative_information_entropy_set(
            x_pred, x_out=x_out, add_noise=add_noise)

    def posterior_probability(self, x_pred, comp_mean, comp_cov, x_out=None):
        """Probability that the posterior and ``N(comp_mean, comp_cov)``
        describe the same function values: dict with the fused ``"mu"``,
        ``"covariance"`` and ``"probability"``."""
        return self.posterior.posterior_probability(x_pred, comp_mean,
                                                    comp_cov, x_out=x_out)

    # ----------------------------------------------------------------------
    # validation metrics
    # ----------------------------------------------------------------------
    @staticmethod
    def _crps_s(x, mu, sigma):
        res = abs(sigma * ((1. / np.sqrt(np.pi))
                           - 2. * norm.pdf((x - mu) / sigma)
                           - (((x - mu) / sigma)
                              * (2. * norm.cdf((x - mu) / sigma) - 1.))))
        return np.mean(res), np.sqrt(np.var(res))

    def crps(self, x_test, y_test):
        """Continuous ranked probability score: (mean, standard
        deviation)."""
        mean = self.posterior_mean(x_test)["m(x)"]
        sigma = np.sqrt(self.posterior_covariance(x_test)["v(x)"])
        if not (mean.shape == sigma.shape == y_test.shape):
            raise AssertionError(f"crps: shape mismatch mean={mean.shape} "
                                 f"sigma={sigma.shape} y_test={y_test.shape}")
        return self._crps_s(y_test, mean, sigma)

    def rmse(self, x_test, y_test):
        """Root mean squared error of the posterior mean."""
        v1, v2 = y_test, self.posterior_mean(x_test)["m(x)"]
        if v1.shape != v2.shape:
            raise AssertionError(f"rmse: y_test shape {v1.shape} != "
                                 f"posterior mean shape {v2.shape}")
        return np.sqrt(np.sum((v1 - v2) ** 2) / v1.size)

    def nrmse(self, x_test, y_test):
        """RMSE over the range of ``y_test``."""
        return self.rmse(x_test, y_test) / (np.max(y_test) - np.min(y_test))

    def nlpd(self, x_test, y_test):
        """Negative log predictive density."""
        mean = self.posterior_mean(x_test)["m(x)"]
        v = self.posterior_covariance(x_test)["v(x)"]
        if not (mean.shape == v.shape == y_test.shape):
            raise AssertionError(f"nlpd: shape mismatch mean={mean.shape} "
                                 f"v={v.shape} y_test={y_test.shape}")
        return np.mean(0.5 * np.log(2 * np.pi * v)
                       + 0.5 * ((y_test - mean) ** 2) / v)

    def r2(self, x_test, y_test):
        """R² prediction score of the posterior mean."""
        y_pred = self.posterior_mean(x_test)["m(x)"]
        if y_pred.shape != y_test.shape:
            raise AssertionError(f"r2: y_test shape {y_test.shape} != "
                                 f"posterior mean shape {y_pred.shape}")
        ss_res = np.sum((y_test - y_pred) ** 2)
        ss_tot = np.sum((y_test - np.mean(y_test)) ** 2)
        return 1. - ss_res / ss_tot

    def picp(self, x_test, y_true, interval=0.95):
        """Prediction-interval coverage probability (noise included)."""
        mu = self.posterior_mean(x_test)["m(x)"]
        y_true = np.asarray(y_true)
        if y_true.shape != np.asarray(mu).shape:
            # a (M, 1) against (M,) broadcast would average M² pairs
            raise AssertionError(f"y shape {y_true.shape} does not match "
                                 f"posterior mean shape "
                                 f"{np.asarray(mu).shape}")
        sigma = np.sqrt(self.posterior_covariance(x_test,
                                                  add_noise=True)["v(x)"])
        z = norm.ppf(1 - (1 - interval) / 2)
        lower, upper = mu - z * sigma, mu + z * sigma
        return np.mean((y_true >= lower) & (y_true <= upper))

    def coverage_curve(self, x_test, y_test, intervals=None):
        """Measured against target coverage over interval levels."""
        if intervals is None:
            intervals = np.linspace(0.05, 0.95, 19)
        return {"target_coverage": list(intervals),
                "measured_coverage": [self.picp(x_test, y_test, interval=q)
                                      for q in intervals]}

    def mpiw(self, x_test, interval=0.95):
        """Mean prediction-interval width (noise included)."""
        v = self.posterior_covariance(x_test, add_noise=True)["v(x)"]
        sigma = np.sqrt(np.clip(v, 0.0, None))
        z = norm.ppf(1 - (1 - interval) / 2)
        return np.mean(2 * z * sigma)

    def interval_score(self, x_test, y_test, interval=0.95):
        """Winkler interval score (noise included)."""
        mean = self.posterior_mean(x_test)["m(x)"]
        sigma = np.sqrt(self.posterior_covariance(x_test,
                                                  add_noise=True)["v(x)"])
        if not (mean.shape == sigma.shape == y_test.shape):
            raise AssertionError(f"interval_score: shape mismatch "
                                 f"mean={mean.shape} sigma={sigma.shape} "
                                 f"y_test={y_test.shape}")
        alpha = 1 - interval
        z = norm.ppf(1 - alpha / 2)
        lower, upper = mean - z * sigma, mean + z * sigma
        penalty_low = (2 / alpha) * np.maximum(lower - y_test, 0)
        penalty_high = (2 / alpha) * np.maximum(y_test - upper, 0)
        return np.mean(upper - lower + penalty_low + penalty_high)

    def mae(self, x_test, y_test):
        """Mean absolute error of the posterior mean."""
        v1, v2 = y_test, self.posterior_mean(x_test)["m(x)"]
        if v1.shape != v2.shape:
            raise AssertionError(f"mae: y_test shape {v1.shape} != "
                                 f"posterior mean shape {v2.shape}")
        return np.mean(np.abs(v1 - v2))

    def mape(self, x_test, y_test):
        """Mean absolute percentage error of the posterior mean."""
        v1, v2 = y_test, self.posterior_mean(x_test)["m(x)"]
        if v1.shape != v2.shape:
            raise AssertionError(f"mape: y_test shape {v1.shape} != "
                                 f"posterior mean shape {v2.shape}")
        return np.mean(np.abs((v1 - v2) / v1))

    def msll(self, x_test, y_test):
        """Mean standardized log loss: the NLPD less that of a Gaussian
        with the data's mean and variance."""
        mean = self.posterior_mean(x_test)["m(x)"]
        v = self.posterior_covariance(x_test)["v(x)"]
        if not (mean.shape == v.shape == y_test.shape):
            raise AssertionError(f"msll: shape mismatch mean={mean.shape} "
                                 f"v={v.shape} y_test={y_test.shape}")
        nlpd_gp = np.mean(0.5 * np.log(2 * np.pi * v)
                          + 0.5 * ((y_test - mean) ** 2) / v)
        baseline_mean = np.mean(self.y_data)
        baseline_var = np.var(self.y_data)
        nlpd_baseline = np.mean(0.5 * np.log(2 * np.pi * baseline_var)
                                + 0.5 * ((y_test - baseline_mean) ** 2)
                                / baseline_var)
        return nlpd_gp - nlpd_baseline

    def plot_observed_vs_predicted(self, x_test, y_test, title=None, ax=None):
        """Observed-vs-predicted scatter with 1σ bars (needs matplotlib;
        warns and draws nothing without it)."""
        try:
            import matplotlib.pyplot as plt
        except ImportError:
            warnings.warn("matplotlib is not installed; cannot create "
                          "observed-vs-predicted plot.")
            return
        y_pred = self.posterior_mean(x_test)["m(x)"]
        y_var = self.posterior_covariance(x_test, add_noise=True)["v(x)"]
        y_obs_flat = np.asarray(y_test).reshape(-1)
        y_pred_flat = np.asarray(y_pred).reshape(-1)
        y_sigma_flat = np.sqrt(np.clip(np.asarray(y_var).reshape(-1), 0.0,
                                       None))
        if ax is None:
            _, ax = plt.subplots(figsize=(6, 6))
        ax.errorbar(y_obs_flat, y_pred_flat, yerr=y_sigma_flat, fmt="o",
                    alpha=0.6, markersize=4, capsize=2, elinewidth=0.8,
                    label="prediction ± 1σ")
        lo = float(min(y_obs_flat.min(), (y_pred_flat - y_sigma_flat).min()))
        hi = float(max(y_obs_flat.max(), (y_pred_flat + y_sigma_flat).max()))
        ax.plot([lo, hi], [lo, hi], "k--", linewidth=1, label="y = x")
        ax.set_xlabel("Observed")
        ax.set_ylabel("Predicted")
        if title is not None:
            ax.set_title(title)
        ax.set_aspect("equal", adjustable="box")
        ax.legend(loc="best")

    @staticmethod
    def gaussian_1d(x, mu, sigma):
        coefficient = 1.0 / (np.sqrt(2 * np.pi) * sigma)
        exponent = -((x - mu) ** 2) / (2 * sigma ** 2)
        return coefficient * np.exp(exponent)

    @staticmethod
    def make_2d_x_pred(bx, by, resx=100, resy=100):
        from itertools import product
        x = np.linspace(bx[0], bx[1], resx)
        y = np.linspace(by[0], by[1], resy)
        return np.array(list(product(x, y)))

    @staticmethod
    def make_1d_x_pred(b, res=100):
        return np.linspace(b[0], b[1], res).reshape(res, -1)

    def get_gp2Scale_exec_time(self, time_per_worker_execution,
                               number_of_workers):
        """The covariance's wall-clock cost model
        t = N²·t_block / (2·workers·batch²)."""
        b = self.prior.batch_size
        D = len(self.x_data)
        return (D ** 2 * time_per_worker_execution) \
            / (2. * number_of_workers * b ** 2)

    def __getattr__(self, name):
        # the rest of the JAX GP surface arrives slice by slice
        if name in _NOT_PORTED:
            raise NotPortedError(
                f"fvgp_tpu_torch: GP.{name} is not ported yet (ROADMAP item "
                f"{_NOT_PORTED[name]})")
        raise AttributeError(name)


class NotPortedError(NotImplementedError, AttributeError):
    """A part of the JAX package's GP surface that the port does not have
    yet (also an AttributeError, so ``hasattr`` stays False)."""


# names of the JAX GP surface the port does not serve, each with the ROADMAP
# item that brings it (none since item 1.5)
_NOT_PORTED = {}
