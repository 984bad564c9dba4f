"""GP facade — the single-task user API on PyTorch (counterpart of
``fvgp_tpu/models/gp.py``).

``GP(x, y)`` is the dense exact GP on the card: the default Matérn-3/2 ARD
kernel (its covariances built by the K3 kernel), the ``Chol`` / ``CholInv``
/ ``Inv`` factorizations, the autograd LML + gradient, ``train`` with
``"global"``, ``"local"`` or ``"mcmc"`` (the default), posterior means,
covariances and variances, and ``update_gp_data``.  ``GP(x, y,
gp2Scale=True)`` runs the block-sparse engine: the differentiable mBCG LML
(K1 SpMM) and posterior means and variances through the committed-state
solver (K2 SpMM); off the traced path (``args["gp2Scale_traced_lml"] =
False``, a multi-column y, a prior mean function, ``gp.K``,
``update_gp_data``, a full posterior covariance) it stores the covariance as
a ``BlockSparseMatrix`` and solves against it with the Krylov / SLQ /
preconditioner stack, the stored product again on K1.
``compute_device="cpu"`` runs the same code with the
kernels' plain versions, in float64 by default.  The methods below that
raise ``NotImplementedError`` arrive with the ROADMAP items they name.
"""

import warnings

import numpy as np

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
    ``m(x, hps)`` and noise ``noise(x, hps)`` likewise.
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
        if hyperparameters is None:
            if callable(kernel_function) or callable(prior_mean_function) \
                    or callable(noise_function):
                raise Exception(
                    "You have provided callables for kernel, mean, or noise "
                    "functions but no initial hyperparameters.")
            hyperparameters = np.ones(self.index_set_dim + 1)
            warnings.warn("Hyperparameters initialized to a vector of ones.")

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
              local_optimizer="L-BFGS-B", constraints=(), info=False,
              asynchronous=False, **unported):
        """Find hyperparameters by maximizing the log marginal likelihood
        (or minimizing a user objective), commit them, and return them.

        ``method`` is ``"mcmc"`` (the default: adaptive Metropolis on the
        LML; fills ``mcmc_info``), ``"global"`` (differential evolution,
        ``pop_size`` × H members, the population evaluated in batched
        chunks) or ``"local"`` (scipy ``local_optimizer`` on the fused LML
        value and gradient)."""
        if unported or asynchronous:
            raise NotImplementedError(
                "fvgp_tpu_torch: train options "
                f"{sorted(unported) + (['asynchronous'] if asynchronous else [])}"
                " are not ported yet (ROADMAP item 1.5)")
        if method not in ("global", "local", "mcmc"):
            raise NotImplementedError(
                f"fvgp_tpu_torch: train(method={method!r}) is not ported yet "
                "(ROADMAP item 1.5); use 'global', 'local' or 'mcmc'")
        if self.gp2Scale and method != "mcmc" \
                and not self.marginal_likelihood._sparse_traced_ready():
            # off the traced path the sparse LML has a value and no gradient
            warnings.warn("gp2Scale off the traced LML path (a kernel that "
                          "does not run on tensors, a mean function, a "
                          "multi-column y or gp2Scale_traced_lml=False). "
                          "Method switched to MCMC!")
            method = "mcmc"
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
        ml = self.marginal_likelihood
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
                and method == "local":
            raise Exception("A gradient of the objective function must be "
                            "provided for method='local'.")
        if objective_function_gradient is None:
            objective_function_gradient = ml.neg_log_likelihood_gradient
        fused_vg = batched_objective = None
        if not user_provided_obj and (ml._traced_ready()
                                      or ml._sparse_traced_ready()):
            def fused_vg(hps, _ml=ml):
                val, grad = _ml.log_likelihood_value_and_gradient(hps)
                return -val, -grad
        if not user_provided_obj and ml._traced_ready():
            batched_objective = ml.batched_neg_log_likelihood

        with sequential_linalg_state(self.args, method):
            hyperparameters = self.trainer.train(
                objective_function=objective_function,
                objective_function_gradient=objective_function_gradient,
                objective_function_hessian=objective_function_hessian,
                hyperparameter_bounds=np.asarray(hyperparameter_bounds,
                                                 dtype=np.float64),
                init_hyperparameters=np.asarray(init_hyperparameters,
                                                dtype=np.float64),
                method=method, pop_size=pop_size, tolerance=tolerance,
                max_iter=max_iter, local_optimizer=local_optimizer,
                constraints=constraints, mcmc_prior=mcmc_prior,
                mcmc_prop_distrs=mcmc_prop_distrs, mcmc_args=mcmc_args,
                info=info, batched_objective=batched_objective,
                fused_value_and_grad=fused_vg)
            self.set_hyperparameters(hyperparameters)
        return hyperparameters

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

    def joint_gp_prior(self, x_pred, x_out=None):
        """The joint prior over data and prediction points: dict with the
        blocks ``"K"``, ``"k"``, ``"kappa"``, the joint ``"prior mean"``
        and the joint covariance ``"S"``."""
        return self.posterior.joint_gp_prior(x_pred, x_out=x_out)

    # ----------------------------------------------------------------------
    # validation helpers
    # ----------------------------------------------------------------------
    def rmse(self, x_test, y_test):
        """Root mean squared error of the posterior mean."""
        v1, v2 = y_test, self.posterior_mean(x_test)["m(x)"]
        if v1.shape != v2.shape:
            raise AssertionError(f"rmse: y_test shape {v1.shape} != "
                                 f"posterior mean shape {v2.shape}")
        return np.sqrt(np.sum((v1 - v2) ** 2) / v1.size)

    def r2(self, x_test, y_test):
        """R² prediction score of the posterior mean."""
        y_pred = self.posterior_mean(x_test)["m(x)"]
        if y_pred.shape != y_test.shape:
            raise AssertionError(f"r2: y_test shape {y_test.shape} != "
                                 f"posterior mean shape {y_pred.shape}")
        ss_res = np.sum((y_test - y_pred) ** 2)
        ss_tot = np.sum((y_test - np.mean(y_test)) ** 2)
        return 1. - ss_res / ss_tot

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


_NOT_PORTED = {
    **dict.fromkeys(("bo_info", "stop_training", "kill_client",
                     "update_hyperparameters"), "1.5"),
    **dict.fromkeys(("posterior_mean_grad", "posterior_covariance_grad",
                     "joint_gp_prior_grad", "gp_entropy",
                     "gp_entropy_grad", "gp_kl_div", "gp_mutual_information",
                     "gp_total_correlation", "gp_relative_information_entropy",
                     "gp_relative_information_entropy_set",
                     "posterior_probability"), "1.2"),
    **dict.fromkeys(("crps", "nrmse", "nlpd", "picp", "coverage_curve",
                     "mpiw", "interval_score", "mae", "mape", "msll",
                     "plot_observed_vs_predicted", "gaussian_1d"), "1.6"),
}
