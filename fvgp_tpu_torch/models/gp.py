"""GP facade — the single-task user API on PyTorch (counterpart of
``fvgp_tpu/models/gp.py``), gp2Scale path.

``GP(x, y, gp2Scale=True, compute_device="cuda")`` runs the block-sparse
engine on the card: the differentiable mBCG LML (K1 SpMM), ``train(method=
"local")``, and posterior means and variances through the committed-state
solver (K2 SpMM).  ``compute_device="cpu"`` runs the same code with the
kernels' plain versions, in float64 by default.  The dense path
(``gp2Scale=False``) and the methods below that raise
``NotImplementedError`` arrive with the ROADMAP items they name.
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
    """Single-task Gaussian process, gp2Scale (block-sparse) path.

    Parameters follow the JAX package's ``GP``.  ``compute_device`` is
    ``"cpu"`` or ``"cuda"``/``"gpu"`` and decides where every tensor lives;
    asking for a card that is not there raises.  ``args["dtype"]`` sets the
    solve dtype (default float64 on the CPU, float32 on CUDA);
    ``args["gp2Scale_solver_dtype"] = "bfloat16"`` streams the covariance
    tiles in bfloat16 through the kernels.  Kernels are torch callables
    ``k(x1, x2, hps)`` that broadcast over a leading batch dimension
    (default: the anisotropic Wendland kernel).
    """

    def __init__(self, x_data, y_data, init_hyperparameters=None,
                 noise_variances=None, compute_device="cpu",
                 kernel_function=None, kernel_function_grad=None,
                 noise_function=None, noise_function_grad=None,
                 prior_mean_function=None, prior_mean_function_grad=None,
                 gp2Scale=False, dask_client=None, gp2Scale_batch_size=10000,
                 gp2Scale_distribution="blockwise", linalg_mode=None,
                 ram_economy=False, args=None):
        if not gp2Scale:
            raise NotImplementedError(
                "fvgp_tpu_torch: the dense GP path (gp2Scale=False) is not "
                "ported yet (ROADMAP item 1.2)")
        if not (isinstance(noise_variances, np.ndarray)
                or noise_variances is None):
            raise AssertionError("wrong format in noise_variances")
        if not (init_hyperparameters is None
                or isinstance(init_hyperparameters, np.ndarray)):
            raise AssertionError("wrong init_hyperparameters")
        if not isinstance(compute_device, str):
            raise AssertionError("wrong format in compute_device")
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
            if callable(kernel_function):
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

    def set_args(self, new_args):
        """Change the advanced-settings dict (cached state is kept)."""
        self.args = new_args

    def set_hyperparameters(self, hps):
        """Commit a hyperparameter vector and refresh the dependent state."""
        if not (isinstance(hps, np.ndarray) and hps.ndim == 1):
            raise AssertionError("wrong format in hyperparameters")
        self.trainer.hyperparameters = np.asarray(hps, dtype=np.float64)
        self.likelihood.update_state()
        self.kv.update_state_hyperparameters()

    def update_gp_data(self, *args, **kwargs):
        raise NotImplementedError(
            "fvgp_tpu_torch: update_gp_data is not ported yet (ROADMAP item "
            "1.3)")

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
              method="local", tolerance=0.0001, max_iter=10000,
              local_optimizer="L-BFGS-B", constraints=(), info=False,
              **unported):
        """Maximize the log marginal likelihood (or minimize a user
        objective) with ``method="local"`` and commit the result.  Returns
        the trained hyperparameters."""
        if unported:
            raise NotImplementedError(
                f"fvgp_tpu_torch: train options {sorted(unported)} are not "
                "ported yet (ROADMAP item 1.5)")
        if method != "local":
            raise NotImplementedError(
                f"fvgp_tpu_torch: train(method={method!r}) is not ported yet "
                "(ROADMAP item 1.5); use method='local'")
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
        if user_provided_obj and objective_function_gradient is None:
            raise Exception("A gradient of the objective function must be "
                            "provided for method='local'.")
        ml = self.marginal_likelihood
        fused_vg = None
        if not user_provided_obj:
            objective_function = ml.neg_log_likelihood
            objective_function_gradient = ml.neg_log_likelihood_gradient

            def fused_vg(hps, _ml=ml):
                val, grad = _ml.log_likelihood_value_and_gradient(hps)
                return -val, -grad

        with sequential_linalg_state(self.args, method):
            hyperparameters = self.trainer.train(
                objective_function=objective_function,
                objective_function_gradient=objective_function_gradient,
                objective_function_hessian=objective_function_hessian,
                hyperparameter_bounds=np.asarray(hyperparameter_bounds,
                                                 dtype=np.float64),
                init_hyperparameters=np.asarray(init_hyperparameters,
                                                dtype=np.float64),
                method=method, tolerance=tolerance, max_iter=max_iter,
                local_optimizer=local_optimizer, constraints=constraints,
                info=info, fused_value_and_grad=fused_vg)
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

    # ----------------------------------------------------------------------
    def posterior_mean(self, x_pred, hyperparameters=None, x_out=None):
        """Posterior mean ``m(x*) + k(x*, X)ᵀ (K+V)⁻¹ (y − m)``; returns a
        dict with ``"x"``, ``"m(x)"``, ``"m(x)_flat"`` and ``"x_pred"``."""
        return self.posterior.posterior_mean(
            x_pred, hyperparameters=hyperparameters, x_out=x_out)

    def posterior_covariance(self, x_pred, x_out=None, variance_only=False,
                             add_noise=False):
        """Posterior variances (``variance_only=True``); returns a dict with
        ``"v(x)"`` and ``"v_flat"`` (``"S"`` is None)."""
        return self.posterior.posterior_covariance(
            x_pred, x_out=x_out, variance_only=variance_only,
            add_noise=add_noise)

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
    **dict.fromkeys(("mcmc_info", "bo_info", "stop_training", "kill_client",
                     "update_hyperparameters"), "1.5"),
    **dict.fromkeys(("posterior_mean_grad", "posterior_covariance_grad",
                     "joint_gp_prior", "joint_gp_prior_grad", "gp_entropy",
                     "gp_entropy_grad", "gp_kl_div", "gp_mutual_information",
                     "gp_total_correlation", "gp_relative_information_entropy",
                     "gp_relative_information_entropy_set",
                     "posterior_probability", "test_log_likelihood_gradient",
                     "get_prior_pdf"), "1.2"),
    **dict.fromkeys(("crps", "rmse", "nrmse", "nlpd", "r2", "picp",
                     "coverage_curve", "mpiw", "interval_score", "mae",
                     "mape", "msll", "plot_observed_vs_predicted",
                     "gaussian_1d", "make_2d_x_pred", "make_1d_x_pred"),
                    "1.6"),
    **dict.fromkeys(("dask_client", "initialize_gp2Scale_dask_client",
                     "get_hyperparameters", "get_gp2Scale_exec_time"),
                    "1.3"),
}
