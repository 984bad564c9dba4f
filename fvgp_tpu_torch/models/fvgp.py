"""fvGP — the multi-task GP facade (counterpart of
``fvgp_tpu/models/fvgp.py``).

A multi-task GP over X × {0..No-1} is a single-task GP over the product of
input and output space: each (V, No) observation row is flattened into
task-augmented points ``[x, task]``, skipping NaN entries (missing tasks).
Everything else — training, posteriors, metrics, gp2Scale, pickling — is
inherited from ``GP``; posteriors take ``x_out`` (task indices) and are
reshaped task-major (flat index k = point + V·task).  The default kernel
sees the task index as its last input column, so on the card its
covariances run on the K3 kernel at D + 1 columns.
"""

import numpy as np

from .gp import GP


class fvGP(GP):
    """Multi-task Gaussian process.

    ``x_data`` is a ``(V, D)`` array (or a list of V objects on a
    non-Euclidean input space: each augmented point is then the pair
    ``[object, task]``), ``y_data`` a ``(V, No)`` array with ``No >= 2``
    where ``np.nan`` marks a task not observed at that input, and
    ``noise_variances`` (optional) a ``(V, No)`` array aligned with it.
    The default kernel sees ``index_set_dim = D + 1`` and takes ``D + 2``
    hyperparameters.  The untransformed data stay available as
    ``fvgp_x_data``, ``fvgp_y_data`` and ``fvgp_noise_variances``;
    ``x_data`` / ``y_data`` are the flattened product-space view the model
    trains on.  Other parameters are ``GP``'s, ``compute_device`` the card
    by default."""

    def __init__(self, x_data, y_data, init_hyperparameters=None,
                 noise_variances=None, compute_device="cuda",
                 kernel_function=None, kernel_function_grad=None,
                 noise_function=None, noise_function_grad=None,
                 prior_mean_function=None, prior_mean_function_grad=None,
                 gp2Scale=False, dask_client=None, gp2Scale_batch_size=10000,
                 gp2Scale_distribution="blockwise", linalg_mode=None,
                 ram_economy=False, args=None):
        if isinstance(y_data, np.ndarray) and y_data.ndim == 1:
            raise ValueError("The output number is 1, you can use the GP "
                             "class for single-task GPs")
        self.output_num = y_data.shape[1]
        if len(x_data) != len(y_data):
            raise AssertionError("x_data and y_data have different lengths")
        fvgp_x_data, fvgp_y_data = x_data, y_data
        fvgp_noise_variances = noise_variances
        x_data, y_data, noise_variances = self._transform_index_set2(
            x_data, y_data, noise_variances)
        super().__init__(
            x_data, y_data, init_hyperparameters=init_hyperparameters,
            noise_variances=noise_variances, compute_device=compute_device,
            kernel_function=kernel_function,
            kernel_function_grad=kernel_function_grad,
            prior_mean_function=prior_mean_function,
            prior_mean_function_grad=prior_mean_function_grad,
            noise_function=noise_function,
            noise_function_grad=noise_function_grad,
            gp2Scale=gp2Scale, dask_client=dask_client,
            gp2Scale_batch_size=gp2Scale_batch_size,
            gp2Scale_distribution=gp2Scale_distribution,
            linalg_mode=linalg_mode, ram_economy=ram_economy, args=args)
        self.data.set_fvgp_data(fvgp_x_data, fvgp_y_data,
                                fvgp_noise_variances,
                                np.arange(0, self.output_num))

    @property
    def fvgp_x_data(self):
        """Multi-task input data (without the task column)."""
        return self.data.fvgp_x_data

    @property
    def fvgp_y_data(self):
        """Observed values in multi-task layout, shape (V, No)."""
        return self.data.fvgp_y_data

    @property
    def fvgp_noise_variances(self):
        """Point-wise noise variances in multi-task layout, or None."""
        return self.data.fvgp_noise_variances

    # ------------------------------------------------------------------
    def update_gp_data(self, x_new, y_new, noise_variances_new=None,
                       append=True, rank_n_update=None):
        """Append or overwrite multi-task data; NaN entries of ``y_new``
        mark missing tasks.  The new data are transformed and handed to
        ``GP.update_gp_data`` first, so a validation failure there leaves
        the multi-task bookkeeping untouched."""
        if not isinstance(x_new, (np.ndarray, list)):
            raise AssertionError("Wrong format in x_new.")
        if not isinstance(y_new, np.ndarray):
            raise AssertionError("Wrong format in y_new.")
        if len(x_new) != len(y_new):
            raise AssertionError("updated x and y do not have the same "
                                 "lengths.")
        if append and noise_variances_new is not None \
                and not isinstance(noise_variances_new, np.ndarray):
            raise AssertionError("noise_variances_new must be np.ndarray")
        x_data, y_data, noise_variances = self._transform_index_set2(
            x_new, y_new, noise_variances_new)
        super().update_gp_data(x_data, y_data, noise_variances, append=append,
                               rank_n_update=rank_n_update)
        if append:
            fvgp_noise_variances = self.fvgp_noise_variances \
                if noise_variances_new is None \
                else np.vstack([self.fvgp_noise_variances,
                                noise_variances_new])
            fvgp_x_data = np.vstack([self.fvgp_x_data, x_new]) \
                if isinstance(x_new, np.ndarray) else self.fvgp_x_data + x_new
            fvgp_y_data = np.vstack([self.fvgp_y_data, y_new])
        else:
            fvgp_noise_variances = noise_variances_new
            fvgp_x_data, fvgp_y_data = x_new, y_new
        self.data.set_fvgp_data(fvgp_x_data, fvgp_y_data,
                                fvgp_noise_variances,
                                np.arange(0, self.output_num))

    # ------------------------------------------------------------------
    def _transform_index_set2(self, x_data, y_data, noise_variances):
        """Flatten (V, No) observations into task-augmented points
        ``[x, task]`` in task-major order (every observed point of task 0,
        then task 1, ...), skipping NaNs."""
        if not isinstance(x_data, (np.ndarray, list)):
            raise AssertionError("x_data must be np.ndarray or list")
        if not isinstance(y_data, np.ndarray):
            raise AssertionError("y_data must be np.ndarray")
        if len(x_data) != len(y_data):
            raise AssertionError("x_data and y_data have different lengths")
        if noise_variances is not None \
                and len(noise_variances) != len(y_data):
            raise AssertionError("noise_variances and y_data have different "
                                 "lengths")
        if not (y_data.ndim == 2 and y_data.shape[1] == self.output_num):
            raise AssertionError(
                f"y_data must be (V, {self.output_num}) for output_num="
                f"{self.output_num}; got shape {y_data.shape}")
        if noise_variances is not None and not (
                noise_variances.ndim == 2
                and noise_variances.shape[1] == self.output_num):
            raise AssertionError(
                f"noise_variances must be (V, {self.output_num}); got shape "
                f"{np.shape(noise_variances)}")
        # nonzero of the transposed mask yields the task-major order
        task_i, point_j = np.nonzero(~np.isnan(y_data).T)
        new_y_data = y_data[point_j, task_i]
        new_variances = None if noise_variances is None \
            else np.asarray(noise_variances)[point_j, task_i]
        if isinstance(x_data, np.ndarray):
            new_x_data = np.column_stack(
                [x_data[point_j], task_i.astype(np.result_type(
                    x_data.dtype, np.float64), copy=False)])
        else:
            new_x_data = [[x_data[j], int(i)]
                          for i, j in zip(task_i, point_j)]
        return new_x_data, new_y_data, new_variances
