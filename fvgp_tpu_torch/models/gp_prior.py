"""Kernel + prior-mean management (counterpart of
``fvgp_tpu/models/gp_prior.py``).

Kernels are torch functions ``k(x1, x2, hps)`` (or with a fourth ``args``
argument, arity sniffed) that broadcast over a leading batch dimension;
means are ``m(x, hps)`` or ``m(x, hps, args)``.  A callable that runs on
torch tensors is "traceable": autograd differentiates it inside the traced
LML, and its hyperparameter derivatives (``dk_dh``, ``dm_dh``) are
forward-mode AD.  A host (numpy) callable takes numpy points and numpy
hyperparameters and returns numpy (a kernel may return ``scipy.sparse``);
its derivatives are central differences evaluated in float64, unless the
user gives ``kernel_function_grad`` / ``prior_mean_function_grad`` (numpy
in; numpy or a tensor out), which win over both.

* Dense (``gp2Scale=False``): the default kernel is the anisotropic
  Matérn-3/2 (``kernels.default_matern_ard``), the default mean the
  constant ``mean(y)``.  K and m are computed eagerly at every commit, with
  tensors that autograd does not record — on the card the default kernel's
  K then comes from the K3 kernel.  An append computes only the new
  (old × new) and (new × new) blocks.  ``args["kernel_dtype"]`` evaluates
  the dense sweeps of a kernel that runs on tensors in that dtype and casts
  them back to the linalg dtype (on the card ``"float32"`` under a float64
  linalg dtype runs K3 in float32; ``"bfloat16"`` takes the plain formula,
  K3 having no bfloat16 route).
* Non-Euclidean inputs (``x_data`` a list of arbitrary objects): a user
  kernel is required; it is a host callable and receives lists (slices of
  the data list, or the prediction list) unchanged.  No device copy of the
  points exists.
* Input derivatives (the posterior gradients): ``d_kernel_dx`` and
  ``dm_dx`` by forward-mode AD of a shift of one input column for callables
  that run on tensors, by forward differences evaluated in float64 for
  host callables; exact zeros for the default mean.
* gp2Scale: the prior is lazy.  The traced sparse LML and the committed
  solver assemble their own tiles; the stored block-sparse covariance
  (``parallel/sharded_cov.distributed_covariance``) is built on first access
  to ``K`` — by the stored-operator solves, a trial evaluation off the
  traced path, or the user.  An append stacks the new (old × new) and
  (new × new) tile sets onto a stored K when the old point count is a
  multiple of the tile size, and recomputes otherwise.  The default kernel
  is the anisotropic Wendland kernel.  Cross covariances against prediction
  points run as chunked dense sweeps where they fit the budget (else as a
  rectangular block-sparse assembly), and the posterior-mean product
  ``kᵀv`` is fused into the sweep so the (N, n_pred) cross covariance never
  exists.
"""

import inspect
import warnings

import numpy as np
import torch
from torch.autograd import forward_ad

from .. import config
from ..kernels import default_matern_ard, wendland_anisotropic

warnings.filterwarnings("once", category=UserWarning,
                        module=r"fvgp_tpu_torch(\..*)?")

_CROSS_ROWS = 8192          # data rows per chunk of the cross sweeps


def _n_params(fn):
    return len(inspect.signature(fn).parameters)


def _dense_cross_scan(kernel_fn, xc, xp, hps):
    """k(x_chunk, x_pred) row-chunk sweep: the (n, n_pred) dense cross
    covariance without any (n, n_pred)-sized kernel intermediates beyond
    the output itself."""
    nch, R = xc.shape[0], xc.shape[1]
    out = torch.empty((nch * R, xp.shape[0]), dtype=xp.dtype,
                      device=xp.device)
    for i in range(nch):
        out[i * R:(i + 1) * R] = kernel_fn(xc[i], xp, hps)
    return out


def _dense_cross_product_scan(kernel_fn, xc, xp, hps, vc):
    """kᵀ·v fused into the row-chunk sweep: k(x_data, x_pred)ᵀ @ v without
    the (n, n_pred) cross covariance; peak extra memory is one (R, n_pred)
    kernel chunk."""
    out = torch.zeros((xp.shape[0], vc.shape[2]), dtype=vc.dtype,
                      device=vc.device)
    for i in range(xc.shape[0]):
        out += kernel_fn(xc[i], xp, hps).T @ vc[i]
    return out


def _host(a):
    """Points for a host callable: a host numpy array of a tensor or an
    array-like; a list (non-Euclidean points) stays the list it is."""
    if isinstance(a, list):
        return a
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _pred_bucket(n_pred):
    """Bucketed prediction count (powers of two, floor 16), as in the JAX
    package, so both pad the prediction set alike."""
    return max(16, 1 << int(n_pred - 1).bit_length())


class GPprior:
    def __init__(self, data, trainer, kernel=None, prior_mean_function=None,
                 kernel_grad=None, prior_mean_function_grad=None,
                 gp2Scale_batch_size=10000, gp2Scale_distribution="blockwise"):
        if gp2Scale_distribution not in ("blockwise", "rowwise"):
            raise AssertionError("gp2Scale_distribution must be `blockwise` "
                                 "or `rowwise`")
        if not (callable(kernel) or kernel is None):
            raise AssertionError("kernel must be callable or None")
        if not (callable(prior_mean_function) or prior_mean_function is None):
            raise AssertionError("prior_mean_function must be callable or "
                                 "None")
        self.data = data
        self.trainer = trainer
        self.batch_size = gp2Scale_batch_size
        hps = self.hyperparameters
        if not (isinstance(hps, np.ndarray) and hps.ndim == 1):
            raise AssertionError("hyperparameters must be a 1-d np.ndarray")
        if not self.Euclidean and not callable(kernel):
            raise Exception("For GPs on non-Euclidean input spaces you need a "
                            "user-defined kernel and initial "
                            "hyperparameters.")

        if self.gp2Scale and not callable(kernel):
            warnings.warn("gp2Scale enabled without a compactly supported "
                          "kernel; using the anisotropic Wendland kernel.",
                          stacklevel=2)
            kernel = wendland_anisotropic
        self.kernel = kernel if callable(kernel) else default_matern_ard
        self.k_n_params = _n_params(self.kernel)
        self._default_mean = not callable(prior_mean_function)
        self.mean_function = (self._default_mean_function
                              if self._default_mean else prior_mean_function)
        self.m_n_params = 2 if self._default_mean \
            else _n_params(prior_mean_function)
        self._user_dk_dh = kernel_grad if callable(kernel_grad) else None
        self._user_dm_dh = prior_mean_function_grad \
            if callable(prior_mean_function_grad) else None
        self._x_dev = None
        self._refresh_device_data()
        self._probe_traceability()
        self._m = None
        self._K = None
        if not self.gp2Scale:
            self.m, self.K = self._compute_prior(self.x_data,
                                                 self.hyperparameters)

    # -- plumbing -----------------------------------------------------------
    @property
    def args(self):
        return self.data.args

    @property
    def device(self):
        return self.data.device

    @property
    def dtype(self):
        return config.linalg_dtype(self.args, self.device)

    @property
    def hyperparameters(self):
        return self.trainer.hyperparameters

    @property
    def x_data(self):
        return self.data.x_data

    @property
    def y_data(self):
        return self.data.y_data

    @property
    def Euclidean(self):
        return self.data.Euclidean

    @property
    def gp2Scale(self):
        return self.data.gp2Scale

    @property
    def ram_economy(self):
        return self.data.ram_economy

    @property
    def x_old(self):
        return self.data.x_old

    @property
    def x_new(self):
        return self.data.x_new

    @property
    def K(self):
        if self._K is None:
            self._m, self._K = self._compute_prior(self.x_data,
                                                   self.hyperparameters)
        return self._K

    @K.setter
    def K(self, value):
        self._K = value

    @property
    def m(self):
        if self._m is None:
            if self.gp2Scale:
                # the mean alone: assembling K here would cost the stored
                # tile set on paths that never read it
                self._m = self.compute_mean(self._x_points(),
                                            self.hyperparameters)
            else:
                self._m, self._K = self._compute_prior(self.x_data,
                                                       self.hyperparameters)
        return self._m

    @m.setter
    def m(self, value):
        self._m = value

    @property
    def traceable(self):
        """True when kernel and mean both run on torch tensors, so the
        whole prior is differentiable by autograd."""
        return self.kernel_traceable and self.mean_traceable

    # ----------------------------------------------------------------------
    def _tensor(self, a, dtype=None):
        return config.to_tensor(a, self.device, dtype or self.dtype)

    def _refresh_device_data(self):
        self._x_dev = self._tensor(self.x_data) if self.Euclidean else None

    def _x_points(self):
        """The data points as the callables take them: the device copy, or
        the list of objects of a non-Euclidean input space."""
        return self._x_dev if self.Euclidean else self.x_data

    def _probe_traceability(self):
        """Decide, once, whether kernel and mean run on torch tensors (the
        "differentiable by autograd" probe; host callables return numpy).
        On a non-Euclidean input space both are host callables."""
        if not self.Euclidean:
            self.kernel_traceable = False
            self.mean_traceable = self._default_mean
            return
        x2 = self._x_dev[: min(2, len(self.x_data))]
        hps = self._tensor(self.hyperparameters)
        self.kernel_traceable = config.returns_tensor(
            lambda x, h: self._apply_kernel(x, x, h), x2, hps)
        self.mean_traceable = self._default_mean or config.returns_tensor(
            self._apply_mean, x2, hps)

    # ----------------------------------------------------------------------
    # state transitions
    # ----------------------------------------------------------------------
    def augment_state_data(self):
        """Append: only the (old × new) and (new × new) blocks are new."""
        self.m, self.K = self._update_prior(self.x_old, self.x_new,
                                            self.hyperparameters)
        self._refresh_device_data()

    def update_state_data(self):
        self._refresh_device_data()
        self.update_state_hyperparameters()

    def update_state_hyperparameters(self):
        if self.gp2Scale:
            self._m = None
            self._K = None
        else:
            self.m, self.K = self._compute_prior(self.x_data,
                                                 self.hyperparameters)

    # ----------------------------------------------------------------------
    # covariance / mean evaluation
    # ----------------------------------------------------------------------
    def _apply_kernel(self, a, b, hps):
        if self.k_n_params == 3:
            return self.kernel(a, b, hps)
        if self.k_n_params == 4:
            return self.kernel(a, b, hps, self.args)
        raise Exception("No valid kernel function signature")

    def _apply_mean(self, x, hps):
        if self.m_n_params == 2:
            return self.mean_function(x, hps)
        if self.m_n_params == 3:
            return self.mean_function(x, hps, self.args)
        raise Exception("No valid mean function signature")

    def compute_covariances(self, x1, x2, hps, dtype=None):
        """Dense kernel evaluation k(x1, x2) as a device tensor in the
        linalg dtype (``x1`` and ``x2`` host arrays or device tensors).  A
        kernel that runs on tensors is evaluated in
        ``config.kernel_compute_dtype``; ``dtype`` (the difference quotients
        take float64) evaluates and returns in that dtype instead."""
        out = dtype or self.dtype
        if not self.kernel_traceable:
            from scipy.sparse import issparse
            K = self._apply_kernel(_host(x1), _host(x2), np.asarray(hps))
            return self._tensor(K.toarray() if issparse(K) else K, out)
        kdt = dtype or config.kernel_compute_dtype(self.args, self.device)
        a, b = (v.to(kdt) if torch.is_tensor(v) else self._tensor(v, kdt)
                for v in (x1, x2))
        return self._apply_kernel(a, b, self._tensor(hps, kdt)).to(out)

    def compute_mean(self, x, hps, dtype=None):
        """Prior mean m(x): the constant mean(y_data) by default; in the
        linalg dtype, or in ``dtype`` where given."""
        out = dtype or self.dtype
        if self._default_mean:
            return self._default_mean_function(x, hps).to(out)
        if self.mean_traceable:
            m = self._apply_mean(x.to(out) if torch.is_tensor(x)
                                 else self._tensor(x, out),
                                 self._tensor(hps, out))
            return m.to(out)
        return self._tensor(self._apply_mean(_host(x), np.asarray(hps)), out)

    def _default_mean_function(self, x, hyperparameters):
        """Constant mean = mean(y_data)."""
        return torch.full((len(x),), float(np.mean(self.y_data)),
                          dtype=self.dtype, device=self.device)

    def compute_prior_covariance_matrix(self, x, hyperparameters):
        """The prior covariance K(x, x): dense, or block-sparse under
        gp2Scale."""
        if self.gp2Scale:
            return self._gp2Scale_covariance(_host(x), _host(x),
                                             hyperparameters, symmetric=True)
        return self.compute_covariances(x, x, hyperparameters)

    def compute_data_cross_covariance(self, x_pred, hyperparameters):
        """k(x_data, x_pred): under gp2Scale above the batch size a chunked
        dense sweep where it fits the budget and the device, else a
        rectangular block-sparse assembly; below it one dense evaluation."""
        if self.gp2Scale and len(self.x_data) > self.batch_size:
            k = self._dense_cross_or_none(x_pred, hyperparameters)
            if k is not None:
                return k
            return self._gp2Scale_covariance(self.x_data, x_pred,
                                             hyperparameters)
        return self.compute_covariances(self._x_points(), x_pred,
                                        hyperparameters)

    def _compute_prior(self, x_data, hyperparameters):
        m = self.compute_mean(self._x_points(), hyperparameters)
        # the block-sparse structure pass reads the host float64 points
        K = self.compute_prior_covariance_matrix(
            x_data if self.gp2Scale else self._x_points(), hyperparameters)
        if m.dim() != 1:
            raise AssertionError("mean function returned non-1-d result")
        return m, K

    def _update_prior(self, x_old, x_new, hyperparameters):
        """Append path: only the B (old × new) and D (new × new) blocks are
        computed."""
        if self._default_mean:
            m = self.compute_mean(self.x_data, hyperparameters)
        else:
            m = torch.cat([self.m, self.compute_mean(x_new, hyperparameters)])
        if self.gp2Scale:
            return m, self._stacked_gp2Scale_K(x_old, x_new, hyperparameters)
        B = self.compute_covariances(x_old, x_new, hyperparameters)
        D = self.compute_covariances(x_new, x_new, hyperparameters)
        K = torch.cat([torch.cat([self.K, B], dim=1),
                       torch.cat([B.T, D], dim=1)], dim=0)
        return m, K

    def _stacked_gp2Scale_K(self, x_old, x_new, hyperparameters):
        """The stored K after an append, or None (stay lazy) when no K of
        the old data is stored: [[K, B], [Bᵀ, D]] stacked from the new tile
        sets when the old point count is a multiple of the tile size, a full
        recompute otherwise.  A row-owned K (a mesh of more than one rank)
        is recomputed too: the ranks' row ranges move when the block count
        grows, so old tiles would have to cross ranks; the recompute gives
        the matrix the stack gives."""
        K_old = self._K
        if K_old is None or K_old.n != len(x_old):
            return None
        from ..parallel.block_sparse import stack_augmented_covariance
        if K_old.n % K_old.block_size != 0 or K_old.mesh is not None:
            # append grid misaligned with the tile size, or row-owned:
            # recompute fully
            return self.compute_prior_covariance_matrix(self.x_data,
                                                        hyperparameters)
        B = self._gp2Scale_covariance(x_old, x_new, hyperparameters)
        D = self._gp2Scale_covariance(x_new, x_new, hyperparameters,
                                      symmetric=True)
        return stack_augmented_covariance(K_old, B, D)

    def _gp2Scale_covariance(self, x1, x2, hyperparameters, symmetric=False):
        """The block-sparse covariance k(x1, x2) on the model's device.  A
        symmetric one is the stored K, which under a mesh of more than one
        rank is row-owned (each rank holds its row blocks' tiles); a cross
        covariance is whole on every rank."""
        from ..parallel.mesh import current_mesh, tile_device_count
        from ..parallel.sharded_cov import distributed_covariance
        mesh = current_mesh() if symmetric else None
        if mesh is not None and tile_device_count(mesh) <= 1:
            mesh = None
        return distributed_covariance(
            self, x1, x2, hyperparameters, batch_size=self.batch_size,
            symmetric=symmetric, args=self.args, mesh=mesh)

    def _cross_scan_inputs(self, x_pred, hyperparameters):
        """(xc, xp_padded, hps, n_pred) for the chunked cross scans —
        x_pred padded to its bucket."""
        n = len(self.x_data)
        R = _CROSS_ROWS
        n_pad = -(-n // R) * R
        xd = torch.nn.functional.pad(self._x_dev, (0, 0, 0, n_pad - n))
        xc = xd.reshape(n_pad // R, R, -1)
        n_pred = len(x_pred)
        xp = np.zeros((_pred_bucket(n_pred), x_pred.shape[1]))
        xp[:n_pred] = x_pred
        return xc, self._tensor(xp), self._tensor(hyperparameters), n_pred

    def _kernel_fn(self):
        from ..parallel.sharded_cov import _stable_kernel_closure
        return _stable_kernel_closure(self)

    def _dense_cross_or_none(self, x_pred, hyperparameters):
        """Chunked dense k(x_data, x_pred), or None when it would not fit
        the memory budget or the device."""
        if not (self.kernel_traceable and isinstance(x_pred, np.ndarray)):
            return None
        n = len(self.x_data)
        budget = int(self.args.get("gp2Scale_dense_cross_budget", 4 << 30))
        item = torch.finfo(self.dtype).bits // 8
        if n * _pred_bucket(max(len(x_pred), 1)) * item > budget:
            return None
        xc, xp, hps, n_pred = self._cross_scan_inputs(x_pred,
                                                      hyperparameters)
        try:
            out = _dense_cross_scan(self._kernel_fn(), xc, xp, hps)
        except torch.cuda.OutOfMemoryError:
            warnings.warn("gp2Scale dense cross-covariance sweep exhausted "
                          "device memory (lower "
                          "args['gp2Scale_dense_cross_budget'])")
            return None
        return out[:n, :n_pred]

    def cross_covariance_product_or_none(self, x_pred, hyperparameters, vec):
        """k(x_data, x_pred)ᵀ @ vec fused into the chunked kernel sweep, or
        None when the per-chunk kernel block would exceed the budget."""
        if not (self.kernel_traceable and isinstance(x_pred, np.ndarray)):
            return None
        budget = int(self.args.get("gp2Scale_dense_cross_budget", 4 << 30))
        item = torch.finfo(self.dtype).bits // 8
        if _CROSS_ROWS * _pred_bucket(max(len(x_pred), 1)) * item > budget:
            return None
        xc, xp, hps, n_pred = self._cross_scan_inputs(x_pred,
                                                      hyperparameters)
        nch, R = xc.shape[0], xc.shape[1]
        v = config.tensor_operand(vec, self.device, self.dtype)
        if v.dim() == 1:
            v = v[:, None]
        vpad = torch.zeros((nch * R, v.shape[1]), dtype=v.dtype,
                           device=v.device)
        vpad[:v.shape[0]] = v
        out = _dense_cross_product_scan(self._kernel_fn(), xc, xp, hps,
                                        vpad.reshape(nch, R, -1))
        return out[:n_pred]

    # ----------------------------------------------------------------------
    # hyperparameter derivatives (the formula gradient)
    # ----------------------------------------------------------------------
    def dk_dh(self, x1, x2, hyperparameters, direction=None):
        """∂k(x1, x2)/∂hps as an (H, n1, n2) device tensor, or the (n1, n2)
        slice of one ``direction``: the user's ``kernel_function_grad``
        (``(x1, x2, hps)``, or ``(x1, x2, hps, direction)`` under
        ``ram_economy``), else forward-mode AD of a kernel that runs on
        tensors, else central differences of a host kernel."""
        if self._user_dk_dh is not None:
            hps = np.asarray(hyperparameters, dtype=np.float64)
            a, b = _host(x1), _host(x2)
            g = self._user_dk_dh(a, b, hps, direction) if self.ram_economy \
                else self._user_dk_dh(a, b, hps)
            return self._tensor(g)
        if self.kernel_traceable:
            a, b = self._tensor(x1), self._tensor(x2)
            return config.hps_jacobian(
                lambda h: self._apply_kernel(a, b, h),
                self._tensor(hyperparameters), direction).to(self.dtype)
        if direction is not None:
            return self._fd_dk_dh(x1, x2, hyperparameters, direction)
        return torch.stack([self._fd_dk_dh(x1, x2, hyperparameters, i)
                            for i in range(len(hyperparameters))])

    def _fd_dk_dh(self, x1, x2, hyperparameters, direction):
        """Central difference of a host kernel in one direction, with the
        JAX package's step ``1e-6·max(1, |h_i|)`` (near the float64 optimum
        cbrt(eps), scaled by the hyperparameter's magnitude), taken in
        float64 whatever the linalg dtype."""
        h0 = float(np.asarray(hyperparameters, np.float64)[direction])
        eps = 1e-6 * max(1.0, abs(h0))
        h1 = np.array(hyperparameters, dtype=np.float64)
        h2 = np.array(hyperparameters, dtype=np.float64)
        h1[direction] += eps
        h2[direction] -= eps
        f64 = torch.float64
        return ((self.compute_covariances(x1, x2, h1, f64)
                 - self.compute_covariances(x1, x2, h2, f64))
                / (2.0 * eps)).to(self.dtype)

    def dm_dh(self, x, hyperparameters):
        """∂m(x)/∂hps as an (H, n) device tensor: the user's
        ``prior_mean_function_grad(x, hps)``, else exact zeros for the
        default mean, forward-mode AD of a mean that runs on tensors, or
        central differences (step 1e-6, in float64) of a host mean."""
        H = len(hyperparameters)
        if self._user_dm_dh is not None:
            return self._tensor(self._user_dm_dh(
                _host(x), np.asarray(hyperparameters, dtype=np.float64)))
        if self._default_mean:
            return torch.zeros((H, len(x)), dtype=self.dtype,
                               device=self.device)
        if self.mean_traceable:
            a = self._tensor(x)
            return config.hps_jacobian(
                lambda h: self._apply_mean(a, h),
                self._tensor(hyperparameters)).to(self.dtype)
        eps = 1e-6
        f64 = torch.float64
        rows = []
        for i in range(H):
            h1 = np.array(hyperparameters, dtype=np.float64)
            h2 = np.array(hyperparameters, dtype=np.float64)
            h1[i] += eps
            h2[i] -= eps
            rows.append((self.compute_mean(x, h1, f64)
                         - self.compute_mean(x, h2, f64)) / (2 * eps))
        return torch.stack(rows).to(self.dtype)

    # ----------------------------------------------------------------------
    # input derivatives (posterior gradients)
    # ----------------------------------------------------------------------
    @staticmethod
    def _shift_tangent(fn, x, direction):
        """d fn(x + s·e_direction)/ds at s = 0, by forward-mode AD (the
        JAX package's ``jacfwd`` of a shifted input column)."""
        e = torch.zeros(x.shape[1], dtype=x.dtype, device=x.device)
        e[direction] = 1.0
        with forward_ad.dual_level():
            s = forward_ad.make_dual(
                torch.zeros((), dtype=x.dtype, device=x.device),
                torch.ones((), dtype=x.dtype, device=x.device))
            primal, tangent = forward_ad.unpack_dual(fn(x + s * e))
        return torch.zeros_like(primal) if tangent is None else tangent

    def d_kernel_dx(self, x1, x2, direction, hyperparameters):
        """∂k(x1, x2)/∂x1[:, direction] as an (n1, n2) device tensor: exact
        by forward-mode AD for a kernel that runs on tensors, a forward
        difference (step 1e-8, evaluated in float64) for a host kernel."""
        if self.kernel_traceable:
            a, b = (v if torch.is_tensor(v) else self._tensor(v)
                    for v in (x1, x2))
            hps = self._tensor(hyperparameters)
            return self._shift_tangent(lambda xs: self._apply_kernel(xs, b,
                                                                    hps),
                                       a, direction).to(self.dtype)
        eps = 1e-8
        x1s = np.array(_host(x1), dtype=np.float64)
        x1s[:, direction] += eps
        f64 = torch.float64
        return ((self.compute_covariances(x1s, x2, hyperparameters, f64)
                 - self.compute_covariances(x1, x2, hyperparameters, f64))
                / eps).to(self.dtype)

    def kernel_dx_product(self, x_pred, direction, hyperparameters, v):
        """``d_kernel_dx(x_pred, x_data, direction) @ v`` summed over row
        chunks of the data, so the (n_pred, N) derivative never exists
        whole (the posterior mean's fused sweep, for its gradient)."""
        out = None
        for s in range(0, len(self.x_data), _CROSS_ROWS):
            part = self.d_kernel_dx(x_pred, self._x_dev[s:s + _CROSS_ROWS],
                                    direction, hyperparameters) \
                @ v[s:s + _CROSS_ROWS].to(self.dtype)
            out = part if out is None else out + part
        return out

    def dm_dx(self, x, hyperparameters, direction):
        """∂m(x)/∂x[:, direction]: exact zeros for the default constant
        mean, forward-mode AD for a mean that runs on tensors, a forward
        difference (step 1e-6, evaluated in float64) for a host mean."""
        if self._default_mean:
            return torch.zeros(len(x), dtype=self.dtype, device=self.device)
        if self.mean_traceable:
            hps = self._tensor(hyperparameters)
            return self._shift_tangent(lambda xs: self._apply_mean(xs, hps),
                                       self._tensor(x), direction) \
                .to(self.dtype)
        eps = 1e-6
        x1 = np.array(x, dtype=np.float64)
        x1[:, direction] += eps
        f64 = torch.float64
        return ((self.compute_mean(x1, hyperparameters, f64)
                 - self.compute_mean(x, hyperparameters, f64)) / eps) \
            .to(self.dtype)

    # ----------------------------------------------------------------------
    def __getstate__(self):
        state = dict(self.__dict__)
        state["_x_dev"] = None                  # rebuilt from x_data
        state.pop("_gp2_kernel_closure", None)  # a closure; rebuilt lazily
        return config.host_state(state)

    def __setstate__(self, state):
        self.__dict__.update(config.device_state(state))
        self._refresh_device_data()
