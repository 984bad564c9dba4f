"""Kernel + prior-mean management (counterpart of
``fvgp_tpu/models/gp_prior.py``).

Kernels are torch functions ``k(x1, x2, hps)`` (or with a fourth ``args``
argument, arity sniffed) that broadcast over a leading batch dimension;
means are ``m(x, hps)`` or ``m(x, hps, args)``.  A callable that runs on
torch tensors is "traceable": autograd differentiates it inside the traced
LML.  Host (numpy) callables give K and m, but their gradient engine waits
for ROADMAP item 1.6.

* Dense (``gp2Scale=False``): the default kernel is the anisotropic
  Matérn-3/2 (``kernels.default_matern_ard``), the default mean the
  constant ``mean(y)``.  K and m are computed eagerly at every commit, with
  tensors that autograd does not record — on the card the default kernel's
  K then comes from the K3 kernel.  An append computes only the new
  (old × new) and (new × new) blocks.
* gp2Scale: the prior is lazy.  The stored block-sparse covariance is never
  built on this path (the sparse LML and the committed solver assemble their
  own tiles), so ``K`` raises until the stored path is ported (ROADMAP item
  1.3); the default kernel is the anisotropic Wendland kernel.  Cross
  covariances against prediction points run as chunked dense sweeps, and the
  posterior-mean product ``kᵀv`` is fused into the sweep so the (N, n_pred)
  cross covariance never exists.
"""

import inspect
import warnings

import numpy as np
import torch

from .. import config
from ..kernels import default_matern_ard, wendland_anisotropic
from .gp_likelihood import _returns_tensor

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
    """A host numpy array of a tensor or array-like (for host callables)."""
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _pred_bucket(n_pred):
    """Bucketed prediction count (powers of two, floor 16), as in the JAX
    package, so both pad the prediction set alike."""
    return max(16, 1 << int(n_pred - 1).bit_length())


class GPprior:
    def __init__(self, data, trainer, kernel=None, prior_mean_function=None,
                 kernel_grad=None, prior_mean_function_grad=None,
                 gp2Scale_batch_size=10000, gp2Scale_distribution="blockwise"):
        for fn, name in ((kernel_grad, "kernel_function_grad"),
                         (prior_mean_function_grad,
                          "prior_mean_function_grad")):
            if callable(fn):
                raise NotImplementedError(
                    f"fvgp_tpu_torch: {name} is not ported yet (ROADMAP "
                    "item 1.6, the formula gradient engine)")
        if gp2Scale_distribution not in ("blockwise", "rowwise"):
            raise AssertionError("gp2Scale_distribution must be `blockwise` "
                                 "or `rowwise`")
        if not (callable(kernel) or kernel is None):
            raise AssertionError("kernel must be callable or None")
        if not (callable(prior_mean_function) or prior_mean_function is None):
            raise AssertionError("prior_mean_function must be callable or "
                                 "None")
        if data.gp2Scale and callable(prior_mean_function):
            raise NotImplementedError(
                "fvgp_tpu_torch: a prior_mean_function under gp2Scale needs "
                "the stored-K path, which is not ported yet (ROADMAP item "
                "1.4)")
        self.data = data
        self.trainer = trainer
        self.batch_size = gp2Scale_batch_size
        hps = self.hyperparameters
        if not (isinstance(hps, np.ndarray) and hps.ndim == 1):
            raise AssertionError("hyperparameters must be a 1-d np.ndarray")
        if not self.Euclidean:
            raise NotImplementedError(
                "fvgp_tpu_torch: non-Euclidean inputs are not ported yet "
                "(ROADMAP item 1.6)")

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
    def x_old(self):
        return self.data.x_old

    @property
    def x_new(self):
        return self.data.x_new

    @property
    def K(self):
        if self.gp2Scale:
            raise NotImplementedError(
                "fvgp_tpu_torch: the stored gp2Scale covariance "
                "(BlockSparseMatrix, distributed_covariance) is not ported "
                "yet (ROADMAP item 1.3)")
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
                return self.compute_mean(self.x_data, self.hyperparameters)
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
    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64),
                               dtype=self.dtype).to(self.device)

    def _refresh_device_data(self):
        self._x_dev = self._tensor(self.x_data)

    def _probe_traceability(self):
        """Decide, once, whether kernel and mean run on torch tensors (the
        "differentiable by autograd" probe; host callables return numpy)."""
        x2 = self._x_dev[: min(2, len(self.x_data))]
        hps = self._tensor(self.hyperparameters)
        self.kernel_traceable = _returns_tensor(
            lambda x, h: self._apply_kernel(x, x, h), x2, hps)
        self.mean_traceable = self._default_mean or _returns_tensor(
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

    def compute_covariances(self, x1, x2, hps):
        """Dense kernel evaluation k(x1, x2) as a device tensor (``x1`` and
        ``x2`` host arrays or device tensors)."""
        if not self.kernel_traceable:
            from scipy.sparse import issparse
            K = self._apply_kernel(_host(x1), _host(x2), np.asarray(hps))
            return self._tensor(K.toarray() if issparse(K) else K)
        a, b = (v if torch.is_tensor(v) else self._tensor(v)
                for v in (x1, x2))
        return self._apply_kernel(a, b, self._tensor(hps)).to(self.dtype)

    def compute_mean(self, x, hps):
        """Prior mean m(x): the constant mean(y_data) by default."""
        if self._default_mean:
            return self._default_mean_function(x, hps)
        if self.mean_traceable:
            m = self._apply_mean(x if torch.is_tensor(x) else self._tensor(x),
                                 self._tensor(hps))
            return m.to(self.dtype)
        return self._tensor(self._apply_mean(_host(x), np.asarray(hps)))

    def _default_mean_function(self, x, hyperparameters):
        """Constant mean = mean(y_data)."""
        return torch.full((len(x),), float(np.mean(self.y_data)),
                          dtype=self.dtype, device=self.device)

    def compute_prior_covariance_matrix(self, x, hyperparameters):
        """The dense prior covariance K(x, x)."""
        if self.gp2Scale:
            return self.K
        return self.compute_covariances(x, x, hyperparameters)

    def compute_data_cross_covariance(self, x_pred, hyperparameters):
        """k(x_data, x_pred): under gp2Scale above the batch size a chunked
        dense sweep, else one dense evaluation."""
        if self.gp2Scale and len(self.x_data) > self.batch_size:
            k = self._dense_cross_or_none(x_pred, hyperparameters)
            if k is not None:
                return k
            raise NotImplementedError(
                "fvgp_tpu_torch: this cross covariance exceeds "
                "args['gp2Scale_dense_cross_budget'] or device memory; the "
                "block-sparse cross path is not ported yet (ROADMAP item "
                "1.3)")
        return self.compute_covariances(self._x_dev, x_pred, hyperparameters)

    def _compute_prior(self, x_data, hyperparameters):
        m = self.compute_mean(self._x_dev, hyperparameters)
        K = self.compute_prior_covariance_matrix(self._x_dev, hyperparameters)
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
        B = self.compute_covariances(x_old, x_new, hyperparameters)
        D = self.compute_covariances(x_new, x_new, hyperparameters)
        K = torch.cat([torch.cat([self.K, B], dim=1),
                       torch.cat([B.T, D], dim=1)], dim=0)
        return m, K

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
        v = vec.to(self.dtype)
        if v.dim() == 1:
            v = v[:, None]
        vpad = torch.zeros((nch * R, v.shape[1]), dtype=v.dtype,
                           device=v.device)
        vpad[:v.shape[0]] = v
        out = _dense_cross_product_scan(self._kernel_fn(), xc, xp, hps,
                                        vpad.reshape(nch, R, -1))
        return out[:n_pred]
