"""Device and precision policy of fvgp_tpu_torch (counterpart of
``fvgp_tpu/config.py:65-101``).

* The device comes from ``GP(compute_device=...)``: ``"cuda"`` / ``"gpu"``
  (the default) or ``"cpu"``.  The CPU is taken only when asked for; asking
  for a card — explicitly or by default — on a machine without one raises,
  and nothing falls back to the CPU quietly.
* Linear algebra runs in :func:`linalg_dtype`: ``args["dtype"]`` when set,
  else the global override of :func:`set_linalg_dtype` when set, else
  float64 on the CPU (the parity regime) and float32 on CUDA; dense kernel
  sweeps run in :func:`kernel_compute_dtype` (``args["kernel_dtype"]``).
  :func:`default_backend` reports the device a default entry point takes.
* A pickled model holds host numpy arrays and device names only
  (:func:`host_state` / :func:`device_state`).
* Float32 matrix products run in full float32: the port never turns TF32 on.
* :func:`to_tensor`, :func:`tensor_operand`, :func:`returns_tensor` and
  :func:`hps_jacobian` are the models' shared plumbing: host data onto the
  device, a public method's operand onto the model's device and dtype
  (or a reference tensor's), the "runs
  on torch tensors" probe of a user callable, and its forward-mode
  derivative in the hyperparameters.

The dtype override is the one global switch (the JAX package's); there is
no compile cache, and every tensor is created with an explicit dtype and
device.
"""

import numpy as np
import torch

_DTYPES = {"float64": torch.float64, "float32": torch.float32,
           "bfloat16": torch.bfloat16, "float16": torch.float16}


def resolve_device(compute_device="cuda"):
    """The torch device for a ``compute_device`` string (default: the
    card).  Under an active mesh (``parallel.mesh.use_mesh``) ``"cuda"`` /
    ``"gpu"`` is the rank's card; an explicit ``"cuda:i"`` or ``"cpu"``
    wins."""
    from .parallel.mesh import current_mesh
    name = str(compute_device).lower()
    if name == "cpu":
        return torch.device("cpu")
    if name in ("cuda", "gpu") or name.startswith("cuda:"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"compute_device={compute_device!r} asks for a CUDA device, "
                "but torch.cuda.is_available() is False on this machine")
        mesh = current_mesh()
        if name in ("cuda", "gpu") and mesh is not None \
                and mesh.device.type == "cuda":
            return mesh.device
        return torch.device("cuda" if name == "gpu" else name)
    raise ValueError(f"unknown compute_device {compute_device!r}; use 'cpu' "
                     "or 'cuda'/'gpu'")


def as_torch_dtype(dtype):
    """A torch dtype from a torch dtype, numpy dtype or name string."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return _DTYPES[np.dtype(dtype).name if not isinstance(dtype, str)
                   else dtype]


_FORCED_DTYPE = None


def default_backend():
    """``"cuda"`` on a machine with a card, else ``"cpu"``: the device a
    default entry point runs on (where there is no card, it raises)."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def set_linalg_dtype(dtype):
    """Force the linear-algebra dtype of every model without
    ``args['dtype']`` (None restores the device default)."""
    global _FORCED_DTYPE
    _FORCED_DTYPE = as_torch_dtype(dtype)


def linalg_dtype(args=None, device=None):
    """The dtype of the solve path: ``args['dtype']`` > the global override
    of :func:`set_linalg_dtype` > the device default (float64 on the CPU,
    float32 on CUDA; ``device=None``: :func:`default_backend`)."""
    if isinstance(args, dict) and args.get("dtype") is not None:
        return as_torch_dtype(args["dtype"])
    if _FORCED_DTYPE is not None:
        return _FORCED_DTYPE
    device = default_backend() if device is None else device
    return torch.float64 if torch.device(device).type == "cpu" \
        else torch.float32


def kernel_compute_dtype(args=None, device=None):
    """The dtype in which dense kernel matrices are evaluated:
    ``args['kernel_dtype']`` where given (then cast back to the linalg
    dtype), else the linalg dtype."""
    if isinstance(args, dict) and args.get("kernel_dtype") is not None:
        return as_torch_dtype(args["kernel_dtype"])
    return linalg_dtype(args, device)


class _HostTensor:
    """A tensor's place in a pickle: its host copy, dtype and device name
    (bfloat16 travels as float32, which holds it exactly)."""

    def __init__(self, t):
        t = t.detach()
        self.dtype = str(t.dtype).replace("torch.", "")
        self.device = str(t.device)
        self.array = (t.float() if t.dtype == torch.bfloat16 else t).cpu() \
            .numpy()

    def tensor(self):
        return torch.as_tensor(self.array).to(resolve_device(self.device),
                                              getattr(torch, self.dtype))


def host_state(value):
    """``value`` for a pickle: every tensor in it (also inside dicts, lists
    and tuples) replaced by its host copy, so no CUDA tensor enters the
    pickle and it loads back onto the device it came from."""
    if torch.is_tensor(value):
        return _HostTensor(value)
    if isinstance(value, dict):
        return {k: host_state(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(host_state(v) for v in value)
    return value


def device_state(value):
    """The inverse of :func:`host_state`."""
    if isinstance(value, _HostTensor):
        return value.tensor()
    if isinstance(value, dict):
        return {k: device_state(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(device_state(v) for v in value)
    return value


def to_numpy(x):
    """Host numpy copy of a tensor (float64 for user-facing returns)."""
    out = x.detach().cpu()
    if out.dtype in (torch.float32, torch.float16, torch.bfloat16):
        out = out.to(torch.float64)
    return out.numpy()


def to_tensor(a, device, dtype):
    """``a`` (numpy, array-like or a tensor) as a tensor on ``device`` in
    ``dtype``."""
    if torch.is_tensor(a):
        return a.to(device, dtype)
    return torch.as_tensor(np.asarray(a, dtype=np.float64),
                           dtype=dtype).to(device)


HOST_ARRAYS = (np.ndarray, np.generic, list, tuple)


def tensor_operand(a, device=None, dtype=None, like=None):
    """The one rule by which a public method's array operand becomes a
    tensor: a host array (:data:`HOST_ARRAYS`) or a number as
    ``torch.as_tensor`` makes it, a tensor as it is, then moved to
    ``device`` in ``dtype`` (``like``'s device and dtype where a reference
    tensor is given).  Where they are None a tensor keeps its own, and a
    host array takes :func:`default_backend` and the dtype numpy gave it.
    None and any other object (a block-sparse or ``scipy.sparse`` matrix)
    pass as they are.  The tier objects' methods take their array inputs
    through it with the model's device and dtype, the kernel catalog with
    its first floating tensor argument."""
    if like is not None:
        device, dtype = like.device, like.dtype
    if isinstance(a, HOST_ARRAYS + (int, float)):
        a = torch.as_tensor(np.asarray(a), dtype=dtype, device=device
                            if device is not None else default_backend())
    if not torch.is_tensor(a):
        return a
    return a.to(a.device if device is None else device,
                a.dtype if dtype is None else dtype)


def returns_tensor(fn, x, hps):
    """The "differentiable by autograd" probe: True when ``fn(x, hps)``
    (or ``fn(x, x, hps)`` via a wrapper) runs on torch tensors while
    autograd records ``hps`` and returns a tensor.  A host (numpy) callable
    fails here: numpy refuses a tensor that requires grad."""
    try:
        with torch.enable_grad():
            return isinstance(fn(x, hps.detach().clone().requires_grad_(True)),
                              torch.Tensor)
    except Exception:
        return False


def hps_jacobian(fn, hps, direction=None):
    """d fn(hps)/d hps by forward-mode AD, one basis direction at a time
    (``jacfwd`` without ``vmap``, so any callable that forward-mode AD runs
    through qualifies): (H, *out) for every direction, (*out) for one."""
    from torch.autograd import forward_ad
    dirs = range(len(hps)) if direction is None else [int(direction)]
    out = []
    for i in dirs:
        e = torch.zeros_like(hps)
        e[i] = 1.0
        with forward_ad.dual_level():
            primal, tangent = forward_ad.unpack_dual(
                fn(forward_ad.make_dual(hps, e)))
            out.append(torch.zeros_like(primal) if tangent is None
                       else tangent)
    return out[0] if direction is not None else torch.stack(out)
