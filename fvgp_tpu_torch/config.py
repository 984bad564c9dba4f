"""Device and precision policy of fvgp_tpu_torch (counterpart of
``fvgp_tpu/config.py:65-101``).

* The device comes from ``GP(compute_device=...)``: ``"cpu"``, or
  ``"cuda"`` / ``"gpu"``.  Asking for a card on a machine without one
  raises; nothing falls back to the CPU quietly.
* Linear algebra runs in :func:`linalg_dtype`: ``args["dtype"]`` when set,
  else float64 on the CPU (the parity regime) and float32 on CUDA.
* Float32 matrix products run in full float32: the port never turns TF32 on.

There is no global switch and no compile cache: every tensor is created with
an explicit dtype and device.
"""

import numpy as np
import torch

_DTYPES = {"float64": torch.float64, "float32": torch.float32,
           "bfloat16": torch.bfloat16, "float16": torch.float16}


def resolve_device(compute_device="cpu"):
    """The torch device for a ``compute_device`` string."""
    name = str(compute_device).lower()
    if name == "cpu":
        return torch.device("cpu")
    if name in ("cuda", "gpu") or name.startswith("cuda:"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"compute_device={compute_device!r} asks for a CUDA device, "
                "but torch.cuda.is_available() is False on this machine")
        return torch.device("cuda" if name == "gpu" else name)
    raise ValueError(f"unknown compute_device {compute_device!r}; use 'cpu' "
                     "or 'cuda'/'gpu'")


def as_torch_dtype(dtype):
    """A torch dtype from a torch dtype, numpy dtype or name string."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return _DTYPES[np.dtype(dtype).name if not isinstance(dtype, str)
                   else dtype]


def linalg_dtype(args, device):
    """The dtype of the solve path: ``args['dtype']`` > device default
    (float64 on the CPU, float32 on CUDA)."""
    if isinstance(args, dict) and args.get("dtype") is not None:
        return as_torch_dtype(args["dtype"])
    return torch.float64 if torch.device(device).type == "cpu" \
        else torch.float32


def to_numpy(x):
    """Host numpy copy of a tensor (float64 for user-facing returns)."""
    out = x.detach().cpu()
    if out.dtype in (torch.float32, torch.float16, torch.bfloat16):
        out = out.to(torch.float64)
    return out.numpy()
