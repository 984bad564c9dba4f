"""The two precisions a reference computes in.

``exact`` is the reference itself: float64 throughout.  ``tf32`` is the
control: float32 storage, and every operand of a product rounded to TF32
(10 explicit mantissa bits, round to nearest even) before it is multiplied,
which is what a tensor-core TF32 product does to its inputs.  The control
puts the reference in the program's place one precision step below the
configurations' float32, so the check that decides ``correct`` must fail it.
"""

import torch

PRECISIONS = ("exact", "tf32")


def dtype_of(precision):
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    return torch.float64 if precision == "exact" else torch.float32


def round_tf32(t):
    """``t`` (float32) with its mantissa rounded to TF32's 10 bits."""
    if t.dtype != torch.float32:
        raise TypeError("TF32 rounding applies to float32 tensors")
    bits = t.contiguous().view(torch.int32)
    # round half to even on the 13 dropped bits
    lsb = (bits >> 13) & 1
    rounded = (bits + 0x0FFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)


def operand(t, precision):
    """``t`` as a product's operand in ``precision``; a gradient passes
    the rounding unchanged."""
    if precision != "tf32":
        return t
    d = t.detach()
    return t + (round_tf32(d) - d) if t.requires_grad else round_tf32(t)
