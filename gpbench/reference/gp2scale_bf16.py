"""Plain reference of the gp2scale_bf16 family: the gp2Scale GP of
``gp2scale.py`` with its covariance streamed in bfloat16
(``gp2Scale_solver_dtype`` and ``gp2Scale_storage_dtype``).  Everything
is ``gp2scale.py``'s; this module adds the control's rounding and the
configuration's CG exit floor.  It imports nothing of the program.

``exact`` is ``gp2scale.py``'s: float64, the CG run until every column's
preconditioned residual has fallen by 1e-11.

The control (the precision ``control.py`` passes as ``tf32``) is one
format below the one the configuration states.  The configuration
multiplies bfloat16 tiles (7 explicit mantissa bits), so the float32
cells' control, TF32 (10 bits), is more precise than the program it would
stand in for and would pass any limit the program passes.  The nearest
format below bfloat16 that the tensor cores multiply is FP8, and of its
two kinds E4M3 keeps the more mantissa bits (3).  So the control is
float32 with every stored tile value and every product operand (the
tiles, the CG's directions, the preconditioner's factor and inverse and
the vectors they multiply) rounded to E4M3: to nearest, ties to even,
saturating at ±448, subnormals kept (down to 2⁻⁹), no scale factor.  The
preconditioner's blocks are factored as the float32 control factors
them (TF32 inputs): a factorisation is no product, and in E4M3 the
block's diagonal 1 + 1e-2 rounds to 1, which leaves the blocks
indefinite.  The CG runs as the configuration states: its trip cap and
its exit floor (``exit_floor_sq``).
"""

import torch

E4M3_MAX = 448.0
# exponent of E4M3's least normal value (2⁻⁶) and its mantissa bits
_E4M3_MIN_EXP = -6
_E4M3_MANTISSA = 3


def round_e4m3(t):
    """``t`` (a float tensor) rounded to the nearest FP8 E4M3 value, ties
    to even, saturating at ±448; subnormals kept (step 2⁻⁹), NaN kept.
    The result is in ``t``'s dtype."""
    _, e = torch.frexp(t)
    # the step of the binade t lies in; the subnormals share the least
    # normal binade's step
    exp = torch.clamp(e - 1, min=_E4M3_MIN_EXP) - _E4M3_MANTISSA
    step = torch.ldexp(torch.ones_like(t), exp)
    return torch.clamp(torch.round(t / step) * step, -E4M3_MAX, E4M3_MAX)


def exit_floor_sq(config):
    """The squared relative exit floor of the configuration's CG:
    ``sparse_cg_tol`` squared where its arguments set it, else the
    program's bfloat16 default the configuration records as
    ``cg_exit_floor_sq``."""
    tol = config["gp"]["args"].get("sparse_cg_tol")
    if tol is not None:
        return float(tol) ** 2
    return float(config["cg_exit_floor_sq"])
