"""K5 (``tile_covariance`` and ``tile_covariance_vjp``), one training step
over ``tiles`` live B×B tiles: the forward writes each tile once and the
VJP reads its cotangent once, both in the solver's dtype.  The bytes bound
the pair; their inputs (two point blocks and masks a tile) and the per-tile
partial sums are a few hundredths of that and are not counted."""

from . import peaks

ITEM = {"float32": 4, "bfloat16": 2}


def step_bytes(tiles, B, dtype):
    return 2 * tiles * B * B * ITEM[dtype]


def bound_s(tiles, B, dtype):
    return step_bytes(tiles, B, dtype) / peaks.HBM_BYTES_PER_S
