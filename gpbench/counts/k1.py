"""K1 (``chunked_spmm``), one launch: Y[rows[t]] += tiles[t] @ X[cols[t]]
over ``tiles`` live B×B tiles of an nb-block operator, k columns.

Bytes: each tile once, its column index, the row offsets, X once and Y
(float32) once.  Operations: 2·tiles·B²·k; float32 tiles run as 3×TF32
products, so they count three times against the TF32 peak, bfloat16 once
against the bfloat16 peak."""

from . import peaks

ITEM = {"float32": 4, "bfloat16": 2}


def launch_bytes(tiles, nb, B, k, dtype):
    s = ITEM[dtype]
    return tiles * B * B * s + tiles * 4 + (nb + 1) * 4 + nb * B * k * s \
        + nb * B * k * 4


def launch_ops(tiles, B, k):
    return 2 * tiles * B * B * k


def bound_s(tiles, nb, B, k, dtype):
    if dtype == "float32":
        return peaks.bound_s(launch_bytes(tiles, nb, B, k, dtype),
                             3 * launch_ops(tiles, B, k), "tf32")
    return peaks.bound_s(launch_bytes(tiles, nb, B, k, dtype),
                         launch_ops(tiles, B, k), "bfloat16")
