"""K2 (``row_chunk_sums``), the committed CG's products with the operator
over one request: ``trips`` products of ``tiles`` live B×B tiles of an
nb-block operator, multiplying ``columns`` columns in all (the sum over
the trips of the columns each one multiplied).

Bytes: each tile once a trip; X and the output (float32) once a column.
Operations: 2·tiles·B² a column; float32 tiles run as 3×TF32 products, so
they count three times against the TF32 peak, bfloat16 once against the
bfloat16 peak."""

from . import peaks

ITEM = {"float32": 4, "bfloat16": 2}


def request_bytes(tiles, nb, B, trips, columns, dtype):
    s = ITEM[dtype]
    return trips * tiles * B * B * s + columns * nb * B * (s + 4)


def request_ops(tiles, B, columns):
    return 2 * tiles * B * B * columns


def bound_s(tiles, nb, B, trips, columns, dtype):
    if dtype == "float32":
        return peaks.bound_s(request_bytes(tiles, nb, B, trips, columns,
                                           dtype),
                             3 * request_ops(tiles, B, columns), "tf32")
    return peaks.bound_s(request_bytes(tiles, nb, B, trips, columns, dtype),
                         request_ops(tiles, B, columns), "bfloat16")
