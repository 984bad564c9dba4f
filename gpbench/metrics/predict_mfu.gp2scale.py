"""predict_mfu.gp2scale (%): ``predict_mfu`` of the gp2Scale posterior —
the operations the window's completed requests need
(``counts/predict_gp2scale.py``, at each request's n and the live tiles
of the benchmark's own structure at h₀), over the window's length, over
the TF32 dense peak (495 TFLOP/s)."""

PEAK = "tf32"


def read(ctx):
    w = ctx.window
    if not w["done"]:
        return None
    count = ctx.count("predict_gp2scale")
    ops = sum(count.request_ops(ctx.config, r, ctx.reference)
              for r, ok in zip(w["requests"], w["ok"]) if ok)
    return 100.0 * ops / w["seconds"] / ctx.count("peaks").PEAK_FLOPS[PEAK]
