"""predict_mfu (%): the operations the window's completed requests need
(``counts/predict_<family>.py``, at each request's size), over the window's
length, over the TF32 dense peak (495 TFLOP/s)."""

PEAK = "tf32"


def read(ctx):
    w = ctx.window
    if not w["done"]:
        return None
    count = ctx.count(f"predict_{ctx.config['family']}")
    ops = sum(count.request_ops(ctx.config, r)
              for r, ok in zip(w["requests"], w["ok"]) if ok)
    return 100.0 * ops / w["seconds"] / ctx.count("peaks").PEAK_FLOPS[PEAK]
