"""step_mfu.<variant> (%): the operations an exact LML + gradient needs,
counted from the cell's shapes (``counts/lml_grad_<family>.py``), over the
mean step time of the run's measured window, over the TF32 dense peak (495
TFLOP/s: the fastest rate any float32-accurate route can reach, so no
sound change reads over 100%)."""

PEAK = "tf32"


def read(ctx):
    w = ctx.window
    if not w["done"]:
        return None
    step_s = w["seconds"] / w["done"]
    count = ctx.count(f"lml_grad_{ctx.config['family']}")
    peak = ctx.count("peaks").PEAK_FLOPS[PEAK]
    return 100.0 * count.step_ops(ctx.config, ctx.reference) / step_s / peak
