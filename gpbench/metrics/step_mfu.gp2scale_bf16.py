"""step_mfu.gp2scale_bf16 (%): ``step_mfu`` of the bfloat16 gp2Scale step
— the operations an exact LML + gradient needs
(``counts/lml_grad_<family>.py``), over the mean step time of the run's
measured window, over the bfloat16 dense peak (989 TFLOP/s), the rate of
the products the configuration states."""

PEAK = "bfloat16"


def read(ctx):
    w = ctx.window
    if not w["done"]:
        return None
    step_s = w["seconds"] / w["done"]
    count = ctx.count(f"lml_grad_{ctx.config['family']}")
    peak = ctx.count("peaks").PEAK_FLOPS[PEAK]
    return 100.0 * count.step_ops(ctx.config, ctx.reference) / step_s / peak
