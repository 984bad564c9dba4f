"""lml_grad_s (s): one training step, the window's length over the
LML+gradient evaluations completed in it.  Its variants (``lml_grad_s.<family>``)
read the same, each with a bound of its own."""


def read(ctx):
    w = ctx.window
    return w["seconds"] / w["done"] if w["done"] else None
