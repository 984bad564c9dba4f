"""predict_ms (ms): the window's length over the prediction requests
completed in it."""


def read(ctx):
    w = ctx.window
    return 1e3 * w["seconds"] / w["done"] if w["done"] else None
