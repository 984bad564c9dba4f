"""predict_p95_ms (ms): the 95th percentile of the latencies of every
request in the window, failed ones included."""

import numpy as np


def read(ctx):
    lat = ctx.window["latency_s"]
    return 1e3 * float(np.percentile(lat, 95)) if lat else None
