#!/usr/bin/env python3
"""Where the dense journey's time goes on one CUDA card.

Run from the root of the repository:

    python3 chip_profile.py [N]

Builds the bench's dense cell (``chip_smoke.dense_cell_data``, N = 10,000 by
default, D = 3, linalg_mode="Chol", float32), warms it up, then traces with
``torch.profiler`` (a) three LML + gradient evaluations and (b) one
``set_hyperparameters`` commit followed by ``posterior_mean`` and
``posterior_covariance(variance_only=True)`` on 500 points.  For each
window it prints the wall time, the device time summed over kernels, the
device's idle share (1 − device time / wall time) and the ten largest
device-time entries by name.  The profiler stretches wall time, so the
device totals are the comparable numbers.  Exits non-zero without a card.
"""

import sys
import time
import warnings

import numpy as np


def device_table(prof, wall_s, label, top=10):
    """Device kernels only: the aten operators that launch them carry the
    same time again and are left out of the sum."""
    from torch.autograd import DeviceType
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    total_ms = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"{label}: wall {wall_s * 1e3:.1f} ms, device {total_ms:.1f} ms, "
          f"idle share {max(0.0, 1 - total_ms / (wall_s * 1e3)):.3f}",
          flush=True)
    for e in rows[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}", flush=True)


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this profile needs a "
              "CUDA card")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    warnings.simplefilter("ignore")
    N = int(sys.argv[1]) if len(sys.argv) > 1 else 10_000
    print(f"card: {cs.smi_line()}; N={N}", flush=True)
    x, y, xp = cs.dense_cell_data(N)
    hps = np.array([1.0, 1.5, 1.5, 1.5])
    gp = cs.dense_model(x, y, hps, "cuda")
    ml = gp.marginal_likelihood
    ml.log_likelihood_value_and_gradient(hps)
    gp.posterior_mean(xp)
    gp.posterior_covariance(xp, variance_only=True)
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.time()
        for i in range(3):
            ml.log_likelihood_value_and_gradient(hps * (1 + 1e-4 * (i + 1)))
        torch.cuda.synchronize()
        wall = time.time() - t0
    device_table(prof, wall, "3 x LML+grad")
    with profile(activities=acts) as prof:
        t0 = time.time()
        gp.set_hyperparameters(hps * 1.01)
        gp.posterior_mean(xp)
        gp.posterior_covariance(xp, variance_only=True)
        torch.cuda.synchronize()
        wall = time.time() - t0
    device_table(prof, wall, "commit + posterior mean + variance (500)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
