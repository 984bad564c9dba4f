"""The port's public ``GP`` over the configuration's data, its keyword
arguments those of the configuration's ``gp`` object."""

import numpy as np


def build(config, data, device):
    from fvgp_tpu_torch import GP
    gp = dict(config["gp"])
    h0 = np.asarray(gp.pop("init_hyperparameters"), np.float64)
    return GP(data["x"], data["y"], init_hyperparameters=h0,
              noise_variances=data["noise"], compute_device=device, **gp)
