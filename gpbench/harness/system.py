"""The system under test: the model the configuration's ``system`` names
(``systems/<name>.py``), and the call the cell's request kind makes of it.
Nothing else of the program is touched here; its launch counters are read
by the metrics that name them."""

import numpy as np
import torch


class System:
    def __init__(self, spec, config, data, device, op):
        self.device, self.op = device, op
        self.model = spec.system(config["system"]).build(config, data, device)
        # calls made of the model so far, warm-up included
        self.calls = 0

    def sync(self):
        if self.device != "cpu":
            torch.cuda.synchronize()

    def run(self, req):
        index = self.calls
        self.calls += 1
        out = self.op.call(self.model, req, index)
        self.sync()
        return out

    @staticmethod
    def finite(out):
        return all(np.all(np.isfinite(v)) for v in out.values())
