"""Deep kernel warping networks (counterpart of
``fvgp_tpu/models/deep_kernel_network.py``).

Two small MLPs whose flattened weights ride in the GP hyperparameter vector
and warp the inputs of a stationary kernel.  ``Network`` is an
``nn.Module`` with no parameters of its own: ``forward(x, hps)`` slices the
flat vector into views, so autograd runs from the marginal likelihood
through the MLP into the hyperparameters, and ``train(method="hgdl")``
trains the weights like any other hyperparameter.

Layout contract (the JAX package's): three dense layers in→W1→W2→out with
biases, parameters flattened in layer order (W1, b1, W2, b2, W3, b3), each
matrix row-major (out, in), and
``number_of_hps = w1*(in+1) + w2*(w1+1) + out*(w2+1) [+ extra kernel hps]``.
A JAX weight vector therefore carries across unchanged.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import get_distance_matrix, matern_kernel_diff2

__all__ = ["Network", "WarpNet", "get_number_of_hps", "make_deep_kernel"]


def get_number_of_hps(input_dim, layer1_width, layer2_width, output_dim):
    """Number of flattened MLP parameters."""
    return (layer1_width * (input_dim + 1)
            + layer2_width * (layer1_width + 1)
            + output_dim * (layer2_width + 1))


def _as_tensor(a, like=None):
    if torch.is_tensor(a):
        return a
    if like is not None:
        return torch.as_tensor(np.asarray(a, np.float64)).to(like.device,
                                                            like.dtype)
    return torch.as_tensor(np.asarray(a, np.float64))


class Network(nn.Module):
    """3-layer ReLU MLP whose parameters live in a flat hyperparameter
    slice."""

    def __init__(self, input_dim, layer1_width, layer2_width, output_dim):
        super().__init__()
        self.dims = (input_dim, layer1_width, layer2_width, output_dim)
        self.number_of_hps = get_number_of_hps(input_dim, layer1_width,
                                               layer2_width, output_dim)

    def unflatten(self, hps):
        """Views (W1, b1, W2, b2, W3, b3) of a flat vector."""
        d, w1, w2, o = self.dims
        hps = _as_tensor(hps)
        out, i = [], 0
        for rows, cols in ((w1, d), (w2, w1), (o, w2)):
            out.append(hps[i:i + rows * cols].view(rows, cols))
            i += rows * cols
            out.append(hps[i:i + rows])
            i += rows
        return tuple(out)

    @staticmethod
    def _hidden(t):
        return torch.relu(t)

    @staticmethod
    def _head(t):
        return t

    def forward(self, x, hps):
        hps = _as_tensor(hps)
        x = _as_tensor(x, like=hps)
        W1, b1, W2, b2, W3, b3 = self.unflatten(hps)
        h = self._hidden(F.linear(x, W1, b1))
        h = self._hidden(F.linear(h, W2, b2))
        return self._head(F.linear(h, W3, b3))

    def set_weights(self, hps):
        """API-parity shim: the network holds no weights; returns hps."""
        return np.asarray(hps)

    def get_weights(self, hps):
        return np.asarray(hps)


class WarpNet(Network):
    """Input-warping variant with tanh layers and a tanh head: warped
    coordinates stay in a box, which stabilizes length-scale learning."""

    @staticmethod
    def _hidden(t):
        return torch.tanh(t)

    _head = _hidden


def make_deep_kernel(network, base_kernel=None, n_extra_hps=2):
    """A deep kernel: warp both inputs through ``network`` and apply a
    stationary base kernel with trailing hyperparameters.

    hps layout: [network weights..., signal variance, length scale] (or
    ``n_extra_hps`` trailing values consumed by ``base_kernel(d, extra)``).
    The kernel takes and returns torch tensors, so ``GP`` differentiates it
    by autograd; it never runs on K3."""
    if base_kernel is None:
        def base_kernel(d, extra):
            return extra[0] * matern_kernel_diff2(d, extra[1])

    n_w = network.number_of_hps

    def kernel(x1, x2, hps):
        w = hps[:n_w]
        extra = hps[n_w:n_w + n_extra_hps]
        return base_kernel(get_distance_matrix(network(x1, w),
                                               network(x2, w)), extra)

    kernel.number_of_hps = n_w + n_extra_hps
    return kernel
