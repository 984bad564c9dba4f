"""fvgp_tpu_torch — the PyTorch/CUDA port of fvgp_tpu.

The JAX package ``fvgp_tpu`` is the reference; this package never imports
it or JAX.  This slice ports the gp2Scale journey through the public
``GP``: construction, the differentiable sparse LML and its gradient,
``train(method="local")``, ``posterior_mean`` and
``posterior_covariance(variance_only=True)`` — with the two SpMMs of that
path as hand-written Hopper kernels (``ops/hopper_kernels.py``).
"""

from .interop import gp_from_numpy_state
from .models.gp import GP, NotPortedError

__all__ = ["GP", "NotPortedError", "gp_from_numpy_state"]
