"""fvgp_tpu_torch — the PyTorch/CUDA port of fvgp_tpu.

The JAX package ``fvgp_tpu`` is the reference; this package never imports
it or JAX.  Two journeys run through the public ``GP``, on the card unless
``compute_device="cpu"`` is asked for:

* the dense exact GP (``GP(x, y)``): construction, the autograd LML,
  gradient and Hessian, ``train`` with ``"global"``, ``"local"`` or
  ``"mcmc"``, posterior means, covariances and variances in the ``Chol``,
  ``CholInv`` and ``Inv`` modes, and ``update_gp_data``;
* the gp2Scale engine (``GP(x, y, gp2Scale=True)``): the differentiable
  sparse LML and its gradient, ``posterior_mean`` and
  ``posterior_covariance(variance_only=True)``.

Every TPU kernel of the JAX package has a hand-written Hopper counterpart
in ``ops/hopper_kernels.py`` (K1-K4).
"""

from .interop import gp_from_numpy_state
from .models.gp import GP, NotPortedError

__all__ = ["GP", "NotPortedError", "gp_from_numpy_state"]
