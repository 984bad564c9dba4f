"""fvgp_tpu_torch — the PyTorch/CUDA port of fvgp_tpu.

The JAX package ``fvgp_tpu`` is the reference; this package never imports
it or JAX.  Two journeys run through the public ``GP``, on the card unless
``compute_device="cpu"`` is asked for:

* the dense exact GP (``GP(x, y)``): construction, the autograd LML,
  gradient and Hessian, ``train`` with ``"global"``, ``"local"`` or
  ``"mcmc"``, posterior means, covariances and variances in the ``Chol``,
  ``CholInv`` and ``Inv`` modes, and ``update_gp_data``;
* the gp2Scale engine (``GP(x, y, gp2Scale=True)``): the differentiable
  sparse LML and its gradient (``args["gp2Scale_solver"]``: ``"mbcg"`` or
  ``"slq"``) and Hessian, posterior means, variances and covariances (the
  committed solve preconditioned by block-Jacobi or the two-level
  operator), and — off the traced path — the stored block-sparse
  covariance (``gp.K``, ``update_gp_data``) with the Krylov / SLQ /
  preconditioner solves of the sparse linalg modes.

``fvgp_tpu_torch.gp_lin_alg`` holds the reference-name linear-algebra
functions (``calculate_sparse_conj_grad``, ``calculate_random_logdet``, ...).

``gpMCMC`` and ``ProposalDistribution`` are the adaptive Metropolis sampler
behind ``train(method="mcmc")``, usable on their own.  Every TPU kernel of
the JAX package has a hand-written Hopper counterpart in
``ops/hopper_kernels.py`` (K1-K4).
"""

from .interop import gp_from_numpy_state
from .models.gp import GP, NotPortedError
from .models.gp_mcmc import ProposalDistribution, gpMCMC

__all__ = ["GP", "NotPortedError", "ProposalDistribution", "gpMCMC",
           "gp_from_numpy_state"]
