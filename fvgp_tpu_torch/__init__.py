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

``fvGP`` is the multi-task GP: a ``GP`` over task-augmented points
``[x, task]`` with NaN-masked (V, No) observations and task-major
posteriors.  Host (numpy) kernel, mean and noise callables, their gradient
callables, structured (``scipy.sparse`` / block-sparse) noise and
non-Euclidean inputs (lists of objects) are served on both journeys; off
the traced paths the LML gradient is the explicit formula.

``gpMCMC`` and ``ProposalDistribution`` are the adaptive Metropolis sampler
behind ``train(method="mcmc")``, usable on their own.

The extensions: a deep kernel (``models/deep_kernel_network.py``: a
parameter-free ``nn.Module`` MLP whose weights ride in the hyperparameter
vector, warping a stationary kernel; a torch kernel that ``GP`` trains by
autograd), ``GPm`` (multi-output GP on a learned linear manifold),
``GPLVM`` (latent-variable GP with its posterior suite at new latents) and
``GGMP`` (Gaussian-mixture distributional regression over K component
``GP`` / ``fvGP`` models; ``ggmp`` is its module with the numpy helpers).
Each takes ``compute_device`` like ``GP``.  ``interop`` carries JAX model
states across (``gp_from_numpy_state``, ``gpm_from_numpy_state``,
``gplvm_from_numpy_state``, ``ggmp_from_numpy_state``).

Every TPU kernel of the JAX package has a hand-written Hopper counterpart in
``ops/hopper_kernels.py`` (K1-K4).  ``examples/`` holds the JAX package's
nine worked examples on the port (``python -m
fvgp_tpu_torch.examples.<name>``; ``--device cpu`` off the card).
"""

from .interop import gp_from_numpy_state
from .models import ggmp
from .models.fvgp import fvGP
from .models.ggmp import GGMP
from .models.gp import GP, NotPortedError
from .models.gp_mcmc import ProposalDistribution, gpMCMC
from .models.gplvm import GPLVM
from .models.gpm import GPm

__all__ = ["GGMP", "GP", "GPLVM", "GPm", "NotPortedError",
           "ProposalDistribution", "fvGP", "ggmp", "gpMCMC",
           "gp_from_numpy_state"]
__version__ = "0.1.0"
