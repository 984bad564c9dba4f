from .fvgp import fvGP
from .gp import GP, NotPortedError
from .gp_mcmc import ProposalDistribution, gpMCMC

__all__ = ["GP", "NotPortedError", "ProposalDistribution", "fvGP", "gpMCMC"]
