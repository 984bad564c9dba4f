"""The gp2Scale family's answer to ``lml_grad_far``: the same as to
``lml_grad`` (``gp2scale_lml_grad.py``), since the request kind differs
only in where its steps lie."""

from .gp2scale_lml_grad import Gp2ScaleLmlGrad, make  # noqa: F401
