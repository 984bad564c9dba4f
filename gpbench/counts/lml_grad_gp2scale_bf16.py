"""Operations of one gp2scale_bf16 LML + gradient evaluation: the
gp2Scale family's (``lml_grad_gp2scale.py``), since the estimator is the
same and only the precision of its products differs."""

from .lml_grad_gp2scale import element_ops, ops, step_ops  # noqa: F401
