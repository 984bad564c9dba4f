from .gp import GP, NotPortedError

__all__ = ["GP", "NotPortedError"]
