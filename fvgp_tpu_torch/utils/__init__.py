from .timing import log_time  # noqa: F401
