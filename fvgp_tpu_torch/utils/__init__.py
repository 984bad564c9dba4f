from .logging import disable, enable, logger, phase_timer  # noqa: F401
from .timing import log_time  # noqa: F401
