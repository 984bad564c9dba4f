"""The JAX suite's ``tests/test_metrics_info.py``, run against the port on
the CPU (``tests/_torch_reference.py``)."""

from _torch_reference import load

# test -> (deviation, reason): tests of the JAX file that do not run here
ALLOWLIST = {}

load("test_metrics_info.py", ALLOWLIST, globals())
