"""The JAX suite's ``tests/test_precond.py``, run against the port on the
CPU (``tests/_torch_reference.py``)."""

from _torch_reference import load

# test -> (deviation, reason): tests of the JAX file that do not run here
ALLOWLIST = {
    'test_alias_modes_run_end_to_end':
        ('slow', '76.7 s on the CPU (6 workers): covered by '
                 "tests/test_torch_stored_k.py's alias-mode sweep"),
    'test_block_sparse_schwarz_and_coarse':
        ('jnp', 'a stand-in prior whose kernel takes jnp arrays'),
    'test_preconditioners_are_spd':
        ('jnp', 'builds its K+V and probes as jnp arrays'),
    'test_preconditioners_reduce_iterations':
        ('jnp', 'builds its K+V and probes as jnp arrays'),
}

load("test_precond.py", ALLOWLIST, globals())
