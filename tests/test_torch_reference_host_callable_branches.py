"""The JAX suite's ``tests/test_host_callable_branches.py``, run against the
port on the CPU (``tests/_torch_reference.py``)."""

from _torch_reference import load

# test -> (deviation, reason): tests of the JAX file that do not run here
ALLOWLIST = {
    'test_three_arg_callables_with_args':
        ('jnp', 'jnp kernel and mean callables, which the port runs as host '
                'callables'),
}

load("test_host_callable_branches.py", ALLOWLIST, globals())
