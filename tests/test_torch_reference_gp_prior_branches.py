"""The JAX suite's ``tests/test_gp_prior_branches.py``, run against the port
on the CPU (``tests/_torch_reference.py``)."""

from _torch_reference import load

# test -> (deviation, reason): tests of the JAX file that do not run here
ALLOWLIST = {
    'test_4arg_kernel_derivative_paths':
        ('jnp', 'a jnp kernel callable (a host callable to the port)'),
    'test_dense_cross_oom_falls_back':
        ('jax-errors', 'raises jax.errors.JaxRuntimeError RESOURCE_EXHAUSTED'),
    'test_dm_dx_traceable_user_mean_exact':
        ('jnp', 'a jnp mean callable (a host callable to the port)'),
}

load("test_gp_prior_branches.py", ALLOWLIST, globals())
