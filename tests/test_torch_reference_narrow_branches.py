"""The JAX suite's ``tests/test_narrow_branches.py``, run against the port
on the CPU (``tests/_torch_reference.py``)."""

from _torch_reference import load

# test -> (deviation, reason): tests of the JAX file that do not run here
ALLOWLIST = {
    'test_config_dtype_controls':
        ('torch-dtypes', "compares config's dtypes with jnp dtypes"),
    'test_mesh_and_partition_guards':
        ('mesh-backend', 'make_mesh(8) / make_mesh_2d over virtual devices'),
}

load("test_narrow_branches.py", ALLOWLIST, globals())
