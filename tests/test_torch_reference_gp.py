"""The JAX suite's ``tests/test_gp.py``, run against the port on the CPU
(``tests/_torch_reference.py``)."""

from _torch_reference import load

# test -> (deviation, reason): tests of the JAX file that do not run here
ALLOWLIST = {
    'test_traced_lml_program_survives_same_shape_data_update':
        ('jax-internals', 'reads GPMarginalLikelihood._lml_on, the JAX '
                          "package's compiled program"),
}

load("test_gp.py", ALLOWLIST, globals())
