"""The JAX suite's ``tests/test_policy.py``, run against the port on the CPU
(``tests/_torch_reference.py``)."""

from _torch_reference import load

# test -> (deviation, reason): tests of the JAX file that do not run here
ALLOWLIST = {
    'test_gp2scale_auto_mode_large_n_is_preconditioned_cg':
        ('jax-internals', 'calls GPkv._set_gp2Scale_mode, a private JAX method'
                          " (the port's is _resolved_mode)"),
}

load("test_policy.py", ALLOWLIST, globals())
