"""The JAX suite's ``tests/test_fvgp_multitask.py``, run against the port on
the CPU (``tests/_torch_reference.py``)."""

from _torch_reference import load

# test -> (deviation, reason): tests of the JAX file that do not run here
ALLOWLIST = {
    'test_fvgp_gp2scale_multitask_under_mesh':
        ('virtual-devices', 'needs one process of 8 virtual XLA devices; the '
                            'mesh paths are held on gloo ranks in '
                            'tests/test_torch_mesh*.py'),
}

load("test_fvgp_multitask.py", ALLOWLIST, globals())
