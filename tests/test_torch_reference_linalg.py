"""The JAX suite's ``tests/test_linalg.py``, run against the port on the CPU
(``tests/_torch_reference.py``)."""

from _torch_reference import load

# test -> (deviation, reason): tests of the JAX file that do not run here
ALLOWLIST = {
    'test_blocked_rank_n_update':
        ('jnp', 'jnp arrays or a jnp matvec for the op-level solvers'),
    'test_cg_dense':
        ('jnp', 'jnp arrays or a jnp matvec for the op-level solvers'),
    'test_cg_warm_start_and_precond':
        ('jnp', 'builds jnp arrays for the op-level solvers'),
    'test_cg_zero_rhs_column_with_warm_start_converges_immediately':
        ('jnp', 'jnp arrays or a jnp matvec for the op-level solvers'),
    'test_cholesky_roundtrip':
        ('jnp', 'jnp arrays or a jnp matvec for the op-level solvers'),
    'test_inverse_paths':
        ('jnp', 'jnp arrays or a jnp matvec for the op-level solvers'),
    'test_minres_dense':
        ('jnp', 'jnp arrays or a jnp matvec for the op-level solvers'),
    'test_minres_indefinite':
        ('jnp', 'jnp arrays or a jnp matvec for the op-level solvers'),
    'test_minres_indefinite_preconditioner_poisons_not_silent':
        ('jnp', 'jnp arrays or a jnp matvec for the op-level solvers'),
    'test_non_pd_raises':
        ('jnp', 'jnp arrays or a jnp matvec for the op-level solvers'),
    'test_slq_logdet_accuracy':
        ('jnp', 'jnp arrays or a jnp matvec for the op-level solvers'),
    'test_slq_probe_batch_capped_by_memory':
        ('jax-internals', 'reads slq._probe_batch, a private helper of the JAX'
                          ' package'),
    'test_unknown_preconditioner_type_raises_everywhere':
        ('jnp', 'jnp arrays or a jnp matvec for the op-level solvers'),
}

load("test_linalg.py", ALLOWLIST, globals())
