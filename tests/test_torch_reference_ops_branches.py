"""The JAX suite's ``tests/test_ops_branches.py``, run against the port on
the CPU (``tests/_torch_reference.py``)."""

from _torch_reference import load

# test -> (deviation, reason): tests of the JAX file that do not run here
ALLOWLIST = {
    'test_committed_fused_path_rejects_f64':
        ('tpu-only', 'imports ops.pallas_kernels'),
    'test_dense_inverse_and_solve_fallbacks':
        ('jnp', 'builds jnp arrays for ops.dense'),
    'test_distance_matrix_branches':
        ('jnp', 'passes jnp arrays to the kernel catalog (its numpy part '
                'passes in test_torch_kernel_catalog.py)'),
    'test_krylov_x0_shape_coercion':
        ('jnp', 'a jnp matvec and jnp right-hand sides'),
    'test_mesh_paths_with_cast_streaming':
        ('virtual-devices', 'an 8-device mesh in one process, jax.random '
                            'probes'),
    'test_mesh_precond_width_indivisible_warns':
        ('virtual-devices', 'an 8-device mesh in one process, jax.random '
                            'probes'),
    'test_precond_shift_retry_exhaustion':
        ('jnp', 'builds jnp arrays for precond._shifted_cholesky'),
    'test_slq_f32_lanczos_breakdown_no_nan':
        ('jnp', 'jax.random probes into the private _slq_fixed'),
    'test_sparse_lml_factory_validation':
        ('mesh-backend', "make_mesh() over the process's virtual devices"),
}

load("test_ops_branches.py", ALLOWLIST, globals())
