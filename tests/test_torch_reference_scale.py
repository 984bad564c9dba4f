"""The JAX suite's ``tests/test_scale.py``, run against the port on the CPU
(``tests/_torch_reference.py``)."""

from _torch_reference import load

# test -> (deviation, reason): tests of the JAX file that do not run here
ALLOWLIST = {
    'test_2d_slice_mesh_halo_forced':
        ('virtual-devices', 'needs one process of 8 virtual XLA devices; the '
                            'mesh paths are held on gloo ranks in '
                            'tests/test_torch_mesh*.py'),
    'test_2d_slice_mesh_matches_meshless':
        ('virtual-devices', 'needs one process of 8 virtual XLA devices; the '
                            'mesh paths are held on gloo ranks in '
                            'tests/test_torch_mesh*.py'),
    'test_bsm_merge_preserves_structured_noise_precision':
        ('jnp', 'builds jnp bfloat16 / float64 tiles and compares jnp dtypes'),
    'test_committed_hier_halo_engages_on_2d_mesh':
        ('virtual-devices', 'needs one process of 8 virtual XLA devices; the '
                            'mesh paths are held on gloo ranks in '
                            'tests/test_torch_mesh*.py'),
    'test_committed_two_level_precond_parity':
        ('virtual-devices', 'needs one process of 8 virtual XLA devices; the '
                            'mesh paths are held on gloo ranks in '
                            'tests/test_torch_mesh*.py'),
    'test_fast_solve_oom_retreats_to_narrower_chunks':
        ('jax-errors', 'raises RESOURCE_EXHAUSTED as a RuntimeError'),
    'test_gp2scale_all_modes_under_mesh':
        ('virtual-devices', 'needs one process of 8 virtual XLA devices; the '
                            'mesh paths are held on gloo ranks in '
                            'tests/test_torch_mesh*.py'),
    'test_gp_forced_halo_matches_meshless':
        ('virtual-devices', 'needs one process of 8 virtual XLA devices; the '
                            'mesh paths are held on gloo ranks in '
                            'tests/test_torch_mesh*.py'),
    'test_gp_forced_hier_halo_matches_meshless':
        ('virtual-devices', 'needs one process of 8 virtual XLA devices; the '
                            'mesh paths are held on gloo ranks in '
                            'tests/test_torch_mesh*.py'),
    'test_halo_hier_spmv_matches_dense':
        ('virtual-devices', 'needs one process of 8 virtual XLA devices; the '
                            'mesh paths are held on gloo ranks in '
                            'tests/test_torch_mesh*.py'),
    'test_halo_spmv_matches_allgather_spmv':
        ('virtual-devices', 'needs one process of 8 virtual XLA devices; the '
                            'mesh paths are held on gloo ranks in '
                            'tests/test_torch_mesh*.py'),
    'test_make_mesh_auto_2d_layout':
        ('virtual-devices', 'needs one process of 8 virtual XLA devices; the '
                            'mesh paths are held on gloo ranks in '
                            'tests/test_torch_mesh*.py'),
    'test_mesh_committed_posterior_fast_path':
        ('virtual-devices', 'needs one process of 8 virtual XLA devices; the '
                            'mesh paths are held on gloo ranks in '
                            'tests/test_torch_mesh*.py'),
    'test_mesh_committed_posterior_halo_forced':
        ('virtual-devices', 'needs one process of 8 virtual XLA devices; the '
                            'mesh paths are held on gloo ranks in '
                            'tests/test_torch_mesh*.py'),
    'test_mesh_lml_parity_with_clustered_data':
        ('virtual-devices', 'needs one process of 8 virtual XLA devices; the '
                            'mesh paths are held on gloo ranks in '
                            'tests/test_torch_mesh*.py'),
    'test_partition_cache_rejects_changed_cols':
        ('virtual-devices', 'needs one process of 8 virtual XLA devices; the '
                            'mesh paths are held on gloo ranks in '
                            'tests/test_torch_mesh*.py'),
    'test_rowpart_gp_api_parity':
        ('virtual-devices', 'needs one process of 8 virtual XLA devices; the '
                            'mesh paths are held on gloo ranks in '
                            'tests/test_torch_mesh*.py'),
    'test_rowpart_partition_cache_hit':
        ('virtual-devices', 'needs one process of 8 virtual XLA devices; the '
                            'mesh paths are held on gloo ranks in '
                            'tests/test_torch_mesh*.py'),
    'test_sharded_covariance_spmm':
        ('virtual-devices', 'needs one process of 8 virtual XLA devices; the '
                            'mesh paths are held on gloo ranks in '
                            'tests/test_torch_mesh*.py'),
    'test_sharded_gp_end_to_end':
        ('virtual-devices', 'needs one process of 8 virtual XLA devices; the '
                            'mesh paths are held on gloo ranks in '
                            'tests/test_torch_mesh*.py'),
    'test_sharded_mbcg_lml_grad_parity':
        ('jnp', 'jax.random probes and jnp operands'),
    'test_slice_groups_no_auto_process_fallback':
        ('jax-internals', 'mesh._slice_groups over JAX device objects'),
    'test_storage_dtype_bf16':
        ('torch-dtypes', "compares the tiles' torch dtype with jnp.bfloat16"),
    'test_update_gp_data_under_mesh':
        ('virtual-devices', 'needs one process of 8 virtual XLA devices; the '
                            'mesh paths are held on gloo ranks in '
                            'tests/test_torch_mesh*.py'),
    'test_zero_tile_filter_reduces_tiles_exactly':
        ('tensors', "np.sum over the matrix's rows, a torch tensor"),
}

load("test_scale.py", ALLOWLIST, globals())
