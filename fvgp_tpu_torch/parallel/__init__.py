from . import block_sparse, mesh, partition, sharded_cov  # noqa: F401
