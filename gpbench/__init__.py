"""The benchmark of fvgp_tpu_torch (see README.md)."""
