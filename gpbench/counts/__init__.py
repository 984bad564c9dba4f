"""Operation and byte formulas of kernels and steps, and the peak table."""
