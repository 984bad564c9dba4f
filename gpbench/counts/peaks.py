"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense
rates, no sparsity; at the 700 W power limit).  TF32 is the tensor cores'
float32-input rate: a 3×TF32 product, which keeps float32 accuracy,
counts as three TF32 products."""

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12,
              "float64": 34e12}


def bound_s(n_bytes, n_ops, peak):
    """The least time the chip could take: the larger of the bytes over
    the memory rate and the operations over the peak rate ``peak``."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_FLOPS[peak])
