"""Space-filling-curve data ordering for the block-sparse scale path.

The covariance tile grid blocks *consecutive indices*.  With randomly
ordered data each block's bounding box spans the whole domain and the
support-radius prune never fires; ordering the points along a Morton
(Z-order) curve makes index-contiguous blocks spatially compact, which is
what turns a compactly-supported kernel into tile-level sparsity.

The reference reaches sparsity differently — per-element COO inside each
Dask block via KD-tree support search (kernels.py:658-738) — which has no
static-shape equivalent on a TPU.  Reordering the dataset once on the host
is the shape-stable answer: a GP is permutation-invariant, so only the
internal storage order changes.
"""

import numpy as np

__all__ = ["morton_order", "spread_bits"]

_BITS = 16


def spread_bits(v, ndim):
    """Interleave-ready spreading: place the bits of v (< 2^16) ndim apart.
    Bits are capped so every shifted position fits in 64 bits (12 usable
    bits at d=5, 8 at d=8) — shifts past the word width are UB."""
    v = v.astype(np.uint64)
    out = np.zeros_like(v)
    bits = min(_BITS, 64 // ndim)
    for bit in range(bits):
        out |= ((v >> np.uint64(bit)) & np.uint64(1)) << np.uint64(bit * ndim)
    return out


def morton_order(x):
    """Permutation sorting rows of x (n, d) along a Morton curve.

    Dimensions beyond 8 are ignored for the code (they rarely carry the
    spatial structure); ties fall back to stable order.  The code
    computation runs in the native C++ runtime when available
    (fvgp_tpu_torch.native), numpy otherwise — both produce identical codes.
    """
    x = np.asarray(x, dtype=np.float64)
    from ..native import morton_codes
    code = morton_codes(x)
    return np.argsort(code, kind="stable")
