"""Peaks of one NVIDIA H100 SXM and the least time of the program's
kernels, counted from their shapes.

Frozen copies of chip_smoke.py's arithmetic: the peaks (chip_smoke.py:532-533,
NVIDIA's data sheet: 3.35 TB/s of HBM3, 67 TFLOP/s in float32 outside the
tensor cores), ``bound_ms`` (``_bound_ms``, chip_smoke.py:804-807), K1's
bound (``_k1_bound``, chip_smoke.py:914-915) and K2's (chip_smoke.py:3593-3594).
Each input byte is counted once and each output byte once.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
CUDA_CORE_OPS_PER_S = 67e12   # H100 SXM non-tensor peak (float32 figure)


def bound_ms(n_bytes: float, n_ops: float):
    """(least ms, "bytes" or "operations") for a kernel that moves
    ``n_bytes`` and performs ``n_ops``."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / CUDA_CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bytes_ops(q: int, k: int):
    """K1 (Hamming matrix) of [q, 8] x [k, 8] int32 words: both descriptor
    sets read once, the [q, k] int32 matrix written once; 24 operations a
    pair (8 words: xor, popcount, add)."""
    return (q + k) * 32 + q * k * 4, q * k * 24


def k1_bound_ms(q: int, k: int):
    return bound_ms(*k1_bytes_ops(q, k))


def k2_bytes_ops(h2: int, w2: int, n_links: int):
    """K2 (connected-component minimum labels) over an h2 x w2 grid: init,
    links and labels, 4 bytes a cell each; 8 operations a cell and 4 a
    link."""
    return 12 * h2 * w2, 8 * h2 * w2 + 4 * n_links


def k2_bound_ms(h2: int, w2: int, n_links: int | None = None):
    """K2's least ms. Without ``n_links`` the grid's most (8 a cell) is
    taken: the bytes bound the kernel up to 240 operations a cell, so the
    bound is the same for any links."""
    if n_links is None:
        n_links = 8 * h2 * w2
    return bound_ms(*k2_bytes_ops(h2, w2, n_links))
