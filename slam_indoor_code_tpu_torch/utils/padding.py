"""Static-shape helpers: every dynamic quantity in the reference (feature
counts, match counts, map size) becomes a fixed-capacity array + validity mask
here (SURVEY.md §7 'Hard parts').  These helpers keep capacities aligned to
TPU tiling (lane dim 128, f32 sublane 8)."""

from __future__ import annotations

import numpy as np


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up_to_multiple(x: int, m: int) -> int:
    return cdiv(x, m) * m


def pad_to(arr: np.ndarray, size: int, axis: int = 0, fill=0):
    """Pad ``arr`` along ``axis`` to ``size`` with ``fill`` (host-side)."""
    n = arr.shape[axis]
    if n == size:
        return arr
    if n > size:
        raise ValueError(f"array dim {n} exceeds capacity {size}")
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, size - n)
    return np.pad(arr, widths, constant_values=fill)
