"""Hilbert-curve ordering of scattered 2D points (counterpart of
``fourierflow_tpu/utils/hilbert.py``, in numpy): the iterative xy ->
Hilbert index map on a ``2^order`` lattice, and the permutation that orders
points along the curve, so that nearby points sit together in memory."""

import numpy as np

__all__ = ["hilbert_index", "hilbert_sort"]


def hilbert_index(xs: np.ndarray, ys: np.ndarray, order: int = 16) -> np.ndarray:
    """Hilbert-curve index of integer lattice coordinates on a ``2^order``
    grid: walk the quadrant bits from the top, add each sub-square's
    offset, and reflect or transpose the quadrant back onto the canonical
    orientation."""
    x = np.asarray(xs, dtype=np.int64).copy()
    y = np.asarray(ys, dtype=np.int64).copy()
    d = np.zeros_like(x)
    s = np.int64(1) << (order - 1)
    while s > 0:
        rx = ((x & s) > 0).astype(np.int64)
        ry = ((y & s) > 0).astype(np.int64)
        d += s * s * ((3 * rx) ^ ry)
        flip = ry == 0
        reflect = flip & (rx == 1)
        x = np.where(reflect, s - 1 - x, x)
        y = np.where(reflect, s - 1 - y, y)
        x, y = np.where(flip, y, x), np.where(flip, x, y)
        s >>= 1
    return d


def hilbert_sort(mesh_pos: np.ndarray, order: int = 16) -> np.ndarray:
    """The permutation ``[n_points]`` that orders the points ``mesh_pos
    [n_points, 2]`` (any range) along a Hilbert curve of ``2^order`` cells
    per axis, ties kept in their order."""
    pos = np.asarray(mesh_pos, dtype=np.float64)
    lo = pos.min(axis=0)
    span = np.maximum(pos.max(axis=0) - lo, 1e-12)
    scale = (np.int64(1) << order) - 1
    quant = ((pos - lo) / span * scale).astype(np.int64)
    return np.argsort(hilbert_index(quant[:, 0], quant[:, 1], order), kind="stable")
