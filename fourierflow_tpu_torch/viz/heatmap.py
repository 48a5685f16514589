"""Midpoint-normalized heatmaps (counterpart of
``fourierflow_tpu/viz/heatmap.py``, after the reference's
``fourierflow/viz/heatmap.py``, which logs vorticity heatmaps with a
diverging colormap centred at zero).

Host code in numpy. matplotlib is imported when a figure is drawn
(``pyplot``), never when the module is imported; where it is not installed
a figure stops with an error that says so.
"""

from typing import Optional

import numpy as np

__all__ = ["midpoint_norm", "log_imshow", "pyplot"]


def pyplot(what: str = "this figure"):
    """``matplotlib.pyplot`` on the Agg backend; SystemExit, naming ``what``,
    where matplotlib is not installed."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        raise SystemExit(f"{what} is a figure and needs matplotlib, which is not installed here; "
                         "the tables (plot table [DATASET]) need none") from None
    return plt


def midpoint_norm(x: np.ndarray, midpoint: float = 0.0) -> np.ndarray:
    """``x`` mapped to [0, 1] with ``midpoint`` at 0.5: the two-slope
    normalization the reference builds from matplotlib's TwoSlopeNorm."""
    x = np.asarray(x, dtype=np.float64)
    lo = min(float(x.min()), midpoint - 1e-12)
    hi = max(float(x.max()), midpoint + 1e-12)
    out = np.empty_like(x)
    below = x <= midpoint
    out[below] = 0.5 * (x[below] - lo) / (midpoint - lo)
    out[~below] = 0.5 + 0.5 * (x[~below] - midpoint) / (hi - midpoint)
    return out


def log_imshow(field: np.ndarray, title: str = "", out_path: Optional[str] = None,
               scale: Optional[float] = None) -> str:
    """A zero-centred diverging heatmap of a 2D field written as a PNG to
    ``out_path`` (default ``heatmap.png``); returns the path. ``scale``
    clips the field to [-scale, scale] first (the reference's
    ``heatmap_scale`` option)."""
    field = np.asarray(field)
    if scale is not None:
        field = np.clip(field, -scale, scale)
    plt = pyplot("a heatmap")
    fig, ax = plt.subplots(figsize=(4, 4))
    lim = max(abs(float(field.min())), abs(float(field.max())), 1e-12)
    im = ax.imshow(field.T, cmap="RdBu_r", vmin=-lim, vmax=lim, origin="lower")
    ax.set_title(title)
    ax.set_xticks([])
    ax.set_yticks([])
    fig.colorbar(im, ax=ax, fraction=0.046)
    out_path = out_path or "heatmap.png"
    fig.savefig(out_path, bbox_inches="tight", dpi=120)
    plt.close(fig)
    return out_path
