"""Figures of fields (counterpart of ``fourierflow_tpu/viz``)."""

from .heatmap import log_imshow, midpoint_norm, pyplot

__all__ = ["log_imshow", "midpoint_norm", "pyplot"]
