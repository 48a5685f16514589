"""Profiling helpers (counterpart of ``fourierflow_tpu/utils/profiling.py``):
a ``torch.profiler`` trace context that writes a Chrome/Perfetto trace
file, and a steps/sec meter."""

import contextlib
import logging
import os
import time
from typing import Optional

import torch

logger = logging.getLogger(__name__)

__all__ = ["trace", "StepTimer"]


@contextlib.contextmanager
def trace(log_dir: str = "trace", enabled: bool = True, device=None):
    """``with trace('runs/t'):`` records host (CPU) activity, plus the card's
    kernels when ``device`` is a CUDA device (``None``: when a card is
    present), and writes ``trace-<time>.json`` into ``log_dir`` on exit, for
    ui.perfetto.dev or chrome://tracing. Yields the profiler (``None`` when
    not ``enabled``)."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available() if device is None else torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    path = os.path.join(log_dir, f"trace-{int(time.time())}.json")
    prof.export_chrome_trace(path)
    logger.info("wrote profiler trace to %s", path)


class StepTimer:
    """Exponential-moving-average steps/sec meter. On the card, call ``mark``
    after a value read (``float(loss)``) or a ``torch.cuda.synchronize()``:
    kernel launches return before the card has run them."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self._last = None
        self.steps_per_sec: Optional[float] = None

    def mark(self, n_steps: int = 1):
        now = time.perf_counter()
        if self._last is not None:
            rate = n_steps / (now - self._last)
            self.steps_per_sec = (rate if self.steps_per_sec is None
                                  else self.ema * self.steps_per_sec + (1 - self.ema) * rate)
        self._last = now
        return self.steps_per_sec
