"""Segment sum, the deterministic scatter-add of MeshGraphNet's message
passing.

``segment_sum(values, index, order, offsets)[n] == sum of values[e] over
the rows e with index[e] == n``, in ascending ``e`` and starting from 0:
the order in which ``torch.zeros(n, F).index_add_(0, index, values)`` sums
on the CPU. A row whose index is negative belongs to no segment.
``segment_csr(index, n)`` sorts the index once, stably, into ``(order,
offsets)``; a caller that sums over one index many times (every layer of
``models/meshgraphnet.py``, forward and backward) builds it once.

The sum is the operator ``torch.ops.fourierflow_tpu_torch.segment_sum``. On
a CPU tensor it runs :func:`segment_sum_plain` (``index_add_``). On a CUDA
tensor it launches the hand-written kernel of ``csrc/segment_sum.cu`` or
raises; it never falls back. The kernel replaces no TPU kernel: PyTorch's
``index_add_`` on the card sums with float atomics in an order that changes
from run to run, and this kernel sums each segment in one thread in
ascending order, so a step repeats to the bit and equals the CPU's.
``segment_sum.launches`` counts calls that reached the kernel.

Bound (H100 SXM data sheet): bytes, one add a value. At
``cylinder_flow/baseline``'s shapes in ``chip_smoke.py`` (batch 4: 43,264
used edge slots of 87,984, 7,680 nodes, F 128) 26.5 MB, 7.9 us at 3.35
TB/s.
"""

import ctypes
import functools

import torch

from . import LIBRARY, _cuda

__all__ = ["segment_csr", "segment_sum", "segment_sum_plain", "segment_sum_cuda"]


def segment_csr(index, n):
    """``(order, offsets)`` of the int64 segment ``index [E]`` over ``n``
    segments: ``order`` the rows sorted by segment, stably (each segment's
    rows ascending; rows of a negative index first), and ``offsets [n + 1]``
    with segment ``k``'s rows at ``order[offsets[k]:offsets[k + 1]]``."""
    sorted_index, order = torch.sort(index, stable=True)
    bounds = torch.arange(n + 1, device=index.device, dtype=index.dtype)
    return order, torch.searchsorted(sorted_index, bounds)


def segment_sum_plain(values, index, order, offsets):
    """The plain PyTorch version: ``index_add_`` into zeros, the rows of a
    negative index added to a row past the last segment and dropped."""
    n = offsets.shape[0] - 1
    rows = torch.where(index < 0, n, index)
    return values.new_zeros(n + 1, values.shape[1]).index_add_(0, rows, values)[:n]


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _cuda.load("segment_sum")
    vp = ctypes.c_void_p
    lib.segment_sum.argtypes = [vp, vp, vp, vp, ctypes.c_longlong, ctypes.c_int, vp]
    lib.segment_sum.restype = ctypes.c_int
    return lib


def _check_args(values, index, order, offsets):
    """What the kernel takes."""
    if values.dtype != torch.float32 or values.dim() != 2:
        raise TypeError(f"segment_sum kernel takes float32 values [rows, F], got {values.dtype} "
                        f"{tuple(values.shape)}")
    for name, t in (("index", index), ("order", order), ("offsets", offsets)):
        if t.dtype != torch.int64 or t.dim() != 1 or t.device != values.device:
            raise ValueError(f"segment_sum: {name} is {t.dtype} {tuple(t.shape)} on {t.device}, "
                             f"expected one dimension of int64 on {values.device}")
    if index.shape[0] != values.shape[0] or order.shape[0] != values.shape[0]:
        raise ValueError(f"segment_sum: index {tuple(index.shape)} and order "
                         f"{tuple(order.shape)} for {values.shape[0]} rows of values")
    for name, t in (("values", values), ("order", order), ("offsets", offsets)):
        if not t.is_contiguous():
            raise ValueError(f"segment_sum kernel needs a contiguous {name}")


def segment_sum_cuda(values, index, order, offsets):
    """Launch the kernel. Raises on anything it does not take; no launch
    for no segments or no features."""
    _check_args(values, index, order, offsets)
    n, f = offsets.shape[0] - 1, values.shape[1]
    out = torch.empty(n, f, dtype=values.dtype, device=values.device)
    if n == 0 or f == 0:
        return out
    lib = _lib()
    with torch.cuda.device(values.device):
        err = lib.segment_sum(values.data_ptr(), order.data_ptr(), offsets.data_ptr(),
                              out.data_ptr(), n, f, _cuda.stream_ptr(values.device))
    _cuda.check(lib, err, "segment_sum")
    segment_sum.launches += 1
    return out


def _segment_sum_meta(values, index, order, offsets):
    return values.new_empty(offsets.shape[0] - 1, values.shape[1])


_SEGMENT_OP = _cuda.register_op(
    LIBRARY, "segment_sum", "(Tensor values, Tensor index, Tensor order, Tensor offsets) -> Tensor",
    segment_sum_plain, segment_sum_cuda, _segment_sum_meta)


def segment_sum(values, index, order, offsets):
    """``[n, F]`` segment sums of ``values [E, F]`` over ``index [E]``,
    ``(order, offsets)`` from :func:`segment_csr`, on the device of
    ``values``. Not differentiable by itself: ``models/meshgraphnet.py``
    wraps it in autograd Functions."""
    _cuda.check_device(values, "segment_sum")
    return _SEGMENT_OP(values, index, order, offsets)


segment_sum.launches = 0
