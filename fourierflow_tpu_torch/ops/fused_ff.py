"""Fused two-layer feed-forward (counterpart of ``fourierflow_tpu/ops/pallas_ff.py``).

``fused_ff(x, w1, b1, w2, b2) == relu(x @ w1 + b1) @ w2 + b2`` over
``x: [..., C_in]`` with dense weights in the JAX package's layout
(``w1: [C_in, H]``, ``w2: [H, C_out]``); weight norm is folded in by the
caller (``layers.FeedForward``).

On a CPU tensor it runs :func:`fused_ff_plain`. On a CUDA tensor it
launches the hand-written kernel ``csrc/fused_ff.cu`` (which replaces the
TPU kernel ``pallas_ff.py::_ff_kernel``) or raises; it never falls back.
The kernel reads ``w1`` and ``w2`` through their strides, so a transposed
view of torch's ``[out, in]`` weight goes in without a copy.
``fused_ff.launches`` counts calls that reached the kernel.

Bound (H100 SXM data sheet, flagship rows 77,824, C 64, H 256): 5.10 GFLOP
and 39.8 MB f32 (19.9 MB bf16) per call; about 76 us in f32 on CUDA cores
(operations) and 6 us in bf16 (memory). The kernel keeps the hidden layer
on chip; see its source for the tiling.

The backward kernel comes with training support; on CUDA a call that
needs a gradient raises NotImplementedError.
"""

import ctypes
import functools

import torch

from . import _cuda

__all__ = ["fused_ff", "fused_ff_plain", "fused_ff_cuda"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_COUT = 64  # output columns per block row: 4 per thread x 16 threads


def fused_ff_plain(x, w1, b1, w2, b2):
    """The plain PyTorch version, in float32 (other input types are rounded
    to float32 first and the result is cast back to x's type)."""
    f = lambda t: t.float()
    h = torch.relu(f(x) @ f(w1) + f(b1))
    return (h @ f(w2) + f(b2)).to(x.dtype)


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _cuda.load("fused_ff")
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ff_fwd.argtypes = [i, vp, vp, vp, vp, vp, vp, i, i, i, i, i, i, i, i, vp]
    lib.ff_fwd.restype = i
    lib.ff_fwd_smem_bytes.argtypes = [i, i]
    lib.ff_fwd_smem_bytes.restype = ll
    return lib


def _check_args(x, w1, b1, w2, b2):
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_ff kernel takes float32 or bfloat16, got {x.dtype}")
    cin, hidden, cout = x.shape[-1], w1.shape[-1], w2.shape[-1]
    shapes = {"w1": (cin, hidden), "b1": (hidden,), "w2": (hidden, cout), "b2": (cout,)}
    for name, t in zip(shapes, (w1, b1, w2, b2)):
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"fused_ff: {name} is {tuple(t.shape)}, expected {shapes[name]}")
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"fused_ff: {name} is {t.dtype} on {t.device}, x is {x.dtype} on {x.device}")
    for name, t in (("x", x), ("b1", b1), ("b2", b2)):
        if not t.is_contiguous():
            raise ValueError(f"fused_ff kernel needs a contiguous {name}")
    if cout > _MAX_COUT:
        raise ValueError(f"fused_ff kernel takes C_out <= {_MAX_COUT}, got {cout}")
    for name, t in (("w1", w1), ("w2", w2)):
        if sum((n - 1) * abs(st) for n, st in zip(t.shape, t.stride())) >= 2 ** 31:
            raise ValueError(f"fused_ff kernel indexes {name} with int offsets; it spans too far")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1, b1, w2, b2)):
        raise NotImplementedError(
            "fused_ff on CUDA has no backward kernel yet (it comes with training "
            "support, slice 2); call it under torch.no_grad()")


def fused_ff_cuda(x, w1, b1, w2, b2):
    """Launch the CUDA kernel. Raises on anything the kernel does not take."""
    _check_args(x, w1, b1, w2, b2)
    cin, hidden, cout = x.shape[-1], w1.shape[-1], w2.shape[-1]
    rows = x.numel() // cin
    out = torch.empty(*x.shape[:-1], cout, dtype=x.dtype, device=x.device)
    if rows == 0:
        return out
    lib = _lib()
    need = lib.ff_fwd_smem_bytes(cin, cout)
    if need > _cuda.MAX_SMEM:
        raise ValueError(f"fused_ff: C_in={cin}, C_out={cout} needs {need} B of shared memory")
    with torch.cuda.device(x.device):
        err = lib.ff_fwd(_DTYPE_CODE[x.dtype], x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                         w2.data_ptr(), b2.data_ptr(), out.data_ptr(), rows, cin, hidden, cout,
                         *w1.stride(), *w2.stride(), _cuda.stream_ptr(x.device))
    _cuda.check(lib, err, "fused_ff")
    fused_ff.launches += 1
    return out


def fused_ff(x, w1, b1, w2, b2):
    """``relu(x @ w1 + b1) @ w2 + b2`` with the hidden layer kept on chip."""
    if x.device.type == "cpu":
        return fused_ff_plain(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ff runs on cpu or cuda, not {x.device}")
    return fused_ff_cuda(x, w1, b1, w2, b2)


fused_ff.launches = 0
