"""Fused dual-branch spectral mix (counterpart of
``fourierflow_tpu/ops/pallas_spectral.py``).

``fused_mix_2d(x, wy, wx) == spectral_mix_axis(x, wy, 2) + spectral_mix_axis(x, wx, 1)``.

On a CPU tensor it runs :func:`fused_mix_2d_plain`. On a CUDA tensor it
launches the hand-written kernel ``csrc/fused_spectral.cu`` (which replaces
the TPU kernel ``pallas_spectral.py::_make_mix_kernel``) or raises; it
never falls back. The kernel transforms along one axis given by strides,
so one call is two launches on the current stream: the Y branch writes,
the X branch adds. For bf16 the Y branch writes a float32 scratch that the
X branch reads, so the sum is rounded once, as in the plain version. The
kernel reads the ``[C, C, M, 2]`` weights through their strides, in float32
or x's type, so the wrapper passes the parameters as they are.
``fused_mix_2d.launches`` counts calls that reached the kernel (one per
call, not per branch).

Bound (H100 SXM data sheet, flagship x [19, 64, 64, 64], M 16): 2.55 GFLOP
and 39.8 MB f32 (19.9 MB bf16) per call; about 38 us in f32 and 6 us in
bf16, memory-bound. See the kernel source for the design and its known
weakness (each block rereads the mode weights from L2).

The gradient (the adjoint launch of the same kernel) comes with training
support; on CUDA a call that needs a gradient raises NotImplementedError.
"""

import ctypes
import functools

import torch

from . import _cuda
from .spectral import dft_bases, mix_axis_f32

__all__ = ["fused_mix_2d", "fused_mix_2d_plain", "fused_mix_2d_cuda"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def fused_mix_2d_plain(x: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: Y-axis branch + X-axis branch, summed in
    float32 and rounded once to x's type."""
    return (mix_axis_f32(x, wy, 2) + mix_axis_f32(x, wx, 1)).to(x.dtype)


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _cuda.load("fused_spectral")
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.spectral_axis.argtypes = [i, i, i, vp, vp, vp, vp, ll, ll, ll, ll, vp, vp, i, i, ll, ll, ll,
                                  i, i, i, vp]
    lib.spectral_axis.restype = i
    lib.spectral_axis_smem_bytes.argtypes = [i, i, i]
    lib.spectral_axis_smem_bytes.restype = ll
    return lib


@functools.lru_cache(maxsize=64)
def _kernel_bases(n: int, modes: int, device: torch.device):
    """Forward basis ``[n, 2M]`` (real | imaginary columns) and inverse
    basis ``[2M, n]`` (real | imaginary rows), float32 on ``device``."""
    er, ei, cr, ci = dft_bases(n, modes, device)
    return torch.cat([er, ei], dim=1).contiguous(), torch.cat([cr, ci], dim=0).contiguous()


def _check_args(x, wy, wx):
    if x.dim() != 4:
        raise ValueError(f"x must be [B, X, Y, C], got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_mix_2d kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_mix_2d kernel needs a contiguous x")
    c = x.shape[3]
    for name, w, n in (("wy", wy, x.shape[2]), ("wx", wx, x.shape[1])):
        if w.device != x.device:
            raise ValueError(f"{name} is on {w.device}, x on {x.device}")
        if w.dtype not in (torch.float32, x.dtype):
            raise TypeError(f"{name} is {w.dtype}; the kernel takes float32 or x's {x.dtype}")
        if w.dim() != 4 or w.shape[0] != c or w.shape[1] != c or w.shape[3] != 2:
            raise ValueError(f"{name} must be [C, C, M, 2] with C={c}, got {tuple(w.shape)}")
        if w.shape[2] > n // 2 + 1:
            raise ValueError(f"{name} has {w.shape[2]} modes; axis length {n} allows {n // 2 + 1}")
    if torch.is_grad_enabled() and (x.requires_grad or wy.requires_grad or wx.requires_grad):
        raise NotImplementedError(
            "fused_mix_2d on CUDA has no backward kernel yet (the adjoint launch comes "
            "with training support, slice 2); call it under torch.no_grad()")


def fused_mix_2d_cuda(x: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel twice (Y branch, then X branch). Raises on
    anything the kernel does not take."""
    _check_args(x, wy, wx)
    lib = _lib()
    b, sx, sy, c = x.shape
    for n, w in ((sy, wy), (sx, wx)):
        need = lib.spectral_axis_smem_bytes(n, w.shape[2], c)
        if need > _cuda.MAX_SMEM:
            raise ValueError(f"fused_mix_2d: n={n}, C={c} needs {need} B of shared memory")
    out = torch.empty_like(x)
    code = _DTYPE_CODE[x.dtype]
    first = out if x.dtype == torch.float32 else torch.empty(x.shape, dtype=torch.float32,
                                                             device=x.device)
    stream = _cuda.stream_ptr(x.device)
    # (weights, n, lines per batch element, line stride, element stride, prev, out, out type)
    branches = (
        (wy, sy, sx, sy * c, c, None, first, 0),
        (wx, sx, sy, c, sy * c, first, out, code),
    )
    with torch.cuda.device(x.device):
        for w, n, lines, line_stride, elem_stride, prev, dst, out_code in branches:
            modes = w.shape[2]
            fwd, inv = _kernel_bases(n, modes, x.device)
            err = lib.spectral_axis(
                code, _DTYPE_CODE[w.dtype], out_code, x.data_ptr(), fwd.data_ptr(),
                inv.data_ptr(), w.data_ptr(), *w.stride(),
                None if prev is None else prev.data_ptr(), dst.data_ptr(), b * lines, lines,
                sx * sy * c, line_stride, elem_stride, n, modes, c, stream)
            _cuda.check(lib, err, "fused_mix_2d")
    fused_mix_2d.launches += 1
    return out


def fused_mix_2d(x: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    """Both separable spectral branches: ``[B, X, Y, C] -> [B, X, Y, C]``.
    ``wy`` mixes along Y (axis 2), ``wx`` along X (axis 1); both ``[C, C, M, 2]``."""
    if x.device.type == "cpu":
        return fused_mix_2d_plain(x, wy, wx)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mix_2d runs on cpu or cuda, not {x.device}")
    return fused_mix_2d_cuda(x, wy, wx)


fused_mix_2d.launches = 0
