"""Fused dual-branch spectral mix (counterpart of
``fourierflow_tpu/ops/pallas_spectral.py``).

``fused_mix_2d(x, wy, wx) == spectral_mix_axis(x, wy, 2) + spectral_mix_axis(x, wx, 1)``,
a ``torch.autograd.Function``: the forward and the backward each run on
the device of ``x``.

On a CPU tensor the forward runs :func:`fused_mix_2d_plain` and the
gradient with respect to x :func:`fused_mix_2d_adjoint_plain`. On a CUDA
tensor both launch the hand-written kernel ``csrc/fused_spectral.cu``
(which replaces the TPU kernel ``pallas_spectral.py::_make_mix_kernel``) or
raise; they never fall back. The kernel transforms along one axis given by
strides, so one call is two launches on the current stream: the Y branch
writes, the X branch adds. For bf16 the Y branch writes a float32 scratch
that the X branch reads, so the sum is rounded once, as in the plain
version. The kernel reads the ``[C, C, M, 2]`` weights through their
strides, in float32 or x's type, so the wrapper passes the parameters as
they are. The gradient with respect to x is the same kernel on the adjoint
operator, as ``_fused_mix_bwd`` launches the TPU kernel: transposed bases
swapped, weights read (i, o)-transposed through swapped strides and
conjugated in the kernel. The weight gradients are einsums over recomputed
spectra (:func:`ops.spectral.mix_axis_wgrad`), outside any kernel, as the
JAX package leaves them to XLA. ``fused_mix_2d.launches`` and
``fused_mix_2d_adjoint.launches`` count calls that reached the kernel (one
per call, not per branch).

Bound (H100 SXM data sheet, flagship x [19, 64, 64, 64], M 16), for the
forward and the adjoint alike: 2.55 GFLOP and 39.8 MB f32 (19.9 MB bf16)
per call; about 38 us in f32 and 6 us in bf16. See the kernel source for
the design and its known weakness (each block rereads the mode weights
from L2).
"""

import ctypes
import functools

import torch

from . import _cuda
from .spectral import mix_axis_f32, mix_axis_wgrad, stacked_bases

__all__ = ["fused_mix_2d", "fused_mix_2d_plain", "fused_mix_2d_cuda", "fused_mix_2d_adjoint",
           "fused_mix_2d_adjoint_plain", "fused_mix_2d_adjoint_cuda"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def fused_mix_2d_plain(x: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: Y-axis branch + X-axis branch, summed in
    float32 and rounded once to x's type."""
    return (mix_axis_f32(x, wy, 2) + mix_axis_f32(x, wx, 1)).to(x.dtype)


def fused_mix_2d_adjoint_plain(g: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    """The gradient of :func:`fused_mix_2d_plain` with respect to x, given
    the output gradient ``g``: both branches' adjoints, summed in float32
    and rounded once to g's type."""
    return (mix_axis_f32(g, wy, 2, adjoint=True) + mix_axis_f32(g, wx, 1, adjoint=True)).to(g.dtype)


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _cuda.load("fused_spectral")
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.spectral_axis.argtypes = [i, i, i, vp, vp, vp, vp, ll, ll, ll, ll, i, vp, vp, i, i, ll, ll,
                                  ll, i, i, i, vp]
    lib.spectral_axis.restype = i
    lib.spectral_axis_smem_bytes.argtypes = [i, i, i]
    lib.spectral_axis_smem_bytes.restype = ll
    return lib


@functools.lru_cache(maxsize=64)
def _adjoint_bases(n: int, modes: int, device: torch.device):
    """The adjoint's bases in the kernel's layout: the inverse basis
    transposed ``[n, 2M]`` and the forward one transposed ``[2M, n]``."""
    fwd, inv = stacked_bases(n, modes, device)
    return inv.t().contiguous(), fwd.t().contiguous()


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


def _launch(x: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor, adjoint: bool) -> torch.Tensor:
    """Both axis launches of the kernel on x, on the operator or its adjoint."""
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
            fwd, inv = (_adjoint_bases if adjoint else stacked_bases)(n, modes, x.device)
            s_i, s_o, s_m, s_p = w.stride()
            if adjoint:  # read W[o, i] where the kernel reads W[i, o]
                s_i, s_o = s_o, s_i
            err = lib.spectral_axis(
                code, _DTYPE_CODE[w.dtype], out_code, x.data_ptr(), fwd.data_ptr(),
                inv.data_ptr(), w.data_ptr(), s_i, s_o, s_m, s_p, int(adjoint),
                None if prev is None else prev.data_ptr(), dst.data_ptr(), b * lines, lines,
                sx * sy * c, line_stride, elem_stride, n, modes, c, stream)
            _cuda.check(lib, err, "fused_mix_2d adjoint" if adjoint else "fused_mix_2d")
    return out


def fused_mix_2d_cuda(x: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel twice (Y branch, then X branch). Raises on
    anything the kernel does not take."""
    out = _launch(x, wy, wx, adjoint=False)
    fused_mix_2d.launches += 1
    return out


def fused_mix_2d_adjoint_cuda(g: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel twice on the adjoint operator. Raises on
    anything the kernel does not take."""
    out = _launch(g, wy, wx, adjoint=True)
    fused_mix_2d_adjoint.launches += 1
    return out


def fused_mix_2d_adjoint(g: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    """The gradient of :func:`fused_mix_2d` with respect to x given the
    output gradient ``g``, on the device of ``g``."""
    return _cuda.dispatch(g, fused_mix_2d_adjoint_plain, fused_mix_2d_adjoint_cuda,
               "fused_mix_2d_adjoint")(g, wy, wx)


class _FusedMix2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wy, wx):
        ctx.save_for_backward(x, wy, wx)
        return _cuda.dispatch(x, fused_mix_2d_plain, fused_mix_2d_cuda, "fused_mix_2d")(x, wy, wx)

    @staticmethod
    def backward(ctx, g):
        x, wy, wx = ctx.saved_tensors
        g = g.contiguous()
        need_x, need_wy, need_wx = ctx.needs_input_grad
        dx = fused_mix_2d_adjoint(g, wy, wx) if need_x else None
        dwy = mix_axis_wgrad(x, g, wy.shape[2], 2).to(wy.dtype) if need_wy else None
        dwx = mix_axis_wgrad(x, g, wx.shape[2], 1).to(wx.dtype) if need_wx else None
        return dx, dwy, dwx


def fused_mix_2d(x: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    """Both separable spectral branches: ``[B, X, Y, C] -> [B, X, Y, C]``.
    ``wy`` mixes along Y (axis 2), ``wx`` along X (axis 1); both
    ``[C, C, M, 2]``. Differentiable in every argument."""
    return _FusedMix2d.apply(x, wy, wx)


fused_mix_2d.launches = 0
fused_mix_2d_adjoint.launches = 0
