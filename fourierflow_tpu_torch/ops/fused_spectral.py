"""Fused dual-branch spectral mix (counterpart of
``fourierflow_tpu/ops/pallas_spectral.py``).

``fused_mix_2d(x, wy, wx) == spectral_mix_axis(x, wy, 2) + spectral_mix_axis(x, wx, 1)``,
a ``torch.autograd.Function``: the forward and the backward each run on
the device of ``x``.

The forward and the gradient with respect to x are the operators
``torch.ops.fourierflow_tpu_torch.fused_mix_2d`` and
``fused_mix_2d_adjoint``. On a CPU tensor they run
:func:`fused_mix_2d_plain` and :func:`fused_mix_2d_adjoint_plain`. On a
CUDA tensor both launch the hand-written kernel ``csrc/fused_spectral.cu``
(which replaces the TPU kernel ``pallas_spectral.py::_make_mix_kernel``) or
raise; they never fall back. Their Meta implementations give shapes only,
so ``torch.export`` keeps each forward call as one node that launches the
kernel when the program runs on the card. The kernel transforms along one axis given by
strides, so one call is two launches on the current stream: the Y branch
writes, the X branch adds. In bf16 both the kernel and the plain version
round where the JAX kernel's ``_branch`` rounds: the bases, the spectra
after the forward product and the mixed spectra, each to bf16, with every
product and sum in float32; the Y branch writes a float32 scratch that
the X branch reads, so the sum of the two branches is rounded once. The
weight gradients round their spectra and products as ``_fused_mix_bwd``'s
einsums in x's type do. In float32 nothing is rounded. The kernel reads
the ``[C, C, M, 2]`` weights through their strides, in float32 or x's
type, so the wrapper passes the model's parameters as they are. The gradient with
respect to x is the same kernel on the adjoint operator, as
``_fused_mix_bwd`` launches the TPU kernel: transposed bases swapped,
weights read (i, o)-transposed through swapped strides and conjugated in
the kernel. The weight gradients are einsums over recomputed
spectra (:func:`ops.spectral.mix_axis_wgrad`), outside any kernel, as the
JAX package leaves them to XLA. ``fused_mix_2d.launches`` and
``fused_mix_2d_adjoint.launches`` count calls that reached the kernel (one
per call, not per branch).

Bound (H100 SXM data sheet, flagship x [19, 64, 64, 64], M 16), for the
forward and the adjoint alike: 2.55 GFLOP and 39.8 MB f32 (19.9 MB bf16)
per call; about 15 us in f32 (operations, 3xTF32 on tensor cores) and 6 us
in bf16 (bytes). The kernel keeps its arithmetic on CUDA cores (0.64 G FMA
an axis launch). Its layout (see the kernel source): 10 lines a block of
512 threads, 122 blocks at the flagship (one round on 132 SMs), the mode
weights streamed through a double-buffered shared-memory ring by
``cp.async`` in chunks of 4 input channels, each chunk read from L2 once a
block (64 MB an axis launch in f32), x streamed the same way in chunks of
8 samples. A block walks the modes in chunks (:func:`_mode_chunk`: all
M where they fit, as at the flagship; 16 of 32 at n 128, 12 of 64 at n
256), so its shared memory does not grow with M: each chunk stages its
bases, takes its spectra from x (read again for every chunk), mixes them
with its weights and adds its inverse into the output lines, whose partial
sums between chunks live in a float32 array of the output's layout (the
Y launch's output or the float32 scratch). :func:`_smem_bytes` mirrors the
kernel's shared-memory size at that chunk; a shape where not even one mode
fits, or a C wider than ``3 * 512``, raises a ``ValueError``. Weights whose
(i, o) runs of 2M values are not contiguous (``[..., M, 2]`` strides other
than ``(2, 1)``) are copied to a contiguous tensor first.
"""

import ctypes
import functools

import torch

from . import LIBRARY, _cuda
from .spectral import mix_axis_f32, mix_axis_wgrad, stacked_bases

__all__ = ["fused_mix_2d", "fused_mix_2d_plain", "fused_mix_2d_cuda", "fused_mix_2d_adjoint",
           "fused_mix_2d_adjoint_plain", "fused_mix_2d_adjoint_cuda"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# As in csrc/fused_spectral.cu: threads and lines a block (NT, LB); x stages
# and samples of each (XS, TC); weight stages and input channels of each
# (WS, IC); spectrum columns and samples a thread (KC, SC); output channels
# a thread and mode in the mix, at most (PMAX).
_NT, _LB, _XS, _TC, _WS, _IC, _KC, _SC, _PMAX = 512, 10, 2, 8, 2, 4, 8, 8, 3


def fused_mix_2d_plain(x: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: Y-axis branch + X-axis branch, each rounding
    its bases and spectra to x's type as the JAX kernel does, summed in
    float32 and rounded once to x's type."""
    return (mix_axis_f32(x, wy, 2, round_to=x.dtype)
            + mix_axis_f32(x, wx, 1, round_to=x.dtype)).to(x.dtype)


def fused_mix_2d_adjoint_plain(g: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    """The gradient of :func:`fused_mix_2d_plain` with respect to x, given
    the output gradient ``g``: both branches' adjoints, rounding as the
    forward does, summed in float32 and rounded once to g's type."""
    return (mix_axis_f32(g, wy, 2, adjoint=True, round_to=g.dtype)
            + mix_axis_f32(g, wx, 1, adjoint=True, round_to=g.dtype)).to(g.dtype)


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _cuda.load("fused_spectral")
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.spectral_axis.argtypes = [i, i, i, vp, vp, vp, vp, ll, ll, ll, ll, i, vp, vp, vp, i, i, ll,
                                  ll, ll, i, i, i, vp]
    lib.spectral_axis.restype = i
    lib.spectral_axis_smem_bytes.argtypes = [i, i, i, i, i]
    lib.spectral_axis_smem_bytes.restype = ll
    lib.spectral_axis_mode_chunk.argtypes = [i, i, i, i, i]
    lib.spectral_axis_mode_chunk.restype = i
    return lib


@functools.lru_cache(maxsize=64)
def _adjoint_bases(n: int, modes: int, device: torch.device):
    """The adjoint's bases in the kernel's layout: the inverse basis
    transposed ``[n, 2M]`` and the forward one transposed ``[2M, n]``."""
    fwd, inv = stacked_bases(n, modes, device)
    return inv.t().contiguous(), fwd.t().contiguous()


def _layout_bytes(n: int, chunk: int, c: int, xs: int, wsz: int) -> int:
    """Shared memory of one block for a chunk of ``chunk`` modes
    (``smem_layout`` in the source): the weight ring (WS stages of IC input
    channels, [C, 2 chunk] each, in the weights' type), the x ring (XS
    stages of LB lines x TC samples x C, in x's type), the forward basis
    [n, 2 chunk padded to KC], the inverse basis [2 chunk, n padded to SC]
    and the spectra [LB, C, 2 (chunk | 1)], in float32, and an int64 offset
    for each of the LB lines."""
    up = lambda a, b: -(-a // b) * b
    k = 2 * chunk
    return (_WS * _IC * c * k * wsz + _XS * _LB * _TC * c * xs + 4 * n * up(k, _KC)
            + 4 * k * up(n, _SC) + 4 * _LB * c * 2 * (chunk | 1) + 8 * _LB)


def _mode_chunk(n: int, modes: int, c: int, x_dtype: torch.dtype, w_dtype: torch.dtype) -> int:
    """Modes a block takes at once (``mode_chunk`` in the source): all of
    them where the block's shared memory and the mix's C <= PMAX * (NT //
    chunk) allow, else the largest multiple of 4 that fits (or 3, 2, 1),
    evened out over the chunks it needs; 0 if not even one mode fits."""
    xs, wsz = (torch.finfo(t).bits // 8 for t in (x_dtype, w_dtype))
    fits = lambda mc: (_layout_bytes(n, mc, c, xs, wsz) <= _cuda.MAX_SMEM
                       and c <= _PMAX * (_NT // mc))
    if fits(modes):
        return modes
    best = max((mc for mc in range(4, modes, 4) if fits(mc)), default=0)
    best = best or next((mc for mc in range(min(3, modes - 1), 0, -1) if fits(mc)), 0)
    if not best:
        return 0
    chunks = -(-modes // best)
    even = -(-modes // chunks)
    return min(best, -(-even // 4) * 4)


def _smem_bytes(n: int, modes: int, c: int, x_dtype: torch.dtype, w_dtype: torch.dtype) -> int:
    """Shared memory of one block at the kernel's mode chunk for this shape
    (the whole of M where it fits)."""
    xs, wsz = (torch.finfo(t).bits // 8 for t in (x_dtype, w_dtype))
    return _layout_bytes(n, _mode_chunk(n, modes, c, x_dtype, w_dtype) or modes, c, xs, wsz)


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
        modes = w.shape[2]
        if not 1 <= modes <= n // 2 + 1:
            raise ValueError(f"{name} has {modes} modes; axis length {n} allows {n // 2 + 1}")
        # A block walks the modes in chunks; one mode must fit its shared
        # memory, and the mix gives each thread one mode of a chunk and up to
        # PMAX output channels.
        if not _mode_chunk(n, modes, c, x.dtype, w.dtype):
            need = _layout_bytes(n, 1, c, *(torch.finfo(t).bits // 8 for t in (x.dtype, w.dtype)))
            raise ValueError(f"fused_mix_2d: {name} at n={n}, C={c} needs {need} B of shared "
                             f"memory in {x.dtype} for one mode, more than {_cuda.MAX_SMEM}, or "
                             f"C above {_PMAX} * 512 = {_PMAX * _NT}")


def _stageable(w: torch.Tensor) -> torch.Tensor:
    """``w`` itself where every (i, o) run of 2M values is contiguous and
    (re, im)-aligned, as the kernel stages it; else a contiguous copy."""
    ok = (w.stride(3) == 1 and w.stride(2) == 2 and w.stride(0) % 2 == 0 and w.stride(1) % 2 == 0
          and w.data_ptr() % (2 * w.element_size()) == 0)
    return w if ok else w.clone(memory_format=torch.contiguous_format)


def _launch(x: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor, adjoint: bool) -> torch.Tensor:
    """Both axis launches of the kernel on x, on the operator or its adjoint."""
    _check_args(x, wy, wx)
    lib = _lib()
    b, sx, sy, c = x.shape
    wy, wx = _stageable(wy), _stageable(wx)
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
                None if prev is None else prev.data_ptr(), first.data_ptr(), dst.data_ptr(),
                b * lines, lines, sx * sy * c, line_stride, elem_stride, n, modes, c, stream)
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


def _mix_meta(x: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(x)


_MIX_SCHEMA = "(Tensor x, Tensor wy, Tensor wx) -> Tensor"
_MIX_OP = _cuda.register_op(LIBRARY, "fused_mix_2d", _MIX_SCHEMA, fused_mix_2d_plain,
                            fused_mix_2d_cuda, _mix_meta)
_MIX_ADJOINT_OP = _cuda.register_op(LIBRARY, "fused_mix_2d_adjoint", _MIX_SCHEMA,
                                    fused_mix_2d_adjoint_plain, fused_mix_2d_adjoint_cuda,
                                    _mix_meta)


def fused_mix_2d_adjoint(g: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    """The gradient of :func:`fused_mix_2d` with respect to x given the
    output gradient ``g``, on the device of ``g``."""
    _cuda.check_device(g, "fused_mix_2d_adjoint")
    return _MIX_ADJOINT_OP(g, wy, wx)


class _FusedMix2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wy, wx):
        _cuda.check_device(x, "fused_mix_2d")
        ctx.save_for_backward(x, wy, wx)
        return _MIX_OP(x, wy, wx)

    @staticmethod
    def backward(ctx, g):
        x, wy, wx = ctx.saved_tensors
        g = g.contiguous()
        need_x, need_wy, need_wx = ctx.needs_input_grad
        dx = fused_mix_2d_adjoint(g, wy, wx) if need_x else None
        wgrad = lambda w, axis: mix_axis_wgrad(x, g, w.shape[2], axis, round_to=x.dtype).to(w.dtype)
        dwy = wgrad(wy, 2) if need_wy else None
        dwx = wgrad(wx, 1) if need_wx else None
        return dx, dwy, dwx


def fused_mix_2d(x: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    """Both separable spectral branches: ``[B, X, Y, C] -> [B, X, Y, C]``.
    ``wy`` mixes along Y (axis 2), ``wx`` along X (axis 1); both
    ``[C, C, M, 2]``. Differentiable in every argument."""
    return _FusedMix2d.apply(x, wy, wx)


fused_mix_2d.launches = 0
fused_mix_2d_adjoint.launches = 0
