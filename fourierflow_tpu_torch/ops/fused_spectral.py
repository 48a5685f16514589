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
the ``[C_in, C_out, M, 2]`` weights through their strides, in float32 or x's
type, so the wrapper passes the model's parameters as they are: the
model's square ones, or under tensor parallelism a column shard (C_out =
C_in / tp; its adjoint gives a partial gradient over all of C_in, which the
layer all-reduces). The gradient with
respect to x is the same kernel on the adjoint operator, as
``_fused_mix_bwd`` launches the TPU kernel: transposed bases swapped,
weights read (i, o)-transposed through swapped strides and conjugated in
the kernel. The weight gradients are einsums over recomputed
spectra (:func:`ops.spectral.mix_axis_wgrad`), outside any kernel, as the
JAX package leaves them to XLA. ``fused_mix_2d.launches`` and
``fused_mix_2d_adjoint.launches`` count calls that reached the kernel (one
per call, not per branch).

``fused_mix_axis(x, w, axis)`` is one branch alone (the operators
``fused_mix_axis`` and ``fused_mix_axis_adjoint``, one launch each, counted
by ``fused_mix_axis.launches`` and ``fused_mix_axis_adjoint.launches``,
which ``ops.launch_counts(ops.AXIS_KERNELS)`` reports apart from the
two-launch calls),
returned in float32 for the caller to sum and round once: the spatially
split layer (``models/ffno_grid_2d.py``) mixes Y on its rows and X after
an all-to-all. Its plain version is :func:`ops.spectral.mix_axis_f32`.

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
fits, or a C_out wider than ``3 * 512``, raises a ``ValueError``. Weights whose
(i, o) runs of 2M values are not contiguous (``[..., M, 2]`` strides other
than ``(2, 1)``) are copied to a contiguous tensor first.
"""

import ctypes
import functools

import torch

from . import LIBRARY, _cuda
from .spectral import mix_axis_f32, mix_axis_wgrad, stacked_bases

__all__ = ["fused_mix_2d", "fused_mix_2d_plain", "fused_mix_2d_cuda", "fused_mix_2d_adjoint",
           "fused_mix_2d_adjoint_plain", "fused_mix_2d_adjoint_cuda", "fused_mix_axis",
           "fused_mix_axis_plain", "fused_mix_axis_cuda", "fused_mix_axis_adjoint",
           "fused_mix_axis_adjoint_plain", "fused_mix_axis_adjoint_cuda"]

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
                                  ll, ll, ll, ll, ll, i, i, i, i, vp]
    lib.spectral_axis.restype = i
    lib.spectral_axis_smem_bytes.argtypes = [i, i, i, i, i, i]
    lib.spectral_axis_smem_bytes.restype = ll
    lib.spectral_axis_mode_chunk.argtypes = [i, i, i, i, i, i]
    lib.spectral_axis_mode_chunk.restype = i
    return lib


@functools.lru_cache(maxsize=64)
def _adjoint_bases(n: int, modes: int, device: torch.device):
    """The adjoint's bases in the kernel's layout: the inverse basis
    transposed ``[n, 2M]`` and the forward one transposed ``[2M, n]``."""
    fwd, inv = stacked_bases(n, modes, device)
    return inv.t().contiguous(), fwd.t().contiguous()


def _layout_bytes(n: int, chunk: int, ci: int, xs: int, wsz: int, co: int = None) -> int:
    """Shared memory of one block for a chunk of ``chunk`` modes
    (``smem_layout`` in the source): the weight ring (WS stages of IC input
    channels, [C_out, 2 chunk] each, in the weights' type), the x ring (XS
    stages of LB lines x TC samples x C_in, in x's type), the forward basis
    [n, 2 chunk padded to KC], the inverse basis [2 chunk, n padded to SC]
    and the spectra [LB, max(C_in, C_out), 2 (chunk | 1)], in float32, and
    an int64 offset in x for each of the LB lines. ``co`` None is ``ci``."""
    co = ci if co is None else co
    up = lambda a, b: -(-a // b) * b
    k = 2 * chunk
    return (_WS * _IC * co * k * wsz + _XS * _LB * _TC * ci * xs + 4 * n * up(k, _KC)
            + 4 * k * up(n, _SC) + 4 * _LB * max(ci, co) * 2 * (chunk | 1) + 8 * _LB)


def _sizes(x_dtype: torch.dtype, w_dtype: torch.dtype):
    return tuple(torch.finfo(t).bits // 8 for t in (x_dtype, w_dtype))


def _mode_chunk(n: int, modes: int, ci: int, x_dtype: torch.dtype, w_dtype: torch.dtype,
                co: int = None) -> int:
    """Modes a block takes at once (``mode_chunk`` in the source): all of
    them where the block's shared memory and the mix's C_out <= PMAX * (NT
    // chunk) allow, else the largest multiple of 4 that fits (or 3, 2, 1),
    evened out over the chunks it needs; 0 if not even one mode fits.
    ``co`` None is ``ci``."""
    co = ci if co is None else co
    xs, wsz = _sizes(x_dtype, w_dtype)
    fits = lambda mc: (_layout_bytes(n, mc, ci, xs, wsz, co) <= _cuda.MAX_SMEM
                       and co <= _PMAX * (_NT // mc))
    if fits(modes):
        return modes
    best = max((mc for mc in range(4, modes, 4) if fits(mc)), default=0)
    best = best or next((mc for mc in range(min(3, modes - 1), 0, -1) if fits(mc)), 0)
    if not best:
        return 0
    chunks = -(-modes // best)
    even = -(-modes // chunks)
    return min(best, -(-even // 4) * 4)


def _smem_bytes(n: int, modes: int, ci: int, x_dtype: torch.dtype, w_dtype: torch.dtype,
                co: int = None) -> int:
    """Shared memory of one block at the kernel's mode chunk for this shape
    (the whole of M where it fits)."""
    chunk = _mode_chunk(n, modes, ci, x_dtype, w_dtype, co) or modes
    return _layout_bytes(n, chunk, ci, *_sizes(x_dtype, w_dtype), co)


def _check_args(x, wy, wx, adjoint=False):
    """What the two-axis call takes (``_check``); returns its output's channels."""
    return _check(x, (("wy", wy, 2), ("wx", wx, 1)), adjoint, "fused_mix_2d")


def _check(x, ws, adjoint, what):
    """What the kernel takes, for ``x`` and each ``(name, w, axis)`` of
    ``ws``; returns the output's channels. The forward maps x's C_in = w's
    dim 0 to w's dim 1, the adjoint x's C_out = w's dim 1 to w's dim 0."""
    if x.dim() != 4:
        raise ValueError(f"x must be [B, X, Y, C], got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what} kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} kernel needs a contiguous x")
    ci, cout = x.shape[3], None
    d_in, d_out = (1, 0) if adjoint else (0, 1)
    for name, w, axis in ws:
        n = x.shape[axis]
        if w.device != x.device:
            raise ValueError(f"{name} is on {w.device}, x on {x.device}")
        if w.dtype not in (torch.float32, x.dtype):
            raise TypeError(f"{name} is {w.dtype}; the kernel takes float32 or x's {x.dtype}")
        if w.dim() != 4 or w.shape[d_in] != ci or w.shape[3] != 2:
            dims = "[C_in, C_out, M, 2] with C_out" if adjoint else "[C_in, C_out, M, 2] with C_in"
            raise ValueError(f"{name} must be {dims}={ci}, got {tuple(w.shape)}")
        if cout is not None and w.shape[d_out] != cout:
            raise ValueError(f"{what}: the branches' weights give {cout} and {w.shape[d_out]} "
                             "output channels")
        cout = w.shape[d_out]
        modes = w.shape[2]
        if not 1 <= modes <= n // 2 + 1:
            raise ValueError(f"{name} has {modes} modes; axis length {n} allows {n // 2 + 1}")
        # A block walks the modes in chunks; one mode must fit its shared
        # memory, and the mix gives each thread one mode of a chunk and up to
        # PMAX output channels.
        if not _mode_chunk(n, modes, ci, x.dtype, w.dtype, cout):
            need = _layout_bytes(n, 1, ci, *_sizes(x.dtype, w.dtype), cout)
            shape = f"C={ci}" + (f", C_out={cout}" if cout != ci else "")
            raise ValueError(f"{what}: {name} at n={n}, {shape} needs {need} B of shared memory "
                             f"in {x.dtype} for one mode, more than {_cuda.MAX_SMEM}, or C above "
                             f"{_PMAX} * 512 = {_PMAX * _NT}")
    return cout


def _stageable(w: torch.Tensor) -> torch.Tensor:
    """``w`` itself where every (i, o) run of 2M values is contiguous and
    (re, im)-aligned, as the kernel stages it; else a contiguous copy."""
    ok = (w.stride(3) == 1 and w.stride(2) == 2 and w.stride(0) % 2 == 0 and w.stride(1) % 2 == 0
          and w.data_ptr() % (2 * w.element_size()) == 0)
    return w if ok else w.clone(memory_format=torch.contiguous_format)


def _launch_axis(lib, x, w, axis, adjoint, prev, acc, out, stream, what):
    """One launch of ``spectral_axis`` along ``axis`` (1: X, 2: Y) of x [B,
    X, Y, C_in] into ``out`` [B, X, Y, C_out], adding the float32 ``prev``
    (out's layout) where given; ``acc`` is a float32 array of out's layout
    for the partial sums between mode chunks."""
    b, sx, sy, ci = x.shape
    co = out.shape[3]
    n, lines = (sy, sx) if axis == 2 else (sx, sy)
    # Line and element strides along the axis, in x and in out.
    strides = lambda c: (sy * c, c) if axis == 2 else (c, sy * c)
    modes = w.shape[2]
    fwd, inv = (_adjoint_bases if adjoint else stacked_bases)(n, modes, x.device)
    s_i, s_o, s_m, s_p = w.stride()
    if adjoint:  # read W[o, i] where the kernel reads W[i, o]
        s_i, s_o = s_o, s_i
    err = lib.spectral_axis(
        _DTYPE_CODE[x.dtype], _DTYPE_CODE[w.dtype], _DTYPE_CODE[out.dtype], x.data_ptr(),
        fwd.data_ptr(), inv.data_ptr(), w.data_ptr(), s_i, s_o, s_m, s_p, int(adjoint),
        None if prev is None else prev.data_ptr(), acc.data_ptr(), out.data_ptr(), b * lines,
        lines, sx * sy * ci, *strides(ci), sx * sy * co, *strides(co), n, modes, ci, co, stream)
    _cuda.check(lib, err, what + (" adjoint" if adjoint else ""))


def _launch(x: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor, adjoint: bool) -> torch.Tensor:
    """Both axis launches of the kernel on x, on the operator or its adjoint."""
    co = _check_args(x, wy, wx, adjoint)
    lib = _lib()
    wy, wx = _stageable(wy), _stageable(wx)
    out = x.new_empty(*x.shape[:3], co)
    first = out if x.dtype == torch.float32 else out.new_empty(out.shape, dtype=torch.float32)
    stream = _cuda.stream_ptr(x.device)
    with torch.cuda.device(x.device):
        # The Y branch writes, the X branch adds.
        _launch_axis(lib, x, wy, 2, adjoint, None, first, first, stream, "fused_mix_2d")
        _launch_axis(lib, x, wx, 1, adjoint, first, first, out, stream, "fused_mix_2d")
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
    return x.new_empty(*x.shape[:3], wy.shape[1])


def _mix_adjoint_meta(g: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    return g.new_empty(*g.shape[:3], wy.shape[0])


_MIX_SCHEMA = "(Tensor x, Tensor wy, Tensor wx) -> Tensor"
_MIX_OP = _cuda.register_op(LIBRARY, "fused_mix_2d", _MIX_SCHEMA, fused_mix_2d_plain,
                            fused_mix_2d_cuda, _mix_meta)
_MIX_ADJOINT_OP = _cuda.register_op(LIBRARY, "fused_mix_2d_adjoint", _MIX_SCHEMA,
                                    fused_mix_2d_adjoint_plain, fused_mix_2d_adjoint_cuda,
                                    _mix_adjoint_meta)


# --- one axis ------------------------------------------------------------------------------------
def fused_mix_axis_plain(x: torch.Tensor, w: torch.Tensor, axis: int) -> torch.Tensor:
    """The plain version of one branch along ``axis`` (1: X, 2: Y), rounding
    as :func:`fused_mix_2d_plain`'s branches do, returned in float32."""
    return mix_axis_f32(x, w, axis, round_to=x.dtype)


def fused_mix_axis_adjoint_plain(g: torch.Tensor, w: torch.Tensor, axis: int) -> torch.Tensor:
    """The adjoint of :func:`fused_mix_axis_plain` applied to ``g``, in float32."""
    return mix_axis_f32(g, w, axis, adjoint=True, round_to=g.dtype)


def _launch_one(x: torch.Tensor, w: torch.Tensor, axis: int, adjoint: bool) -> torch.Tensor:
    """One launch of the kernel along ``axis`` into a new float32 array."""
    if axis not in (1, 2):
        raise ValueError(f"fused_mix_axis takes axis 1 (X) or 2 (Y), got {axis}")
    what = "fused_mix_axis"
    co = _check(x, (("w", w, axis),), adjoint, what)
    lib = _lib()
    out = x.new_empty(*x.shape[:3], co, dtype=torch.float32)
    with torch.cuda.device(x.device):
        _launch_axis(lib, x, _stageable(w), axis, adjoint, None, out, out,
                     _cuda.stream_ptr(x.device), what)
    return out


def fused_mix_axis_cuda(x: torch.Tensor, w: torch.Tensor, axis: int) -> torch.Tensor:
    """Launch the CUDA kernel once along ``axis``. Raises on anything the
    kernel does not take."""
    out = _launch_one(x, w, axis, adjoint=False)
    fused_mix_axis.launches += 1
    return out


def fused_mix_axis_adjoint_cuda(g: torch.Tensor, w: torch.Tensor, axis: int) -> torch.Tensor:
    """Launch the CUDA kernel once along ``axis`` on the adjoint operator."""
    out = _launch_one(g, w, axis, adjoint=True)
    fused_mix_axis_adjoint.launches += 1
    return out


_AXIS_SCHEMA = "(Tensor x, Tensor w, int axis) -> Tensor"
_AXIS_OP = _cuda.register_op(
    LIBRARY, "fused_mix_axis", _AXIS_SCHEMA, fused_mix_axis_plain, fused_mix_axis_cuda,
    lambda x, w, axis: x.new_empty(*x.shape[:3], w.shape[1], dtype=torch.float32))
_AXIS_ADJOINT_OP = _cuda.register_op(
    LIBRARY, "fused_mix_axis_adjoint", _AXIS_SCHEMA, fused_mix_axis_adjoint_plain,
    fused_mix_axis_adjoint_cuda,
    lambda g, w, axis: g.new_empty(*g.shape[:3], w.shape[0], dtype=torch.float32))


def fused_mix_axis(x: torch.Tensor, w: torch.Tensor, axis: int) -> torch.Tensor:
    """One separable spectral branch: ``x [B, X, Y, C_in]`` mixed along
    ``axis`` (1: X, 2: Y) by ``w [C_in, C_out, M, 2]`` into a float32
    ``[B, X, Y, C_out]`` (the branch before it is rounded to x's type: two
    branches summed in float32 and rounded once give :func:`fused_mix_2d`),
    on the device of ``x``. Not differentiable by itself: the spatially
    split mix (``models/ffno_grid_2d.py``) is the Function around it."""
    _cuda.check_device(x, "fused_mix_axis")
    return _AXIS_OP(x, w, axis)


def fused_mix_axis_adjoint(g: torch.Tensor, w: torch.Tensor, axis: int) -> torch.Tensor:
    """The gradient of :func:`fused_mix_axis` with respect to x given the
    output gradient ``g`` (in x's type), in float32, on the device of ``g``."""
    _cuda.check_device(g, "fused_mix_axis_adjoint")
    return _AXIS_ADJOINT_OP(g, w, axis)


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
    """Both separable spectral branches: ``[B, X, Y, C_in] -> [B, X, Y,
    C_out]``. ``wy`` mixes along Y (axis 2), ``wx`` along X (axis 1); both
    ``[C_in, C_out, M, 2]`` (C_out = C_in in the model, C_in / tp for a
    column shard). Differentiable in every argument."""
    return _FusedMix2d.apply(x, wy, wx)


fused_mix_2d.launches = 0
fused_mix_2d_adjoint.launches = 0
fused_mix_axis.launches = 0
fused_mix_axis_adjoint.launches = 0
