"""Fused two-layer feed-forward (counterpart of ``fourierflow_tpu/ops/pallas_ff.py``).

``fused_ff(x, w1, b1, w2, b2) == relu(x @ w1 + b1) @ w2 + b2`` over
``x: [..., C_in]`` with dense weights in the JAX package's layout
(``w1: [C_in, H]``, ``w2: [H, C_out]``); weight norm is folded in by the
caller (``layers.FeedForward``). It is a ``torch.autograd.Function``: the
forward and the backward each run on the device of ``x``.

Forward and backward are the operators ``torch.ops.fourierflow_tpu_torch.
fused_ff`` and ``fused_ff_bwd``. On a CPU tensor they run
:func:`fused_ff_plain` and :func:`fused_ff_bwd_plain`. On a CUDA tensor they
launch the hand-written kernels of ``csrc/fused_ff.cu`` (``ff_fwd`` replaces
the TPU kernel ``pallas_ff.py::_ff_kernel``, ``ff_bwd`` replaces
``_make_bwd_kernel``) or raise; they never fall back. Their Meta
implementations give shapes only, so ``torch.export`` keeps each forward
call as one node that launches ``ff_fwd`` when the program runs on the
card. The kernels read ``w1`` and ``w2`` through
their strides, so a transposed view of torch's ``[out, in]`` weight goes in
without a copy. ``fused_ff.launches`` and ``fused_ff_bwd.launches`` count
calls that reached a kernel.

Bounds (H100 SXM data sheet, flagship rows 77,824, C 64, H 256), the least
time for the work at f32 accuracy (3xTF32 on tensor cores, 495/3 TFLOP/s)
or in bf16 (989 TFLOP/s), against 3.35 TB/s: forward 5.10 GFLOP and 39.8
MB f32 (19.9 MB bf16), about 31 us in f32 (operations) and 6 us in bf16
(memory); backward 12.75 GFLOP and 59.8 MB f32, about 77 us in f32 and 13
us in bf16 (operations). The kernel sources describe the tiling. Both
kernels take H in multiples of 16, down to the flagship's (32) and
elasticity's (16) hidden slices at tensor parallelism 8; both stage H
rounded up to its 64-wide chunks, the columns past H as zeros.

Both kernels run their products on tensor cores (``mma.sync``: bf16 with
float32 sums, and in float32 three TF32 products per product, which keeps
float32 accuracy). Rounding, as in the JAX kernels: products and sums run
in float32, and the hidden layer ``h`` and its gradient ``dh`` are rounded
to x's type before any product or sum uses them (in bf16 both kernels feed
them to the tensor cores in bf16). ``out`` and ``dx`` come out in x's type;
weight and bias gradients come out in float32 and the Function casts them
to the parameters' type. In float32 no rounding happens.
"""

import ctypes
import functools

import torch

from . import LIBRARY, _cuda

__all__ = ["fused_ff", "fused_ff_plain", "fused_ff_cuda", "fused_ff_bwd", "fused_ff_bwd_plain",
           "fused_ff_bwd_cuda"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_C = 64  # C_in and C_out bound of both kernels (register fragments, 64-wide tiles)
_FWD_PAD, _FWD_HC = 8, 64  # as PAD and HC in csrc/fused_ff.cu
_H_STEP = 16  # both kernels take H in multiples of this (H_STEP in the source)
# Warps of a forward block and rows of a warp tile (FwdShape<T> in the source).
_FWD_SHAPE = {torch.float32: (8, 16), torch.bfloat16: (8, 32)}
_BWD_TILE = 64  # rows per tile, hidden chunk and C bound of the backward kernel (BT in the source)


def _wide(dtype: torch.dtype) -> torch.dtype:
    """The type the plain versions compute in: float32, or float64 for a
    float64 input (a reference copy)."""
    return torch.promote_types(dtype, torch.float32)


def fused_ff_plain(x, w1, b1, w2, b2):
    """The plain PyTorch version: products and sums in float32 (float64 for
    a float64 x), the hidden layer rounded to x's type before the second
    product, the result cast to x's type. The weights are copied contiguous
    first: on some CPUs the BLAS takes another path (and sums in another
    order) for a transposed view, and the result must not depend on the
    weights' layout."""
    f = lambda t: t.to(_wide(x.dtype)).contiguous()
    h = torch.relu(f(x) @ f(w1) + f(b1)).to(x.dtype)
    return (f(h) @ f(w2) + f(b2)).to(x.dtype)


def fused_ff_bwd_plain(x, g, w1, b1, w2):
    """Gradients of :func:`fused_ff_plain` given the output gradient ``g``:
    ``(dx, dw1, db1, dw2, db2)``, ``dx`` in x's type and shape, the rest
    float32 in the parameters' shapes (``_ff_bwd`` of the JAX package).
    Products and sums run in float32; ``h`` and ``dh`` are rounded to x's
    type before they enter any of them. The weights are copied contiguous
    first, as in :func:`fused_ff_plain`."""
    cin, cout, wide = x.shape[-1], g.shape[-1], _wide(x.dtype)
    xf, gf = x.reshape(-1, cin).to(wide), g.reshape(-1, cout).to(wide)
    w1f, w2f = w1.to(wide).contiguous(), w2.to(wide).contiguous()
    rnd = lambda t: t.to(x.dtype).to(wide)
    pre = xf @ w1f + b1.to(wide)
    h = rnd(torch.relu(pre))
    dh = rnd((gf @ w2f.t()) * (pre > 0))
    dx = (dh @ w1f.t()).to(x.dtype).reshape(x.shape)
    return dx, xf.t() @ dh, dh.sum(0), h.t() @ gf, gf.sum(0)


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _cuda.load("fused_ff")
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ff_fwd.argtypes = [i, vp, vp, vp, vp, vp, vp, i, i, i, i, i, i, i, i, vp]
    lib.ff_fwd.restype = i
    lib.ff_fwd_smem_bytes.argtypes = [i, i, i]
    lib.ff_fwd_smem_bytes.restype = ll
    lib.ff_bwd.argtypes = [i, vp, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i, i, i, i, i, vp]
    lib.ff_bwd.restype = i
    lib.ff_bwd_smem_bytes.argtypes = [i, i]
    lib.ff_bwd_smem_bytes.restype = ll
    return lib


def _fwd_smem_bytes(hidden, cout, dtype):
    """Shared memory of one forward block (``fwd_smem_bytes`` in the source):
    a tile of x per warp, all of W1 and W2 zero-padded to C_in = C_out = 64
    and H to a multiple of 64 (whole hidden chunks) with padded rows, both
    biases."""
    warps, warp_rows = _FWD_SHAPE[dtype]
    hp = -(-hidden // _FWD_HC) * _FWD_HC
    elems = (warps * warp_rows * (_MAX_C + _FWD_PAD) + hp * (_MAX_C + _FWD_PAD)
             + _MAX_C * (hp + _FWD_PAD))
    return elems * (torch.finfo(dtype).bits // 8) + 4 * (hp + cout)


def _bwd_smem_bytes(hidden, dtype):
    """Shared memory of one backward block (``bwd_smem_bytes`` in the source):
    six staged 64x64 tiles in x's type (bf16 rows padded to 72 elements),
    the float32 sums of every 64-wide chunk of H (dW1 and dW2 64 x 64 each,
    db1) and db2, and b1 in float32 (padded to whole chunks)."""
    chunks = -(-hidden // _BWD_TILE)
    ld = _BWD_TILE if dtype == torch.float32 else _BWD_TILE + 8
    sums = 2 * chunks * _BWD_TILE ** 2 + chunks * _BWD_TILE + _BWD_TILE
    tiles = 6 * _BWD_TILE * ld * (torch.finfo(dtype).bits // 8)
    return tiles + 4 * (sums + chunks * _BWD_TILE)


def _check_args(x, w1, b1, w2, b2=None, g=None):
    """What the kernels take. ``b2`` is checked for the forward, ``g`` (the
    output gradient) for the backward."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_ff kernel takes float32 or bfloat16, got {x.dtype}")
    cin, hidden, cout = x.shape[-1], w1.shape[-1], w2.shape[-1]
    shapes = {"w1": (w1, (cin, hidden)), "b1": (b1, (hidden,)), "w2": (w2, (hidden, cout))}
    if b2 is not None:
        shapes["b2"] = (b2, (cout,))
    if g is not None:
        shapes["g"] = (g, (*x.shape[:-1], cout))
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_ff: {name} is {tuple(t.shape)}, expected {shape}")
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"fused_ff: {name} is {t.dtype} on {t.device}, x is {x.dtype} on {x.device}")
    for name, t in (("x", x), ("b1", b1), ("b2", b2), ("g", g)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"fused_ff kernel needs a contiguous {name}")
    if cout > _MAX_C:
        raise ValueError(f"fused_ff kernel takes C_out <= {_MAX_C}, got {cout}")
    if hidden % _H_STEP:
        raise ValueError(f"fused_ff kernel takes H a multiple of {_H_STEP}, got {hidden}")
    if g is not None:
        if cin > _MAX_C:
            raise ValueError(f"fused_ff backward kernel takes C_in <= {_MAX_C}, got {cin}")
        need = _bwd_smem_bytes(hidden, x.dtype)
        if need > _cuda.MAX_SMEM:
            raise ValueError(f"fused_ff backward: H={hidden} needs {need} B of shared memory in "
                             f"{x.dtype}, more than {_cuda.MAX_SMEM}")
    if b2 is not None:
        if cin > _MAX_C or cin % 16:
            raise ValueError(f"fused_ff kernel takes C_in a multiple of 16 and <= {_MAX_C}, "
                             f"got {cin}")
        if cout % 8:
            raise ValueError(f"fused_ff kernel takes C_out a multiple of 8, got {cout}")
        if x.data_ptr() % 16:
            raise ValueError("fused_ff kernel needs x aligned to 16 bytes")
        need = _fwd_smem_bytes(hidden, cout, x.dtype)
        if need > _cuda.MAX_SMEM:
            raise ValueError(f"fused_ff: C_in={cin}, H={hidden}, C_out={cout} needs {need} B of "
                             f"shared memory, more than {_cuda.MAX_SMEM}")
    for name, t in (("w1", w1), ("w2", w2)):
        if sum((n - 1) * abs(st) for n, st in zip(t.shape, t.stride())) >= 2 ** 31:
            raise ValueError(f"fused_ff kernel indexes {name} with int offsets; it spans too far")


def fused_ff_cuda(x, w1, b1, w2, b2):
    """Launch the forward kernel. Raises on anything the kernel does not take."""
    _check_args(x, w1, b1, w2, b2)
    cin, hidden, cout = x.shape[-1], w1.shape[-1], w2.shape[-1]
    rows = x.numel() // cin
    out = torch.empty(*x.shape[:-1], cout, dtype=x.dtype, device=x.device)
    if rows == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.ff_fwd(_DTYPE_CODE[x.dtype], x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                         w2.data_ptr(), b2.data_ptr(), out.data_ptr(), rows, cin, hidden, cout,
                         *w1.stride(), *w2.stride(), _cuda.stream_ptr(x.device))
    _cuda.check(lib, err, "fused_ff")
    fused_ff.launches += 1
    return out


def _fused_ff_meta(x, w1, b1, w2, b2):
    return x.new_empty(*x.shape[:-1], w2.shape[-1])


@functools.lru_cache(maxsize=16)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def fused_ff_bwd_cuda(x, g, w1, b1, w2):
    """Launch the backward kernel (its main pass and its reduction pass).
    Returns what :func:`fused_ff_bwd_plain` returns. With no rows it returns
    zero weight gradients and an empty dx without a launch."""
    _check_args(x, w1, b1, w2, g=g)
    cin, hidden, cout = x.shape[-1], w1.shape[-1], w2.shape[-1]
    rows = x.numel() // cin
    dx = torch.empty_like(x)
    sizes = (cin * hidden, hidden, hidden * cout, cout)
    n = sum(sizes)
    out = (torch.empty if rows else torch.zeros)(n, dtype=torch.float32, device=x.device)
    dw1, db1, dw2, db2 = out.split(sizes)
    grads = (dx, dw1.view(cin, hidden), db1, dw2.view(hidden, cout), db2)
    if rows == 0:
        return grads
    lib = _lib()
    blocks = min(-(-rows // _BWD_TILE), _sm_count(x.device.index))
    partial = torch.empty(blocks, n, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.ff_bwd(_DTYPE_CODE[x.dtype], x.data_ptr(), g.data_ptr(), w1.data_ptr(),
                         b1.data_ptr(), w2.data_ptr(), dx.data_ptr(), partial.data_ptr(),
                         out.data_ptr(), rows, cin, hidden, cout, *w1.stride(), *w2.stride(),
                         blocks, _cuda.stream_ptr(x.device))
    _cuda.check(lib, err, "fused_ff backward")
    fused_ff_bwd.launches += 1
    return grads


def _fused_ff_bwd_meta(x, g, w1, b1, w2):
    f32 = lambda *shape: x.new_empty(shape, dtype=torch.float32)
    cin, hidden, cout = x.shape[-1], w1.shape[-1], w2.shape[-1]
    return torch.empty_like(x), f32(cin, hidden), f32(hidden), f32(hidden, cout), f32(cout)


_FF_OP = _cuda.register_op(
    LIBRARY, "fused_ff", "(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2) -> Tensor",
    fused_ff_plain, fused_ff_cuda, _fused_ff_meta)
_FF_BWD_OP = _cuda.register_op(
    LIBRARY, "fused_ff_bwd",
    "(Tensor x, Tensor g, Tensor w1, Tensor b1, Tensor w2) "
    "-> (Tensor, Tensor, Tensor, Tensor, Tensor)",
    fused_ff_bwd_plain, fused_ff_bwd_cuda, _fused_ff_bwd_meta)


def fused_ff_bwd(x, g, w1, b1, w2):
    """``(dx, dw1, db1, dw2, db2)`` of :func:`fused_ff` given the output
    gradient ``g``, on the device of ``x``."""
    _cuda.check_device(x, "fused_ff_bwd")
    return _FF_BWD_OP(x, g, w1, b1, w2)


class _FusedFF(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        _cuda.check_device(x, "fused_ff")
        ctx.save_for_backward(x, w1, b1, w2)
        ctx.b2_dtype = b2.dtype
        return _FF_OP(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w2 = ctx.saved_tensors
        dx, dw1, db1, dw2, db2 = fused_ff_bwd(x, g.contiguous(), w1, b1, w2)
        return dx, dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype), db2.to(ctx.b2_dtype)


def fused_ff(x, w1, b1, w2, b2):
    """``relu(x @ w1 + b1) @ w2 + b2`` with the hidden layer kept on chip,
    differentiable in every argument."""
    return _FusedFF.apply(x, w1, b1, w2, b2)


fused_ff.launches = 0
fused_ff_bwd.launches = 0
