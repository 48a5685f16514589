"""Fused two-layer feed-forward (counterpart of ``fourierflow_tpu/ops/pallas_ff.py``).

``fused_ff(x, w1, b1, w2, b2) == relu(x @ w1 + b1) @ w2 + b2`` over
``x: [..., C_in]`` with dense weights in the JAX package's layout
(``w1: [C_in, H]``, ``w2: [H, C_out]``); weight norm is folded in by the
caller (``layers.FeedForward``). It is a ``torch.autograd.Function``: the
forward and the backward each run on the device of ``x``.

On a CPU tensor the forward runs :func:`fused_ff_plain` and the backward
:func:`fused_ff_bwd_plain`. On a CUDA tensor they launch the hand-written
kernels of ``csrc/fused_ff.cu`` (``ff_fwd`` replaces the TPU kernel
``pallas_ff.py::_ff_kernel``, ``ff_bwd`` replaces ``_make_bwd_kernel``) or
raise; they never fall back. The kernels read ``w1`` and ``w2`` through
their strides, so a transposed view of torch's ``[out, in]`` weight goes in
without a copy. ``fused_ff.launches`` and ``fused_ff_bwd.launches`` count
calls that reached a kernel.

Bounds (H100 SXM data sheet, flagship rows 77,824, C 64, H 256): forward
5.10 GFLOP and 39.8 MB f32 (19.9 MB bf16), about 76 us in f32 on CUDA cores
(operations) and 6 us in bf16 (memory); backward 12.75 GFLOP and 59.8 MB
f32, about 190 us in f32 (operations) and 13 us in bf16 (operations). The
kernel sources describe the tiling.

Rounding: the plain versions, and so the kernels, keep the hidden layer
``h`` and its gradient ``dh`` in float32 and round only the outputs (``out``
and ``dx``) to x's type; weight and bias gradients come out in float32 and
are cast to the parameter's type. The JAX kernels round ``h`` and ``dh`` to
x's type before the second products, so in bf16 the two packages differ
by that rounding.
"""

import ctypes
import functools

import torch

from . import _cuda

__all__ = ["fused_ff", "fused_ff_plain", "fused_ff_cuda", "fused_ff_bwd", "fused_ff_bwd_plain",
           "fused_ff_bwd_cuda"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_COUT = 64  # output columns per block row: 4 per thread x 16 threads
_MAX_BWD_C = 64  # the backward kernel stages x, g and dx tiles 64 columns wide
_TILE_ROWS = 64  # rows per tile of the backward kernel


def fused_ff_plain(x, w1, b1, w2, b2):
    """The plain PyTorch version, in float32 (other input types are rounded
    to float32 first and the result is cast back to x's type)."""
    f = lambda t: t.float()
    h = torch.relu(f(x) @ f(w1) + f(b1))
    return (h @ f(w2) + f(b2)).to(x.dtype)


def fused_ff_bwd_plain(x, g, w1, b1, w2):
    """Gradients of :func:`fused_ff_plain` given the output gradient ``g``,
    in float32 from inputs rounded to float32: ``(dx, dw1, db1, dw2, db2)``,
    ``dx`` in x's type and shape, the rest float32 in the parameters' shapes
    (``_ff_bwd`` of the JAX package)."""
    cin, cout = x.shape[-1], g.shape[-1]
    xf, gf = x.reshape(-1, cin).float(), g.reshape(-1, cout).float()
    w1f, w2f = w1.float(), w2.float()
    pre = xf @ w1f + b1.float()
    dh = (gf @ w2f.t()) * (pre > 0)
    dx = (dh @ w1f.t()).to(x.dtype).reshape(x.shape)
    return dx, xf.t() @ dh, dh.sum(0), torch.relu(pre).t() @ gf, gf.sum(0)


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _cuda.load("fused_ff")
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ff_fwd.argtypes = [i, vp, vp, vp, vp, vp, vp, i, i, i, i, i, i, i, i, vp]
    lib.ff_fwd.restype = i
    lib.ff_fwd_smem_bytes.argtypes = [i, i]
    lib.ff_fwd_smem_bytes.restype = ll
    lib.ff_bwd.argtypes = [i, vp, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i, i, i, i, i, vp]
    lib.ff_bwd.restype = i
    lib.ff_bwd_smem_bytes.argtypes = [i, i, i]
    lib.ff_bwd_smem_bytes.restype = ll
    return lib


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
    if cout > _MAX_COUT:
        raise ValueError(f"fused_ff kernel takes C_out <= {_MAX_COUT}, got {cout}")
    if g is not None and cin > _MAX_BWD_C:
        raise ValueError(f"fused_ff backward kernel takes C_in <= {_MAX_BWD_C}, got {cin}")
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
    need = lib.ff_bwd_smem_bytes(cin, hidden, cout)
    if need > _cuda.MAX_SMEM:
        raise ValueError(f"fused_ff backward: C_in={cin}, H={hidden}, C_out={cout} needs "
                         f"{need} B of shared memory")
    blocks = min(-(-rows // _TILE_ROWS), _sm_count(x.device.index))
    partial = torch.empty(blocks, n, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.ff_bwd(_DTYPE_CODE[x.dtype], x.data_ptr(), g.data_ptr(), w1.data_ptr(),
                         b1.data_ptr(), w2.data_ptr(), dx.data_ptr(), partial.data_ptr(),
                         out.data_ptr(), rows, cin, hidden, cout, *w1.stride(), *w2.stride(),
                         blocks, _cuda.stream_ptr(x.device))
    _cuda.check(lib, err, "fused_ff backward")
    fused_ff_bwd.launches += 1
    return grads


def fused_ff_bwd(x, g, w1, b1, w2):
    """``(dx, dw1, db1, dw2, db2)`` of :func:`fused_ff` given the output
    gradient ``g``, on the device of ``x``."""
    kernel = _cuda.dispatch(x, fused_ff_bwd_plain, fused_ff_bwd_cuda, "fused_ff_bwd")
    return kernel(x, g, w1, b1, w2)


class _FusedFF(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2)
        ctx.b2_dtype = b2.dtype
        return _cuda.dispatch(x, fused_ff_plain, fused_ff_cuda, "fused_ff")(x, w1, b1, w2, b2)

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
