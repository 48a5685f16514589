"""Plain PyTorch spectral ops (counterpart of ``fourierflow_tpu/ops/spectral.py``).

``spectral_conv_2d_full`` and ``spectral_conv_3d_full`` are the original
FNO's 2D and 3D spectral convolutions (``torch.fft`` and a complex product
on two or four corners of the modes).
``dct_mix_axis`` is one separable CNO branch: truncated orthonormal DCT-II
along one spatial axis, a real per-mode channel mix, the inverse DCT (plain
torch, as the JAX package computes it in XLA outside any Pallas kernel).
``spectral_mix_axis`` is one separable F-FNO branch: truncated orthonormal
rDFT along one spatial axis, per-mode complex channel mixing, inverse rDFT.
It is computed with the truncated-DFT basis matmuls of ``ops/dft.py`` in
float32 (inputs of another type are rounded to it first and the result is
cast back), which makes it the oracle for the fused CUDA kernel in
``ops/fused_spectral.py``. ``spectral_lowpass_axis`` is the same branch
without the mix (the low-pass ablation; ``torch.fft``, as the JAX package's
XLA computes it). Layout is channels-last ``[batch, *spatial, C]``.
"""

import functools
import math

import torch

from .dft import dct2_basis, idct2_basis, irdft_basis, rdft_basis
from ..parallel.collectives import gather_rows
from .fourier import irfft, irfftn

__all__ = ["dct_mix_axis", "dct_bases", "spectral_mix_axis", "spectral_lowpass_axis",
           "mix_axis_f32", "mix_axis_wgrad",
           "dft_bases", "stacked_bases",
           "spectral_conv_2d_full", "spectral_conv_3d_full"]


@functools.lru_cache(maxsize=64)
def dft_bases(n: int, modes: int, device: torch.device):
    """``(er, ei, cr, ci)`` as float32 tensors on ``device`` (cached; do not
    modify): ``er/ei`` are ``[n, modes]``, ``cr/ci`` are ``[modes, n]``."""
    er, ei = rdft_basis(n, modes)
    cr, ci = irdft_basis(n, modes)
    return tuple(torch.tensor(a, device=device) for a in (er, ei, cr, ci))


@functools.lru_cache(maxsize=64)
def stacked_bases(n: int, modes: int, device: torch.device):
    """The forward basis ``[n, 2M]`` (real | imaginary columns) and the
    inverse basis ``[2M, n]`` (real | imaginary rows), contiguous float32
    on ``device`` (cached; do not modify): the CUDA kernel's layout."""
    er, ei, cr, ci = dft_bases(n, modes, device)
    return torch.cat([er, ei], dim=1).contiguous(), torch.cat([cr, ci], dim=0).contiguous()


@functools.lru_cache(maxsize=64)
def dct_bases(n: int, modes: int, device: torch.device):
    """``(d [n, modes], di [modes, n])``, the truncated DCT-II and its
    inverse, as float32 tensors on ``device`` (cached; do not modify)."""
    return tuple(torch.tensor(a, device=device) for a in (dct2_basis(n, modes),
                                                         idct2_basis(n, modes)))


def dct_mix_axis(x: torch.Tensor, weight: torch.Tensor, axis: int) -> torch.Tensor:
    """DCT-II along ``axis``, per-mode real channel mixing, inverse DCT.

    Args:
      x: ``[batch, *spatial, in_channels]`` real.
      weight: ``[in, out, modes]`` real.
      axis: the spatial axis to transform.
    Returns:
      ``[batch, *spatial, out_channels]`` in x's type.
    """
    axis = _spatial_axis(x, axis)
    d, di = (t.to(x.dtype) for t in dct_bases(x.shape[axis], weight.shape[2], x.device))
    xs = torch.einsum("...ni,nm->...mi", x.movedim(axis, -2), d)
    ys = torch.einsum("...mi,iom->...mo", xs, weight.to(x.dtype))
    return torch.einsum("...mo,mn->...no", ys, di).movedim(-2, axis)


def spectral_mix_axis(x: torch.Tensor, weight: torch.Tensor, axis: int) -> torch.Tensor:
    """rfft along ``axis``, per-mode complex mixing, irfft back.

    Args:
      x: ``[batch, *spatial, in_channels]`` real.
      weight: ``[in, out, modes, 2]`` real/imaginary pairs; cast to x's type
        first (mixed precision follows the activations).
      axis: the spatial axis to transform.
    Returns:
      ``[batch, *spatial, out_channels]`` in x's type.
    """
    return mix_axis_f32(x, weight, axis).to(x.dtype)


def spectral_lowpass_axis(x: torch.Tensor, modes: int, axis: int) -> torch.Tensor:
    """The low-pass ablation's branch: the orthonormal rfft along ``axis``
    truncated to its first ``modes`` bins and transformed back, with no
    mixing. Computed in float32; returned in x's type."""
    axis = _spatial_axis(x, axis)
    n = x.shape[axis]
    xf = torch.fft.rfft(x.movedim(axis, -2).float(), dim=-2, norm="ortho")
    # irfft pads the truncated spectrum with zeros up to n // 2 + 1 bins.
    out = torch.fft.irfft(xf[..., :modes, :], n=n, dim=-2, norm="ortho")
    return out.movedim(-2, axis).to(x.dtype)


def _spatial_axis(x: torch.Tensor, axis: int) -> int:
    axis = axis % x.ndim
    if axis == x.ndim - 1:
        raise ValueError("last dim is channels; pick a spatial axis")
    return axis


def _rounder(dtype):
    """``t -> t`` rounded to ``dtype`` and back to float32, or None where
    that is a no-op (no dtype, float32 or float64)."""
    if dtype is None or dtype in (torch.float32, torch.float64):
        return None
    return lambda t: t.to(dtype).float()


def mix_axis_f32(x: torch.Tensor, weight: torch.Tensor, axis: int,
                 adjoint: bool = False, round_to: torch.dtype = None) -> torch.Tensor:
    """:func:`spectral_mix_axis` before its result is rounded to x's type.

    With ``adjoint`` it applies the adjoint operator instead (the gradient
    with respect to x of ``sum(g * mix_axis_f32(x, weight, axis))`` at
    ``x = g``): the two bases swap places transposed, and the weights are
    (i, o)-transposed and conjugated, as the CUDA kernel's adjoint launch
    does.

    With ``round_to`` (bf16) it rounds where the JAX kernel's ``_branch``
    does: the bases, the spectra after the forward product and the mixed
    spectra after the mix; the products and sums stay float32. A float64
    x is computed in float64 on the same (float32) bases: a reference copy."""
    axis = _spatial_axis(x, axis)
    n, modes = x.shape[axis], weight.shape[2]
    wide = torch.promote_types(x.dtype, torch.float32)
    er, ei, cr, ci = (b.to(wide) for b in dft_bases(n, modes, x.device))
    rnd = _rounder(round_to)
    if rnd:
        er, ei, cr, ci = map(rnd, (er, ei, cr, ci))
    xm = x.movedim(axis, -2).to(wide)                     # [..., n, Ci]
    w = weight.to(x.dtype).to(wide)
    wr, wi = w[..., 0], w[..., 1]                         # [Ci, Co, M]
    if adjoint:
        er, ei, cr, ci = cr.t(), ci.t(), er.t(), ei.t()
        wr, wi = wr.transpose(0, 1), -wi.transpose(0, 1)
    sr = torch.einsum("...nc,nm->...mc", xm, er)
    si = torch.einsum("...nc,nm->...mc", xm, ei)
    if rnd:
        sr, si = rnd(sr), rnd(si)
    yr = torch.einsum("...mi,iom->...mo", sr, wr) - torch.einsum("...mi,iom->...mo", si, wi)
    yi = torch.einsum("...mi,iom->...mo", sr, wi) + torch.einsum("...mi,iom->...mo", si, wr)
    if rnd:
        yr, yi = rnd(yr), rnd(yi)
    out = torch.einsum("...mo,mn->...no", yr, cr) + torch.einsum("...mo,mn->...no", yi, ci)
    return out.movedim(-2, axis)


def mix_axis_wgrad(x: torch.Tensor, g: torch.Tensor, modes: int, axis: int,
                   round_to: torch.dtype = None) -> torch.Tensor:
    """Gradient of ``sum(g * mix_axis_f32(x, weight, axis))`` with respect to
    the ``[Ci, Co, M, 2]`` weight, in float32: the forward spectra of x
    against the inverse-basis spectra of g, summed over every other axis
    (``_spectra``/``wgrad`` of ``fourierflow_tpu/ops/pallas_spectral.py``).

    With ``round_to`` (bf16) it rounds as that code's einsums in x's type
    do: g and the bases to ``round_to``, each spectrum and each of the four
    spectrum products once after its float32 sum, and the real and
    imaginary sums of two products once more."""
    axis = _spatial_axis(x, axis)
    n = x.shape[axis]
    wide = torch.promote_types(x.dtype, torch.float32)
    fwd, inv = (b.to(wide) for b in stacked_bases(n, modes, x.device))
    rnd = _rounder(round_to)
    if rnd:
        fwd, inv, g = rnd(fwd), rnd(inv), g.to(round_to)

    def spectra(t, basis):  # [M, N, 2C]: (real | imaginary) channels; N is every other axis
        lead, c = math.prod(t.shape[:axis]), t.shape[-1]
        s = basis @ t.to(wide).reshape(lead, n, -1)         # [lead, 2M, rest * C], no copy of t
        if rnd:
            s = rnd(s)
        s = s.reshape(lead, 2, modes, -1, c).permute(2, 0, 3, 1, 4)
        return s.reshape(modes, -1, 2 * c)

    # One product per mode gives all four real blocks [[sr'hr, sr'hi], [si'hr, si'hi]].
    ci, co = x.shape[-1], g.shape[-1]
    u = spectra(x, fwd.t()).mT @ spectra(g, inv)            # [M, 2Ci, 2Co]
    if rnd:
        u = rnd(u)
    rr, ri, ir, ii = u[:, :ci, :co], u[:, :ci, co:], u[:, ci:, :co], u[:, ci:, co:]
    dwr, dwi = rr + ii, ri - ir
    if rnd:
        dwr, dwi = rnd(dwr), rnd(dwi)
    return torch.stack([dwr, dwi], dim=-1).permute(1, 2, 0, 3)


def spectral_conv_2d_full(x: torch.Tensor, weight1: torch.Tensor, weight2: torch.Tensor, *,
                          norm: str = "backward", sp=None) -> torch.Tensor:
    """The original FNO's full 2D spectral convolution: the 2D real FFT of
    the grid, per-mode complex channel mixing on the two corner blocks of
    modes (the first and the last ``m1`` x frequencies, the first ``m2`` y
    frequencies; where they overlap the second block wins), the other modes
    zero, and the inverse transform.

    It runs one axis at a time, in the order that the grid split over X can
    follow: ``rfft`` along Y, truncated to the first ``m2`` bins; ``fft``
    along X; the mix; ``ifft`` along X; ``ops.fourier.irfft`` along Y (the
    imaginary parts of Y's self-conjugate bins zeroed). With the
    ``spatial`` axis ``sp`` (``parallel.collectives.Axis``), x is this
    rank's X rows ``[batch, sx/sp, sy, in]`` of the grid: the
    truncated spectrum is gathered over the axis (``gather_rows``: only
    ``m2 / (sy/2 + 1)`` of x's size crosses it), and the rows of the result
    that are this rank's are transformed back. Each rank's weight gradients
    are then its rows' part, and x's gradient is summed over the axis. On an
    axis of one rank the result and the gradients are those without one, to
    the bit.

    Args:
      x: ``[batch, sx, sy, in_channels]`` real (this rank's rows with ``sp``).
      weight1, weight2: ``[in, out, m1, m2, 2]`` real/imaginary pairs.
      norm: accepted as the JAX package accepts it; the forward and inverse
        scales cancel, so every normalisation gives the same result.
      sp: the ``spatial`` axis that splits X, or None.
    Returns:
      ``[batch, sx, sy, out_channels]`` (this rank's rows with ``sp``).
    """
    del norm
    sy = x.shape[2]
    m1, m2 = weight1.shape[2], weight1.shape[3]
    xf = torch.fft.rfft(x, dim=2)[:, :, :m2].contiguous()  # [b, rows, m2, in]
    if sp is not None:
        xf = gather_rows(xf, sp)
    b, sx = xf.shape[:2]
    xf = torch.fft.fft(xf, dim=1)
    cw = lambda w: torch.view_as_complex(w.contiguous())  # [in, out, m1, m2]
    top = torch.einsum("bxyi,ioxy->bxyo", xf[:, :m1], cw(weight1))
    bottom = torch.einsum("bxyi,ioxy->bxyo", xf[:, -m1:], cw(weight2))
    out = xf.new_zeros(b, sx, m2, weight1.shape[1])
    out[:, :m1] = top
    out[:, -m1:] = bottom
    out = torch.fft.ifft(out, dim=1)
    if sp is not None:
        rows = sx // sp.size
        out = out.narrow(1, sp.rank * rows, rows).contiguous()
    return irfft(out, sy, 2)


def spectral_conv_3d_full(x: torch.Tensor, weights, *, norm: str = "backward") -> torch.Tensor:
    """The Geo-FNO plasticity baseline's full 3D spectral convolution:
    ``rfftn`` over the three spatial axes, per-mode complex channel mixing
    on the four corner blocks of the (x, y) frequencies with the first
    ``m3`` z frequencies, the other modes zero, and the inverse
    ``ops.fourier.irfftn``. The corners are set in the order +x+y, -x+y,
    +x-y, -x-y; where blocks overlap the later one wins.

    Args:
      x: ``[batch, sx, sy, sz, in_channels]`` real.
      weights: four ``[in, out, m1, m2, m3, 2]`` real/imaginary pairs, in
        that corner order.
      norm: accepted as the JAX package accepts it; the scales cancel.
    Returns:
      ``[batch, sx, sy, sz, out_channels]``.
    """
    del norm
    b, sx, sy, sz, _ = x.shape
    m1, m2, m3 = weights[0].shape[2:5]
    xf = torch.fft.rfftn(x, dim=(1, 2, 3))  # [b, sx, sy, sz//2+1, in]
    out = xf.new_zeros(b, sx, sy, sz // 2 + 1, weights[0].shape[1])
    pos1, neg1, pos2, neg2 = slice(0, m1), slice(sx - m1, sx), slice(0, m2), slice(sy - m2, sy)
    for w, (s1, s2) in zip(weights, ((pos1, pos2), (neg1, pos2), (pos1, neg2), (neg1, neg2)),
                           strict=True):
        out[:, s1, s2, :m3] = torch.einsum("bxyzi,ioxyz->bxyzo", xf[:, s1, s2, :m3],
                                           torch.view_as_complex(w.contiguous()))
    return irfftn(out, (sx, sy, sz), dim=(1, 2, 3))
