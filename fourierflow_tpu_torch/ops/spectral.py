"""Plain PyTorch spectral ops (counterpart of ``fourierflow_tpu/ops/spectral.py``).

``spectral_mix_axis`` is one separable F-FNO branch: truncated orthonormal
rDFT along one spatial axis, per-mode complex channel mixing, inverse rDFT.
It is computed with the truncated-DFT basis matmuls of ``ops/dft.py`` in
float32 (inputs of another type are rounded to it first and the result is
cast back), which makes it the oracle for the fused CUDA kernel in
``ops/fused_spectral.py``. Layout is channels-last ``[batch, *spatial, C]``.
"""

import functools
import math

import torch

from .dft import irdft_basis, rdft_basis

__all__ = ["spectral_mix_axis", "mix_axis_f32", "mix_axis_wgrad", "dft_bases", "stacked_bases"]


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


def _spatial_axis(x: torch.Tensor, axis: int) -> int:
    axis = axis % x.ndim
    if axis == x.ndim - 1:
        raise ValueError("last dim is channels; pick a spatial axis")
    return axis


def mix_axis_f32(x: torch.Tensor, weight: torch.Tensor, axis: int,
                 adjoint: bool = False) -> torch.Tensor:
    """:func:`spectral_mix_axis` before its result is rounded to x's type.

    With ``adjoint`` it applies the adjoint operator instead (the gradient
    with respect to x of ``sum(g * mix_axis_f32(x, weight, axis))`` at
    ``x = g``): the two bases swap places transposed, and the weights are
    (i, o)-transposed and conjugated, as the CUDA kernel's adjoint launch
    does."""
    axis = _spatial_axis(x, axis)
    n, modes = x.shape[axis], weight.shape[2]
    er, ei, cr, ci = dft_bases(n, modes, x.device)
    xm = x.movedim(axis, -2).float()                      # [..., n, Ci]
    w = weight.to(x.dtype).float()
    wr, wi = w[..., 0], w[..., 1]                         # [Ci, Co, M]
    if adjoint:
        er, ei, cr, ci = cr.t(), ci.t(), er.t(), ei.t()
        wr, wi = wr.transpose(0, 1), -wi.transpose(0, 1)
    sr = torch.einsum("...nc,nm->...mc", xm, er)
    si = torch.einsum("...nc,nm->...mc", xm, ei)
    yr = torch.einsum("...mi,iom->...mo", sr, wr) - torch.einsum("...mi,iom->...mo", si, wi)
    yi = torch.einsum("...mi,iom->...mo", sr, wi) + torch.einsum("...mi,iom->...mo", si, wr)
    out = torch.einsum("...mo,mn->...no", yr, cr) + torch.einsum("...mo,mn->...no", yi, ci)
    return out.movedim(-2, axis)


def mix_axis_wgrad(x: torch.Tensor, g: torch.Tensor, modes: int, axis: int) -> torch.Tensor:
    """Gradient of ``sum(g * mix_axis_f32(x, weight, axis))`` with respect to
    the ``[Ci, Co, M, 2]`` weight, in float32: the forward spectra of x
    against the inverse-basis spectra of g, summed over every other axis
    (``_spectra``/``wgrad`` of ``fourierflow_tpu/ops/pallas_spectral.py``)."""
    axis = _spatial_axis(x, axis)
    n = x.shape[axis]
    fwd, inv = stacked_bases(n, modes, x.device)

    def spectra(t, basis):  # [M, N, 2C]: (real | imaginary) channels; N is every other axis
        lead, c = math.prod(t.shape[:axis]), t.shape[-1]
        s = basis @ t.float().reshape(lead, n, -1)          # [lead, 2M, rest * C], no copy of t
        s = s.reshape(lead, 2, modes, -1, c).permute(2, 0, 3, 1, 4)
        return s.reshape(modes, -1, 2 * c)

    # One product per mode gives all four real blocks [[sr'hr, sr'hi], [si'hr, si'hi]].
    ci, co = x.shape[-1], g.shape[-1]
    u = spectra(x, fwd.t()).mT @ spectra(g, inv)            # [M, 2Ci, 2Co]
    rr, ri, ir, ii = u[:, :ci, :co], u[:, :ci, co:], u[:, ci:, :co], u[:, ci:, co:]
    return torch.stack([rr + ii, ri - ir], dim=-1).permute(1, 2, 0, 3)
