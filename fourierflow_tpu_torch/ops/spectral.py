"""Plain PyTorch spectral ops (counterpart of ``fourierflow_tpu/ops/spectral.py``).

``spectral_mix_axis`` is one separable F-FNO branch: truncated orthonormal
rDFT along one spatial axis, per-mode complex channel mixing, inverse rDFT.
It is computed with the truncated-DFT basis matmuls of ``ops/dft.py`` in
float32 (inputs of another type are rounded to it first and the result is
cast back), which makes it the oracle for the fused CUDA kernel in
``ops/fused_spectral.py``. Layout is channels-last ``[batch, *spatial, C]``.
"""

import functools

import torch

from .dft import irdft_basis, rdft_basis

__all__ = ["spectral_mix_axis", "mix_axis_f32", "dft_bases"]


@functools.lru_cache(maxsize=64)
def dft_bases(n: int, modes: int, device: torch.device):
    """``(er, ei, cr, ci)`` as float32 tensors on ``device`` (cached; do not
    modify): ``er/ei`` are ``[n, modes]``, ``cr/ci`` are ``[modes, n]``."""
    er, ei = rdft_basis(n, modes)
    cr, ci = irdft_basis(n, modes)
    return tuple(torch.tensor(a, device=device) for a in (er, ei, cr, ci))


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


def mix_axis_f32(x: torch.Tensor, weight: torch.Tensor, axis: int) -> torch.Tensor:
    """:func:`spectral_mix_axis` before its result is rounded to x's type."""
    axis = axis % x.ndim
    if axis == x.ndim - 1:
        raise ValueError("last dim is channels; pick a spatial axis")
    n, modes = x.shape[axis], weight.shape[2]
    er, ei, cr, ci = dft_bases(n, modes, x.device)
    xm = x.movedim(axis, -2).float()                      # [..., n, Ci]
    w = weight.to(x.dtype).float()
    wr, wi = w[..., 0], w[..., 1]                         # [Ci, Co, M]
    sr = torch.einsum("...nc,nm->...mc", xm, er)
    si = torch.einsum("...nc,nm->...mc", xm, ei)
    yr = torch.einsum("...mi,iom->...mo", sr, wr) - torch.einsum("...mi,iom->...mo", si, wi)
    yi = torch.einsum("...mi,iom->...mo", sr, wi) + torch.einsum("...mi,iom->...mo", si, wr)
    out = torch.einsum("...mo,mn->...no", yr, cr) + torch.einsum("...mo,mn->...no", yi, ci)
    return out.movedim(-2, axis)
