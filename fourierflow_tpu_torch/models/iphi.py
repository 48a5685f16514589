"""Learned coordinate deformation x -> xi of the Geo-FNO point clouds
(counterpart of ``fourierflow_tpu/models/iphi.py``).

Features of each point: x, y, the angle and the radius about ``(1e-4,
1e-4)`` (taken in float64 and rounded once, so that every device computes
the same bits; in float32 an ulp of them, which torch, XLA and CUDA do not
agree on, moves the top band's argument by up to ~6e-3 rad at width 64),
and sin/cos of each at ``width // 4`` bands ``pi * 2^k``; ``fc0``
of the four features joined with the sin/cos ones, then with a code (the
sample's geometry parameters) ``fc_code`` of it in front, or without one
``fc_no_code``; ``fc1``-``fc3`` with tanh, ``fc4`` to two channels, and
``x + x * h``. Every layer is a linear one without weight norm
(``layers.WNLinear``), initialised as torch's ``nn.Linear``.

A flax module makes ``fc_code`` or ``fc_no_code`` at its first call; here
``code_dim`` chooses at construction: a model built with ``code_dim`` (42,
the elasticity geometry's, by default) has ``fc_code`` and takes a code of
that width, one built with ``code_dim=None`` has ``fc_no_code`` and takes
none.
"""

import math
from typing import Optional

import torch
import torch.nn as nn

from ..layers import WNLinear

__all__ = ["IPhi"]


class IPhi(nn.Module):
    """``forward(x [batch, n_points, 2], code [batch, code_dim] or None)``
    returns ``[batch, n_points, 2]``."""

    def __init__(self, width: int = 32, code_dim: Optional[int] = 42):
        super().__init__()
        self.width, self.code_dim = width, code_dim
        self.fc0 = WNLinear(4, width)
        if code_dim is None:
            self.fc_no_code = WNLinear(3 * width, 4 * width)
        else:
            self.fc_code = WNLinear(code_dim, width)
        self.fc1 = WNLinear(4 * width, 4 * width)
        self.fc2 = WNLinear(4 * width, 4 * width)
        self.fc3 = WNLinear(4 * width, 4 * width)
        self.fc4 = WNLinear(4 * width, 2)
        self.reset_parameters(torch.Generator().manual_seed(0))

    def reset_parameters(self, generator=None) -> None:
        for lin in self.children():
            lin.reset_parameters(generator)

    def forward(self, x: torch.Tensor, code: Optional[torch.Tensor] = None) -> torch.Tensor:
        if (code is None) != (self.code_dim is None):
            raise ValueError(f"IPhi built with code_dim={self.code_dim} was called "
                             f"{'without' if code is None else 'with'} a code")
        # The angle and the radius in float64, rounded once: the bands scale an
        # ulp of them up to ~6e-3 rad, and float32 atan2 differs by an ulp
        # between devices (and between torch and XLA).
        xc = (x - 1e-4).double()
        angle = torch.atan2(xc[..., 1], xc[..., 0]).to(x.dtype)
        radius = torch.linalg.vector_norm(xc, dim=-1).to(x.dtype)
        xd = torch.stack([x[..., 0], x[..., 1], angle, radius], dim=-1)  # [b, n, 4]
        n_bands = self.width // 4
        bands = (math.pi * 2.0 ** torch.arange(n_bands, dtype=torch.float64, device=x.device))
        bands = bands.to(x.dtype)
        ang = (xd[..., None] * bands).flatten(-2)  # [b, n, 4 * bands]
        h = torch.cat([self.fc0(xd), torch.sin(ang), torch.cos(ang)], dim=-1)  # [b, n, 3w]
        if code is None:
            h = self.fc_no_code(h)
        else:
            cd = self.fc_code(code)[:, None, :].expand(-1, x.shape[1], -1)
            h = torch.cat([cd, h], dim=-1)
        h = torch.tanh(self.fc1(h))
        h = torch.tanh(self.fc2(h))
        h = torch.tanh(self.fc3(h))
        return x + x * self.fc4(h)
