"""Factorized Cosine Neural Operator on structured 2D meshes, the FCNO
ablation of the airfoil model (counterpart of
``fourierflow_tpu/models/cno_mesh_2d.py``).

The F-FNO mesh model (``models/ffno_mesh_2d.py``: grid channels,
``in_proj``, padding on the high side, the head on the unpadded last
backcast, parameter names) with the separable DCT mix
(``ops.spectral.dct_mix_axis``, plain torch as in the JAX package; real
weights ``[width, width, modes]``) in place of the spectral one; the
feed-forwards run ``ops.fused_ff`` (the CUDA kernel on a CUDA tensor).
"""

import torch

from ..ops.spectral import dct_mix_axis
from .ffno_mesh_2d import FNOFactorizedMesh2D

__all__ = ["CNOFactorizedMesh2D"]


class CNOFactorizedMesh2D(FNOFactorizedMesh2D):
    _pair = ()

    @staticmethod
    def _mix(x: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor) -> torch.Tensor:
        return dct_mix_axis(x, wy, 2) + dct_mix_axis(x, wx, 1)
