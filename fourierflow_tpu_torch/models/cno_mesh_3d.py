"""Factorized Cosine Neural Operator on structured 3D meshes, the FCNO
ablation of the plasticity model (counterpart of
``fourierflow_tpu/models/cno_mesh_3d.py``).

The F-FNO 3D mesh model (``models/ffno_mesh_3d.py``) with its three
separable branches (x, y, z) the DCT mix (``ops.spectral.dct_mix_axis``;
real weights ``[width, width, modes]``); the feed-forwards run
``ops.fused_ff`` (the CUDA kernel on a CUDA tensor). On a ``data x model``
mesh the DCT weights (rank 3, which JAX's ``_tp_spec`` leaves whole) run
whole on every rank and the feed-forwards take their hidden slices.
"""

from ..ops.spectral import dct_mix_axis
from .ffno_mesh_3d import FNOFactorizedMesh3D

__all__ = ["CNOFactorizedMesh3D"]


class CNOFactorizedMesh3D(FNOFactorizedMesh3D):
    _pair = ()
    _mix_axis = staticmethod(dct_mix_axis)

    def __init__(self, modes_x: int, modes_y: int, modes_z: int, width: int, input_dim: int,
                 output_dim: int, n_layers: int, share_weight: bool = False, factor: int = 4,
                 ff_weight_norm: bool = True, n_ff_layers: int = 2, layer_norm: bool = False,
                 padding: int = 8):
        super().__init__(modes_x, modes_y, modes_z, width, input_dim, output_dim, n_layers,
                         share_weight, factor, ff_weight_norm, n_ff_layers, layer_norm, padding)
