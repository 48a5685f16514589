from .ffno_grid_2d import FNOFactorized2DBlock
from .ffno_mesh_2d import FNOFactorizedMesh2D
from .ffno_mesh_3d import FNOFactorizedMesh3D
from .zongyi_fno_2d import FNOZongyi2DBlock, ZongyiSpectralConv2d
from .zongyi_fno_plus_2d import FNOPlus2DBlock
from .zongyi_mesh_2d import FNOMesh2D
from .zongyi_mesh_3d import FNOMesh3D

__all__ = ["FNOFactorized2DBlock", "FNOFactorizedMesh2D", "FNOFactorizedMesh3D", "FNOMesh2D",
           "FNOMesh3D", "FNOPlus2DBlock", "FNOZongyi2DBlock", "ZongyiSpectralConv2d"]
