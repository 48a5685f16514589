from .cno_grid_2d import CNOFactorized2DBlock
from .cno_mesh_2d import CNOFactorizedMesh2D
from .cno_mesh_3d import CNOFactorizedMesh3D
from .ffno_grid_2d import FNOFactorized2DBlock
from .ffno_mesh_2d import FNOFactorizedMesh2D
from .ffno_mesh_3d import FNOFactorizedMesh3D
from .ffno_mesh_plus_2d import FNOFullyFactorizedMesh2D
from .ffno_point_cloud_2d import FNOFactorizedPointCloud2D
from .iphi import IPhi
from .learned_interpolation import LearnedInterpolationStep, PeriodicCNN
from .meshgraphnet import GraphProcessor
from .zongyi_fno_2d import FNOZongyi2DBlock, ZongyiSpectralConv2d
from .zongyi_fno_plus_2d import FNOPlus2DBlock
from .zongyi_mesh_2d import FNOMesh2D
from .zongyi_mesh_3d import FNOMesh3D
from .zongyi_point_cloud_2d import FNOPointCloud2D

__all__ = ["CNOFactorized2DBlock", "CNOFactorizedMesh2D", "CNOFactorizedMesh3D",
           "FNOFactorized2DBlock", "FNOFactorizedMesh2D", "FNOFactorizedMesh3D",
           "FNOFactorizedPointCloud2D", "FNOFullyFactorizedMesh2D", "FNOMesh2D", "FNOMesh3D",
           "FNOPlus2DBlock", "FNOPointCloud2D", "FNOZongyi2DBlock", "GraphProcessor", "IPhi",
           "LearnedInterpolationStep", "PeriodicCNN", "ZongyiSpectralConv2d"]
