from .ffno_grid_2d import FNOFactorized2DBlock
from .zongyi_fno_2d import FNOZongyi2DBlock, ZongyiSpectralConv2d

__all__ = ["FNOFactorized2DBlock", "FNOZongyi2DBlock", "ZongyiSpectralConv2d"]
