from .ffno_grid_2d import FNOFactorized2DBlock
from .zongyi_fno_2d import FNOZongyi2DBlock, ZongyiSpectralConv2d
from .zongyi_fno_plus_2d import FNOPlus2DBlock

__all__ = ["FNOFactorized2DBlock", "FNOPlus2DBlock", "FNOZongyi2DBlock", "ZongyiSpectralConv2d"]
