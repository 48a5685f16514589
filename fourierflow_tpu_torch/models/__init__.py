from .ffno_grid_2d import FNOFactorized2DBlock

__all__ = ["FNOFactorized2DBlock"]
