from .base import Routine, State
from .grid_2d_markov import Grid2DMarkovRoutine

__all__ = ["Routine", "State", "Grid2DMarkovRoutine"]
