from .base import Routine, State
from .grid_2d_markov import Grid2DMarkovRoutine
from .grid_2d_rollout import Grid2DRolloutRoutine

__all__ = ["Routine", "State", "Grid2DMarkovRoutine", "Grid2DRolloutRoutine"]
