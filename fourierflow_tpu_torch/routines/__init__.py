from .base import Routine, State
from .grid_2d_markov import Grid2DMarkovRoutine
from .grid_2d_rollout import Grid2DRolloutRoutine
from .learned_interpolator import LearnedInterpolatorRoutine
from .meshgraphnet import MeshGraphNetRoutine
from .point_cloud import PointCloudRoutine
from .structured_mesh import StructuredMeshRoutine

__all__ = ["Routine", "State", "Grid2DMarkovRoutine", "Grid2DRolloutRoutine",
           "LearnedInterpolatorRoutine", "MeshGraphNetRoutine", "PointCloudRoutine",
           "StructuredMeshRoutine"]
