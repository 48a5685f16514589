from .base import Builder, iterate_batches, load_array
from .cylinder_flow import CylinderFlowBuilder
from .elasticity import ElasticityBuilder
from .kolmogorov import (KolmogorovBuilder, KolmogorovMarkovDataset, KolmogorovMultiDataset,
                         KolmogorovTrajectoryDataset, KolmogorovVelocityDataset,
                         KolmogorovVelocityTrajectoryDataset)
from .ns_contextual import NSContextualBuilder
from .ns_markov import NSMarkovBuilder
from .ns_zongyi import NSZongyiBuilder
from .plasticity import PlasticityBuilder
from .structured_mesh_2d import StructuredMesh2DBuilder

__all__ = ["Builder", "iterate_batches", "load_array", "CylinderFlowBuilder", "ElasticityBuilder",
           "KolmogorovBuilder", "KolmogorovMarkovDataset", "KolmogorovMultiDataset",
           "KolmogorovTrajectoryDataset", "KolmogorovVelocityDataset",
           "KolmogorovVelocityTrajectoryDataset",
           "NSContextualBuilder", "NSMarkovBuilder", "NSZongyiBuilder", "PlasticityBuilder",
           "StructuredMesh2DBuilder"]
