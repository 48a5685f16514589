from .base import Builder, iterate_batches, load_array
from .ns_contextual import NSContextualBuilder
from .ns_markov import NSMarkovBuilder
from .ns_zongyi import NSZongyiBuilder

__all__ = ["Builder", "iterate_batches", "load_array", "NSContextualBuilder", "NSMarkovBuilder",
           "NSZongyiBuilder"]
