from .base import Builder, iterate_batches, load_array
from .ns_markov import NSMarkovBuilder

__all__ = ["Builder", "iterate_batches", "load_array", "NSMarkovBuilder"]
