from .checkpoint import load_state, save_state
from .grids import Grid
from .weights import plus_state_dict_from_flax, state_dict_from_flax, zongyi_state_dict_from_flax

__all__ = ["Grid", "load_state", "save_state", "plus_state_dict_from_flax", "state_dict_from_flax",
           "zongyi_state_dict_from_flax"]
