from .checkpoint import load_state, save_state
from .grids import Grid
from .weights import (geo_state_dict_from_flax, mesh_state_dict_from_flax,
                      plus_state_dict_from_flax, state_dict_from_flax,
                      zongyi_state_dict_from_flax)

__all__ = ["Grid", "load_state", "save_state", "geo_state_dict_from_flax",
           "mesh_state_dict_from_flax", "plus_state_dict_from_flax", "state_dict_from_flax",
           "zongyi_state_dict_from_flax"]
