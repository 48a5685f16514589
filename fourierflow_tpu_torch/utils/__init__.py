from .checkpoint import load_state, save_state
from .grids import Grid
from .hilbert import hilbert_index, hilbert_sort
from .weights import (cno_state_dict_from_flax, geo_point_cloud_state_dict_from_flax,
                      geo_state_dict_from_flax, learned_interpolation_state_dict_from_flax,
                      mesh_state_dict_from_flax, meshgraphnet_state_dict_from_flax,
                      plus_state_dict_from_flax, point_cloud_state_dict_from_flax,
                      state_dict_from_flax, zongyi_state_dict_from_flax)

__all__ = ["Grid", "load_state", "save_state", "hilbert_index", "hilbert_sort",
           "cno_state_dict_from_flax", "geo_point_cloud_state_dict_from_flax",
           "geo_state_dict_from_flax", "learned_interpolation_state_dict_from_flax",
           "mesh_state_dict_from_flax", "meshgraphnet_state_dict_from_flax",
           "plus_state_dict_from_flax",
           "point_cloud_state_dict_from_flax", "state_dict_from_flax",
           "zongyi_state_dict_from_flax"]
