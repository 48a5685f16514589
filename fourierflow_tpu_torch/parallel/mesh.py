"""Device meshes over ``torch.distributed`` (counterpart of
``fourierflow_tpu/parallel/mesh.py``).

One process drives one device: ``torchrun`` starts them and sets ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK`` (or a test passes a ``file://`` store,
the rank and the world size), and ``init_distributed`` joins the process
group: NCCL for a CUDA device, ``gloo`` for the CPU. A rank runs on
``cuda:LOCAL_RANK`` unless the CPU is asked for.

The meshes carry the JAX package's axis names and rules: ``("data",)``,
``("data", "model")`` (Megatron-style tensor parallelism: the feed-forward's
hidden dims and the spectral weights' output channels split over ``model``)
and ``("data", "spatial")`` (the grid's first spatial dim split over
``spatial``). Too few ranks raise; ranks that do not fill a whole data row
are left out of the mesh, with JAX's warning, and take no part in a fit
(``Trainer.fit`` returns their state unchanged at once).

Where JAX places arrays on a mesh, each rank here holds its own block:
``shard_batch`` gives each rank its local slice of a batch by JAX's rules
(``placement``), ``shard_state`` cuts the parameters and their AdamW
moments that ``tp_param_specs`` names down to this rank's block (marking
each such parameter with its ``tp_dim``, which the layers' tensor-parallel
forms and ``split_dims`` read), and ``gather_state`` puts them back
together (what a checkpoint holds).
"""

import copy
import logging
import os
from dataclasses import replace
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from .collectives import Axis, all_gather, mesh_axis

logger = logging.getLogger(__name__)

__all__ = ["init_distributed", "world_size", "make_mesh", "make_tp_mesh", "make_sp_mesh",
           "mesh_shape", "in_mesh", "placement", "ShardedBatch", "batch_sharding",
           "replicated", "shard_batch", "tp_param_specs", "shard_tensor", "split_dims",
           "shard_state", "gather_state", "is_rank0"]


def init_distributed(device=None, init_method: Optional[str] = None, rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> torch.device:
    """Join the process group (once a process) and return this rank's
    device: ``cuda:LOCAL_RANK`` unless ``device`` says otherwise. The rank,
    the world size and the store come from ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``) unless
    given. NCCL on a CUDA device, ``gloo`` on the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo", init_method=init_method or "env://",
            rank=int(os.environ["RANK"]) if rank is None else rank,
            world_size=int(os.environ["WORLD_SIZE"]) if world_size is None else world_size)
    return dev


def world_size() -> int:
    """The ranks of the process group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _mesh(ranks, names):
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("a device mesh needs the process group: call "
                           "parallel.init_distributed() first (torchrun sets its environment)")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.as_tensor(ranks), mesh_dim_names=names)


def _ranks(n_devices: Optional[int]):
    ranks = np.arange(world_size())
    return ranks if n_devices is None else ranks[:n_devices]


def make_mesh(n_devices: Optional[int] = None, axis: str = "data"):
    """A one-axis mesh over the first ``n_devices`` ranks (all of them by default)."""
    return _mesh(_ranks(n_devices), (axis,))


def _two_axis_mesh(fn: str, what: str, inner: str, size: int, n_devices: Optional[int]):
    ranks = _ranks(n_devices)
    if len(ranks) < size:
        raise ValueError(f"{what}={size} needs at least that many devices; have {len(ranks)}")
    n = (len(ranks) // size) * size
    if n < len(ranks):
        logger.warning("%s: dropping %d of %d devices (not divisible by %s=%d)", fn,
                       len(ranks) - n, len(ranks), what, size)
    return _mesh(ranks[:n].reshape(-1, size), ("data", inner))


def make_tp_mesh(tensor_parallel: int, n_devices: Optional[int] = None):
    """data x model mesh: the model axis carries ``tensor_parallel`` shards,
    the data axis everything else. Ranks that do not fill a whole data row
    are dropped (with a warning): they are in no axis of the mesh."""
    return _two_axis_mesh("make_tp_mesh", "tensor_parallel", "model", tensor_parallel, n_devices)


def make_sp_mesh(spatial_parallel: int, n_devices: Optional[int] = None):
    """data x spatial mesh: the spatial axis carries ``spatial_parallel``
    shards of the grid's first spatial dim, the data axis the rest. Ranks
    that do not fill a whole data row are dropped, as by ``make_tp_mesh``."""
    return _two_axis_mesh("make_sp_mesh", "spatial_parallel", "spatial", spatial_parallel,
                          n_devices)


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis name: size}`` (JAX's ``dict(mesh.shape)``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def in_mesh(mesh) -> bool:
    """Whether this rank is one of the mesh's (a dropped rank is not)."""
    return mesh.get_coordinate() is not None


def is_rank0() -> bool:
    """Rank 0 of the process group, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


# --- batches ------------------------------------------------------------------------------------
def placement(shape, mesh, axis: Optional[str] = "data", spatial_axis: Optional[str] = None):
    """The mesh axis of each leading dim of an array of ``shape`` under
    ``shard_batch``'s rules, as JAX's PartitionSpec (trailing Nones
    trimmed): ``("data", "spatial")``, ``("data",)``, ``(None, "spatial")``
    or ``()`` (replicated). ``axis`` None leaves the batch dim whole."""
    sizes = mesh_shape(mesh)
    batch_ok = axis is not None and len(shape) >= 1 and shape[0] % sizes[axis] == 0
    grid_ok = (spatial_axis is not None and len(shape) >= 3
               and shape[1] % sizes[spatial_axis] == 0)
    if grid_ok:
        return (axis if batch_ok else None, spatial_axis)
    return (axis,) if batch_ok else ()


class ShardedBatch(dict):
    """A rank's local slice of a batch: the arrays, and in ``specs`` the mesh
    axis of each leading dim of each (``placement``), which the routine reads
    to reduce its statistics, noise and losses over the split axes."""

    def __init__(self, arrays, specs):
        super().__init__(arrays)
        self.specs = dict(specs)

    def spec(self, key: str):
        return self.specs.get(key, ())


def batch_sharding(x, mesh, axis: str = "data", dim: int = 0):
    """This rank's block of ``x`` along ``dim`` (the batch dim by default)
    on the mesh axis ``axis``, which must divide it."""
    ax = mesh_axis(mesh, axis)
    k, rem = divmod(x.shape[dim], ax.size)
    if rem:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide the '{axis}' axis of "
                         f"{ax.size}")
    return x[(slice(None),) * dim + (slice(ax.rank * k, (ax.rank + 1) * k),)]


def replicated(x, mesh):
    """``x`` as every rank of ``mesh`` holds it: all of it."""
    return x


def shard_batch(batch, mesh, axis: Optional[str] = "data",
                spatial_axis: Optional[str] = None) -> ShardedBatch:
    """Each rank's local slice of a dict of arrays (numpy or torch), by the
    JAX package's rules: the batch dim split on ``axis`` when it divides that
    axis; with ``spatial_axis``, dim 1 of a grid (``ndim >= 3``) split on it
    when it divides, also where the batch dim does not (the point of spatial
    parallelism: batch 1-2 on a large grid); anything else replicated, with
    a warning above 8 MB. ``axis`` None keeps every batch dim whole (the
    evaluation's batches of a routine that reduces nothing over ``data``).
    A tuple or list of dicts (the learned interpolation's ``(inputs,
    outputs)``) gives one ``ShardedBatch`` for each, as JAX maps the rules
    over the tree's leaves."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(b, mesh, axis, spatial_axis) for b in batch)
    sizes = mesh_shape(mesh)
    arrays, specs = {}, {}
    for key, x in batch.items():
        if not (hasattr(x, "shape") and len(x.shape) >= 1):
            arrays[key], specs[key] = x, ()
            continue
        spec = placement(x.shape, mesh, axis, spatial_axis)
        if not spec and axis is not None:
            nbytes = int(np.prod(x.shape)) * (x.element_size() if isinstance(x, torch.Tensor)
                                              else np.asarray(x).itemsize)
            if nbytes > (8 << 20):
                logger.warning(
                    "shard_batch: replicating a %.1f MB array of shape %s on every device "
                    "(batch dim %d does not divide the '%s' axis size %d%s)", nbytes / 2**20,
                    tuple(x.shape), x.shape[0], axis, sizes[axis],
                    f"; dim 1 {x.shape[1]} does not divide the '{spatial_axis}' axis size "
                    f"{sizes[spatial_axis]}" if spatial_axis is not None and len(x.shape) >= 2
                    else "")
        local = replicated(x, mesh)
        for dim, name in enumerate(spec):
            if name is not None:
                local = batch_sharding(local, mesh, name, dim)
        arrays[key], specs[key] = local, spec
    return ShardedBatch(arrays, specs)


# --- the state ----------------------------------------------------------------------------------
def _tp_dim(name: str, shape, n_model: int) -> Optional[int]:
    """The dim of one parameter split over ``model`` (JAX's ``_tp_spec`` on
    torch's layouts): the spectral weights ``[C_in, C_out, M, 2]`` and
    ``[C_in, C_out, M, M, 2]`` by output channel (dim 1); a feed-forward's
    expansion weight ``[factor C, C]`` by output row (dim 0) and its
    contraction ``[C, factor C]`` by input column (dim 1); everything else
    (heads, biases, weight-norm gains, the normalizer) replicated, as is a
    dim that the axis does not divide."""
    dim = None
    if "fourier_weight" in name and len(shape) in (4, 5):
        dim = 1
    elif "_ff." in name and name.endswith(("weight_v", "weight")) and len(shape) == 2:
        dim = 0 if shape[0] > shape[1] else 1 if shape[1] > shape[0] else None
    if dim is not None and shape[dim] % n_model:
        return None
    return dim


def tp_param_specs(model, mesh, axis: str = "model") -> Dict[str, Optional[int]]:
    """``{state_dict name: the dim split over axis, or None}`` for every
    parameter of ``model`` (a shared one under each of its names), by the
    JAX package's ``tp_state_shardings`` rule."""
    n_model = mesh_shape(mesh)[axis]
    return {name: _tp_dim(name, tuple(p.shape), n_model)
            for name, p in model.state_dict(keep_vars=True).items()
            if isinstance(p, torch.nn.Parameter)}


def shard_tensor(t: torch.Tensor, dim: Optional[int], axis: Optional[Axis]) -> torch.Tensor:
    """This rank's block of a whole tensor along ``dim`` (all of it where
    ``dim`` or ``axis`` is None)."""
    if dim is None or axis is None:
        return t
    k = t.shape[dim] // axis.size
    return t.narrow(dim, axis.rank * k, k).contiguous()


def split_dims(model) -> Dict[str, int]:
    """``{state_dict name: dim}`` of the parameters that ``shard_state`` split
    (a shared one under each of its names); empty for a whole model."""
    return {name: p.tp_dim for name, p in model.named_parameters(remove_duplicate=False)
            if getattr(p, "tp_dim", None) is not None}


def _param_dims(model):
    """``[(parameter, split dim or None)]`` in ``model.parameters()`` order
    (the optimizer's)."""
    return [(p, getattr(p, "tp_dim", None)) for p in model.parameters()]


def shard_state(state, mesh):
    """The state of a fit on ``mesh``: the model told its tensor- and
    spatial-parallel axes (``model.set_parallel``), each parameter that
    ``tp_param_specs`` splits cut to this rank's block on ``model`` with its
    AdamW moments (in place: the optimizer keeps its parameters) and marked
    with its ``tp_dim`` (also on a ``model`` axis of one rank, so that the
    split forms run there), and ``state.mesh`` set.

    A model that ``tp_param_specs`` splits nowhere runs whole on every rank
    of ``model`` on a mesh without ``spatial``, with or without a parallel
    form (JAX's ``_tp_spec`` replicates every leaf of such a model: the
    learned interpolation, MeshGraphNet, the Geo-FNOs). A model with a leaf
    to split, or on ``spatial``, and without ``set_parallel`` raises the
    ``NotImplementedError`` that names it."""
    tp, sp = mesh_axis(mesh, "model"), mesh_axis(mesh, "spatial")
    model = state.model
    specs = tp_param_specs(model, mesh) if tp is not None else {}
    splits = any(d is not None for d in specs.values())
    if (splits or sp is not None) and not hasattr(model, "set_parallel"):
        raise NotImplementedError(
            f"{type(model).__name__} has no {'spatial' if sp is not None else 'tensor'}-parallel "
            "form")
    if (tp is not None or sp is not None) and hasattr(model, "set_parallel"):
        model.set_parallel(tensor=tp, spatial=sp)
    if splits:
        moments = state.optimizer.state if state.optimizer is not None else {}
        with torch.no_grad():
            for name, p in model.named_parameters():
                dim = specs[name]
                if dim is None:
                    continue
                for k, v in moments.get(p, {}).items():
                    if isinstance(v, torch.Tensor) and v.shape == p.shape:
                        moments[p][k] = shard_tensor(v, dim, tp)
                p.data = shard_tensor(p.data, dim, tp)
                p.tp_dim = dim
    return replace(state, mesh=mesh)


def gather_state(state, mesh=None):
    """The whole state of a sharded one, on every rank of ``model`` (a
    collective there): a copy of the model with each split parameter
    gathered and no parallel axes, and an optimizer of its class over the
    copy with the gathered moments; the normalizer, schedule and step as
    they are. A state with nothing split is returned as it is."""
    mesh = state.mesh if mesh is None else mesh
    tp = mesh_axis(mesh, "model")
    model = state.model
    if tp is None or not any(d is not None for _, d in _param_dims(model)):
        return state
    # The modules' axes hold process groups, which are not copied.
    axes = {id(a): a for m in model.modules() for a in (getattr(m, "tensor_parallel", None),
                                                        getattr(m, "spatial_parallel", None))
            if a is not None}
    whole = copy.deepcopy(model, memo=axes)
    whole.set_parallel(tensor=None, spatial=None)
    with torch.no_grad():
        for (p, dim), q in zip(_param_dims(model), whole.parameters(), strict=True):
            if dim is not None:
                q.data = all_gather(p.data, tp, dim)
                q.tp_dim = None
    optimizer = None
    if state.optimizer is not None:
        blob = state.optimizer.state_dict()
        # state_dict() hands out the live moments' dicts: gather into copies.
        blob["state"] = {i: dict(m) for i, m in blob["state"].items()}
        for i, (p, dim) in enumerate(_param_dims(model)):
            for k, v in blob["state"].get(i, {}).items():
                if dim is not None and isinstance(v, torch.Tensor) and v.shape == p.shape:
                    blob["state"][i][k] = all_gather(v, tp, dim)
        # load_state_dict brings every hyper-parameter of the groups along.
        optimizer = type(state.optimizer)(whole.parameters(), lr=state.optimizer.defaults["lr"])
        optimizer.load_state_dict(blob)
    return replace(state, model=whole, optimizer=optimizer, mesh=None)
