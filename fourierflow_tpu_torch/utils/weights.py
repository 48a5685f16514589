"""Carry weights from the JAX package's flax parameter trees to this
package's ``state_dict``s: F-FNO (the inverse of the JAX package's
``utils/torch_import.py::convert_ffno_state_dict``), FNO++ (the same tree
with full spectral weights ``fourier_weight_{1,2}``), the original FNO
(of ``convert_zongyi_state_dict``), the F-FNO mesh models (the F-FNO tree
with per-axis weights ``fourier_weight_{x,y,z}``) and the Geo-FNO mesh
models (``fc0``, ``convs_{i}_weight_{k}``, ``ws_{i}``, ``fc1``, ``fc2``), the
point-cloud models (the F-FNO, the fully-factorized one and the Geo-FNO,
each with its ``iphi`` subtree), the CNO models (the F-FNO trees with
real ``[in, out, modes]`` Fourier weights), the learned-interpolation model
(its CNN's convolutions) and MeshGraphNet (its MLPs and LayerNorms).

Input: the flax params of an ``FNOFactorized2DBlock`` as a nested dict of
numpy arrays (with or without the outer ``"params"`` level) and its number
of layers. As in the reference's torch modules, a shared tensor
(``share_weight``, ``share_fork``) is listed at block level and again under
every layer. Linear
kernels ``[in, out]`` become ``weight_v``/``weight`` ``[out, in]``; ``g``
``[1, out]`` becomes ``weight_g`` ``[out, 1]``; Fourier weights
``[in, out, modes, 2]`` carry over as they are.

Naming trap: at block level flax calls the output head's two layers
``WNLinear_0``/``WNLinear_1`` (they become ``out.0``/``out.1``), while
inside each FeedForward ``WNLinear_0``/``WNLinear_1`` are its own layers
(``layers.0.0``/``layers.1.0``).
"""

import re
from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["state_dict_from_flax", "plus_state_dict_from_flax", "zongyi_state_dict_from_flax",
           "mesh_state_dict_from_flax", "geo_state_dict_from_flax", "cno_state_dict_from_flax",
           "point_cloud_state_dict_from_flax", "geo_point_cloud_state_dict_from_flax",
           "learned_interpolation_state_dict_from_flax", "meshgraphnet_state_dict_from_flax"]

_LAYER_W = re.compile(r"layers_(\d+)_fourier_weight_([xy])$")
_PLUS_LAYER_W = re.compile(r"layers_(\d+)_fourier_weight_([12])$")
_MESH_LAYER_W = re.compile(r"layers_(\d+)_fourier_weight_([xyz])$")
_LAYER_FF = re.compile(r"layers_(\d+)_(backcast_ff|forecast_ff)$")
_FF_LIN = re.compile(r"WNLinear_(\d+)$")
_BRANCH = {"y": 0, "x": 1, "1": 0, "2": 1}
_MESH_BRANCH = {"x": 0, "y": 1, "z": 2}


def _tensor(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32))


def _linear(p: Mapping, base: str, out: Dict[str, torch.Tensor]) -> None:
    kernel = np.asarray(p["kernel"]).T
    if "g" in p:
        out[f"{base}.weight_v"] = _tensor(kernel)
        out[f"{base}.weight_g"] = _tensor(np.asarray(p["g"]).reshape(-1, 1))
    else:
        out[f"{base}.weight"] = _tensor(kernel)
    if "bias" in p:
        out[f"{base}.bias"] = _tensor(p["bias"])


def _ff(p: Mapping, base: str, out: Dict[str, torch.Tensor]) -> None:
    for name, lin in p.items():
        m = _FF_LIN.match(name)
        if m is None:
            raise KeyError(f"unexpected FeedForward entry {base}.{name}")
        _linear(lin, f"{base}.layers.{m.group(1)}.0", out)


_ZONGYI_LAYER = re.compile(r"layers_(\d+)$")
_ZONGYI_HEAD = {"WNLinear_0": "feedforward.0", "WNLinear_1": "feedforward.2"}


def zongyi_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``FNOZongyi2DBlock`` params -> port ``state_dict``: ``in_proj``,
    ``layers_{i}`` (``fourier_weight_1/2`` -> ``fourier_weight.0/1``,
    ``linear``) and the head ``WNLinear_0/1`` -> ``feedforward.0/2``. The
    tree of ``Grid2DRolloutRoutine`` with Fourier positions (``conv`` and
    ``in_proj``) becomes ``FourierPositionNet``'s ``conv.*`` and ``in_proj.*``."""
    if "params" in params:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    if "conv" in params:
        out.update({f"conv.{k}": v for k, v in zongyi_state_dict_from_flax(params["conv"]).items()})
        _linear(params["in_proj"], "in_proj", out)
        return out
    for name, value in params.items():
        m = _ZONGYI_LAYER.match(name)
        if name == "in_proj":
            _linear(value, "in_proj", out)
        elif name in _ZONGYI_HEAD:
            _linear(value, _ZONGYI_HEAD[name], out)
        elif m:
            base = f"spectral_layers.{m.group(1)}"
            out[f"{base}.fourier_weight.0"] = _tensor(value["fourier_weight_1"])
            out[f"{base}.fourier_weight.1"] = _tensor(value["fourier_weight_2"])
            _linear(value["linear"], f"{base}.linear", out)
        else:
            raise KeyError(f"unexpected FNOZongyi2DBlock parameter {name!r}")
    return out


def state_dict_from_flax(params: Mapping, n_layers: int) -> Dict[str, torch.Tensor]:
    """Flax ``FNOFactorized2DBlock`` params -> port ``state_dict``."""
    return _block_state_dict(params, n_layers, ("fourier_weight_y", "fourier_weight_x"),
                             _LAYER_W, "FNOFactorized2DBlock")


def mesh_state_dict_from_flax(params: Mapping, n_layers: int) -> Dict[str, torch.Tensor]:
    """Flax ``FNOFactorizedMesh2D`` / ``FNOFactorizedMesh3D`` params -> port
    ``state_dict``: as F-FNO's, with ``fourier_weight_{x,y,z}`` becoming
    ``fourier_weight.{0,1,2}`` (shared at block level and in every layer,
    or ``layers_{i}_fourier_weight_*`` per layer)."""
    return _block_state_dict(params, n_layers,
                             ("fourier_weight_x", "fourier_weight_y", "fourier_weight_z"),
                             _MESH_LAYER_W, "FNOFactorizedMesh", _MESH_BRANCH)


_GEO_CONV = re.compile(r"convs_(\d+)_weight_(\d)$")
_GEO_WS = re.compile(r"ws_(\d+)$")


def geo_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``FNOMesh2D`` / ``FNOMesh3D`` params -> port ``state_dict``:
    ``fc0``, ``ws_{i}``, ``fc1`` and ``fc2`` (Dense ``[in, out]`` kernels)
    become ``fc0``, ``ws.{i}``, ``fc1`` and ``fc2``, and
    ``convs_{i}_weight_{k}`` becomes ``convs.{i}.{k - 1}``."""
    if "params" in params:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    for name, value in params.items():
        conv, ws = _GEO_CONV.match(name), _GEO_WS.match(name)
        if name in ("fc0", "fc1", "fc2"):
            _linear(value, name, out)
        elif ws:
            _linear(value, f"ws.{ws.group(1)}", out)
        elif conv:
            out[f"convs.{conv.group(1)}.{int(conv.group(2)) - 1}"] = _tensor(value)
        else:
            raise KeyError(f"unexpected Geo-FNO parameter {name!r}")
    return out


def cno_state_dict_from_flax(params: Mapping, n_layers: int,
                             grid: bool = False) -> Dict[str, torch.Tensor]:
    """Flax CNO params -> port ``state_dict``. The trees are the F-FNO ones
    with real ``[in, out, modes]`` Fourier weights: ``CNOFactorized2DBlock``'s
    (``grid``, Y then X as in ``state_dict_from_flax``) and
    ``CNOFactorizedMesh2D`` / ``CNOFactorizedMesh3D``'s (X, Y, Z as in
    ``mesh_state_dict_from_flax``)."""
    if grid:
        return state_dict_from_flax(params, n_layers)
    return mesh_state_dict_from_flax(params, n_layers)


_CLOUD_W = re.compile(r"(layers|convs)_(\d+)_fourier_weight_([xy])$")
_CLOUD_FF = re.compile(r"(layers|convs)_(\d+)_backcast_ff$")
_CLOUD_LINEAR = ("fc0", "bs_grid", "bs_points", "fc1", "fc2")


def _iphi(p: Mapping, out: Dict[str, torch.Tensor]) -> None:
    for name, lin in p.items():
        _linear(lin, f"iphi.{name}", out)


def point_cloud_state_dict_from_flax(params: Mapping, n_layers: int) -> Dict[str, torch.Tensor]:
    """Flax ``FNOFactorizedPointCloud2D`` / ``FNOFullyFactorizedMesh2D``
    params -> port ``state_dict``. The F-FNO's middle layer ``layers_{i}``
    (i from 1) becomes ``spectral_layers.{i - 1}``, with the shared
    ``fourier_weight_{y,x}`` at block level and in each of its ``n_layers -
    1`` layers; the fully-factorized model's ``convs_{i}`` becomes
    ``spectral_layers.{i}``. Fourier weights Y -> ``.0``, X -> ``.1``;
    ``last_weight_{1,2}`` -> ``last_weight.{0,1}``; ``iphi`` -> ``iphi.*``."""
    if "params" in params:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    for name, value in params.items():
        w, ff = _CLOUD_W.match(name), _CLOUD_FF.match(name)
        if name in _CLOUD_LINEAR:
            _linear(value, name, out)
        elif name == "iphi":
            _iphi(value, out)
        elif name in ("fourier_weight_y", "fourier_weight_x"):
            for base in ["", *(f"spectral_layers.{i}." for i in range(n_layers - 1))]:
                out[f"{base}fourier_weight.{_BRANCH[name[-1]]}"] = _tensor(value)
        elif name in ("last_weight_1", "last_weight_2"):
            out[f"last_weight.{int(name[-1]) - 1}"] = _tensor(value)
        elif w:
            kind, i, axis = w.groups()
            j = int(i) - (kind == "layers")
            out[f"spectral_layers.{j}.fourier_weight.{_BRANCH[axis]}"] = _tensor(value)
        elif ff:
            kind, i = ff.groups()
            _ff(value, f"spectral_layers.{int(i) - (kind == 'layers')}.backcast_ff", out)
        else:
            raise KeyError(f"unexpected point-cloud model parameter {name!r}")
    return out


_GEO_BS = re.compile(r"bs_(\d+)$")


def geo_point_cloud_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``FNOPointCloud2D`` params -> port ``state_dict``: as
    ``geo_state_dict_from_flax``, with ``bs_{i}`` -> ``bs.{i}`` and ``iphi`` ->
    ``iphi.*``."""
    if "params" in params:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    rest = {}
    for name, value in params.items():
        bs = _GEO_BS.match(name)
        if bs:
            _linear(value, f"bs.{bs.group(1)}", out)
        elif name == "iphi":
            _iphi(value, out)
        else:
            rest[name] = value
    out.update(geo_state_dict_from_flax(rest))
    return out


def plus_state_dict_from_flax(params: Mapping, n_layers: int) -> Dict[str, torch.Tensor]:
    """Flax ``FNOPlus2DBlock`` params -> port ``state_dict``: as F-FNO's,
    with ``fourier_weight_1``/``_2`` ``[in, out, m, m, 2]`` becoming
    ``fourier_weight.0``/``.1``."""
    return _block_state_dict(params, n_layers, ("fourier_weight_1", "fourier_weight_2"),
                             _PLUS_LAYER_W, "FNOPlus2DBlock")


def _block_state_dict(params: Mapping, n_layers: int, shared_w, layer_w: re.Pattern,
                      what: str, branch: Mapping[str, int] = _BRANCH) -> Dict[str, torch.Tensor]:
    if "params" in params:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    for name, value in params.items():
        if name == "in_proj":
            _linear(value, "in_proj", out)
        elif name in shared_w:
            w = _tensor(value)
            for base in ["", *(f"spectral_layers.{i}." for i in range(n_layers))]:
                out[f"{base}fourier_weight.{branch[name[-1]]}"] = w
        elif name in ("backcast_ff", "forecast_ff"):
            for base in [name, *(f"spectral_layers.{i}.{name}" for i in range(n_layers))]:
                _ff(value, base, out)
        elif _FF_LIN.match(name):
            _linear(value, f"out.{_FF_LIN.match(name).group(1)}", out)
        elif layer_w.match(name):
            i, axis = layer_w.match(name).groups()
            out[f"spectral_layers.{i}.fourier_weight.{branch[axis]}"] = _tensor(value)
        elif _LAYER_FF.match(name):
            i, kind = _LAYER_FF.match(name).groups()
            _ff(value, f"spectral_layers.{i}.{kind}", out)
        else:
            raise KeyError(f"unexpected {what} parameter {name!r}")
    return out


_LI_CONV = re.compile(r"conv_(\d+)$")


def learned_interpolation_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``LearnedInterpolationStep`` params -> port ``state_dict``:
    ``coeff_net/conv_{i}`` -> ``coeff_net.convs.{i}`` and ``coeff_net/out``
    -> ``coeff_net.out``. A flax kernel ``[3, 3, in, out]`` becomes the
    ``[out, in, 3, 3]`` weight, unflipped (both are cross-correlations, over
    X then Y)."""
    if "params" in params:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    for name, conv in params["coeff_net"].items():
        m = _LI_CONV.match(name)
        if m is None and name != "out":
            raise KeyError(f"unexpected PeriodicCNN parameter {name!r}")
        base = f"coeff_net.convs.{m.group(1)}" if m else "coeff_net.out"
        out[f"{base}.weight"] = _tensor(np.transpose(np.asarray(conv["kernel"]), (3, 2, 0, 1)))
        out[f"{base}.bias"] = _tensor(conv["bias"])
    return out


_MGN_LINEAR = re.compile(r"linear_(\d+)$")
_MGN_LAYER = re.compile(r"graph_layer_(\d+)$")
_MGN_BLOCK = {"node_encoder": "node_encoder", "edge_encoder_0": "edge_encoder",
              "decoder": "decoder", "edge_updater_0": "edge_updater",
              "node_updater": "node_updater"}


def _mlp_block(p: Mapping, base: str, out: Dict[str, torch.Tensor]) -> None:
    for name, value in p.items():
        if name == "norm":
            out[f"{base}.norm.weight"] = _tensor(value["scale"])
            out[f"{base}.norm.bias"] = _tensor(value["bias"])
        elif _MGN_LINEAR.match(name):
            _linear(value, f"{base}.linear.{_MGN_LINEAR.match(name).group(1)}", out)
        else:
            raise KeyError(f"unexpected MLPBlock parameter {base}.{name}")


def meshgraphnet_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``GraphProcessor`` params -> port ``state_dict``: the blocks
    ``node_encoder``, ``edge_encoder_0`` -> ``edge_encoder``, ``decoder`` and
    ``graph_layer_{i}/{edge_updater_0,node_updater}`` ->
    ``graph_layers.{i}.{edge_updater,node_updater}``; in each, ``linear_{k}``
    -> ``linear.{k}`` (Dense kernels transposed) and the LayerNorm ``norm``'s
    ``scale`` / ``bias`` -> ``norm.weight`` / ``norm.bias``."""
    if "params" in params:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    for name, value in params.items():
        layer = _MGN_LAYER.match(name)
        if layer:
            for sub, block in value.items():
                _mlp_block(block, f"graph_layers.{layer.group(1)}.{_MGN_BLOCK[sub]}", out)
        elif name in _MGN_BLOCK:
            _mlp_block(value, _MGN_BLOCK[name], out)
        else:
            raise KeyError(f"unexpected GraphProcessor parameter {name!r}")
    return out
