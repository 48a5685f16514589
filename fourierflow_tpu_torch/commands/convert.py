"""``convert cylinder-flow``: DeepMind's MeshGraphNets TFRecords to one HDF5
file (counterpart of ``fourierflow_tpu/commands/convert.py``), without
TensorFlow or h5py: the TFRecord framing and the ``tf.train.Example``
protobuf are parsed here, and the file is written by ``utils.hdf5``.

The layout is the JAX package's (and the reference's), one group a split
(``train``, ``valid``, ``test``): ``n_cells [B]`` and ``n_nodes [B]`` int32,
``cells [B, maxC, 3]`` int32 (-1 padded), ``mesh_pos [B, maxN, 2]`` float32
(NaN padded), ``node_type [B, maxN]`` int32 (-1 padded), ``velocity`` and
``target_velocity`` ``[B, T, maxN, 2]`` and ``pressure [B, T, maxN]``
float32 (NaN padded). As the reference's ``add_targets`` does, the first and
last of a trajectory's ``T + 2`` steps are dropped and the target is the
next step's velocity. Each split is read twice (its sizes, then its rows),
so that one trajectory at a time is in memory; the file is written under
``.tmp`` and renamed when complete.
"""

import json
import logging
import struct
from pathlib import Path
from typing import Dict, Iterator, List

import numpy as np

from ..utils.hdf5 import H5Writer

logger = logging.getLogger(__name__)

__all__ = ["cylinder_flow", "read_tfrecord", "parse_example"]

SPLITS = ("train", "valid", "test")


def read_tfrecord(path) -> Iterator[bytes]:
    """The record payloads of a TFRecord file. Each record is a uint64
    length, a uint32 masked CRC of it, the payload and a uint32 masked CRC
    of that; the CRCs are not checked."""
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            f.read(4)
            payload = f.read(length)
            f.read(4)
            yield payload


def _read_varint(buf: bytes, pos: int):
    result, shift = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _parse_message(buf: bytes) -> Dict[int, list]:
    """One protobuf message as ``{field number: [values]}``: bytes for
    length-delimited fields and 32/64-bit ones, ints for varints."""
    fields = {}
    pos, n = 0, len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field_num, wire_type = key >> 3, key & 0x7
        if wire_type == 0:
            val, pos = _read_varint(buf, pos)
        elif wire_type == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire_type == 5:
            val = buf[pos:pos + 4]
            pos += 4
        elif wire_type == 1:
            val = buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire_type}")
        fields.setdefault(field_num, []).append(val)
    return fields


def parse_example(payload: bytes) -> Dict[str, List[bytes]]:
    """A ``tf.train.Example`` as ``{name: [bytes]}`` (its BytesList
    features, which is how MeshGraphNets stores everything), walking
    Example{1: Features} / Features{1: map entries} / entry{1: key, 2:
    Feature} / Feature{1: BytesList} / BytesList{1: repeated bytes}."""
    example = _parse_message(payload)
    features = _parse_message(example[1][0])
    out = {}
    for entry in features.get(1, []):
        kv = _parse_message(entry)
        feature = _parse_message(kv[2][0])
        out[kv[1][0].decode("utf-8")] = (_parse_message(feature[1][0]).get(1, [])
                                         if 1 in feature else [])
    return out


_DTYPES = {"float32": np.float32, "int32": np.int32, "int64": np.int64}


def _decode_trajectory(example: Dict[str, List[bytes]], meta: dict) -> Dict[str, np.ndarray]:
    """One trajectory's arrays by the dataset's ``meta.json``: a static
    field tiled over the ``trajectory_length`` steps, a dynamic one as
    stored."""
    t_len = meta["trajectory_length"]
    out = {}
    for key, field in meta["features"].items():
        data = np.frombuffer(b"".join(example[key]), dtype=_DTYPES[field["dtype"]])
        data = data.reshape([int(d) if int(d) >= 0 else -1 for d in field["shape"]])
        if field["type"] == "static":
            data = np.tile(data, (t_len, 1, 1))
        elif field["type"] == "dynamic_varlen":
            raise NotImplementedError("dynamic_varlen fields are not used by cylinder_flow")
        elif field["type"] != "dynamic":
            raise ValueError(f"invalid field type {field['type']!r}")
        out[key] = data
    return out


def _trajectories(in_path: Path, split: str, meta: dict) -> Iterator[Dict[str, np.ndarray]]:
    for payload in read_tfrecord(in_path / f"{split}.tfrecord"):
        yield _decode_trajectory(parse_example(payload), meta)


def _padded(a: np.ndarray, length: int, fill) -> np.ndarray:
    """``a`` padded with ``fill`` to ``length`` along its first axis."""
    out = np.full((length,) + a.shape[1:], fill, a.dtype)
    out[:len(a)] = a
    return out


def cylinder_flow(data_dir: str = "data/meshgraphnets/cylinder_flow",
                  out: str = "data/meshgraphnets/cylinder_flow/cylinder_flow.h5") -> str:
    """Convert ``data_dir``'s ``meta.json`` and ``{train,valid,test}.tfrecord``
    to the HDF5 file ``out``, each split padded to its largest mesh.
    Returns the path written."""
    in_path = Path(data_dir)
    with open(in_path / "meta.json") as fp:
        meta = json.load(fp)
    sizes = {}
    for split in SPLITS:
        counts = [(t["cells"].shape[1], t["mesh_pos"].shape[1], t["cells"].shape[0])
                  for t in _trajectories(in_path, split, meta)]
        if not counts:
            raise ValueError(f"{in_path / split}.tfrecord holds no trajectory")
        n_cells, n_nodes, t_lens = (np.asarray(c, np.int32) for c in zip(*counts))
        sizes[split] = (n_cells, n_nodes, int(t_lens[0]) - 2)
        logger.info("%s: %d samples, max_cells=%d max_nodes=%d", split, len(counts),
                    n_cells.max(), n_nodes.max())

    layout = {}
    for split, (n_cells, n_nodes, n_steps) in sizes.items():
        b, c, n = len(n_cells), int(n_cells.max()), int(n_nodes.max())
        layout.update({
            f"{split}/n_cells": ((b,), np.int32), f"{split}/n_nodes": ((b,), np.int32),
            f"{split}/cells": ((b, c, 3), np.int32), f"{split}/mesh_pos": ((b, n, 2), np.float32),
            f"{split}/node_type": ((b, n), np.int32),
            f"{split}/velocity": ((b, n_steps, n, 2), np.float32),
            f"{split}/target_velocity": ((b, n_steps, n, 2), np.float32),
            f"{split}/pressure": ((b, n_steps, n), np.float32)})
    out_path = Path(out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with H5Writer(str(out_path), layout, atomic=True) as f:
        for split, (n_cells, n_nodes, _) in sizes.items():
            f.write(f"{split}/n_cells", 0, n_cells)
            f.write(f"{split}/n_nodes", 0, n_nodes)
            c, n = int(n_cells.max()), int(n_nodes.max())
            node_axis = lambda a, fill: np.moveaxis(_padded(np.moveaxis(a, 1, 0), n, fill), 0, 1)
            for i, t in enumerate(_trajectories(in_path, split, meta)):
                row = lambda name, a: f.write(f"{split}/{name}", i, a[None])
                row("cells", _padded(t["cells"][0], c, -1))
                row("mesh_pos", _padded(t["mesh_pos"][0], n, np.nan))
                row("node_type", _padded(t["node_type"][0, :, 0], n, -1))
                row("velocity", node_axis(t["velocity"][1:-1], np.nan))
                row("target_velocity", node_axis(t["velocity"][2:], np.nan))
                row("pressure", node_axis(t["pressure"][1:-1, :, 0], np.nan))
    return str(out_path)
