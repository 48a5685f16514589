"""The port's MeshGraphNet slice (``models/meshgraphnet.py``,
``routines/meshgraphnet.py``, ``builders/cylinder_flow.py``, ``convert
cylinder-flow`` and ``meshgraphnet_state_dict_from_flax``) against the JAX
package's, on the CPU, on small padded meshes (2 message-passing layers,
latent 16).

Tolerances (max |err| <= tol max |JAX|):
- ``triangles_to_edges``: equal, with and without padded faces.
- ``build_cylinder_graph``: equal node features and edges, edge features
  1e-6; ``GraphProcessor`` forward 1e-5, its weight gradients 1e-5.
- Padded nodes and edges change nothing at the valid nodes (1e-6).
- ``MeshGraphNetRoutine``'s train step (the gradients clipped by global norm
  0.1, then by value, AdamW): loss, gradients and parameters after the step
  1e-5; the 50-step ``valid_step`` (the rollout feeds its own predictions
  back 50 times): 1e-5.
- ``convert cylinder-flow`` on synthetic TFRecords with meshes of two
  sizes: h5py reads the port's file and finds the JAX converter's arrays
  (NaN and -1 padding included), and the port's ``CylinderFlowBuilder``
  reads the JAX converter's file (written by h5py) and gives the JAX
  builder's batches.
"""

import json
import struct

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourierflow_tpu.builders import CylinderFlowBuilder as JaxBuilder
from fourierflow_tpu.commands.convert import cylinder_flow as jax_convert
from fourierflow_tpu.models import meshgraphnet as jax_mgn
from fourierflow_tpu.routines import MeshGraphNetRoutine as JaxRoutine
from fourierflow_tpu.routines.base import make_optimizer as jax_make_optimizer
from fourierflow_tpu_torch.builders import CylinderFlowBuilder
from fourierflow_tpu_torch.commands.__main__ import main as cli
from fourierflow_tpu_torch.commands.convert import parse_example, read_tfrecord
from fourierflow_tpu_torch.models import meshgraphnet as mgn
from fourierflow_tpu_torch.routines import MeshGraphNetRoutine
from fourierflow_tpu_torch.routines.base import make_optimizer
from fourierflow_tpu_torch.utils.weights import meshgraphnet_state_dict_from_flax

LATENT, LAYERS = 16, 2


def _np(a):
    return np.asarray(a.detach()) if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_rel(got, want, tol, what=""):
    """max |got - want| <= tol max |want| (NaN where JAX has NaN)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    got, want = np.nan_to_num(got), np.nan_to_num(want)
    err = np.max(np.abs(got.astype(np.float64) - want)) if want.size else 0.0
    scale = max(np.max(np.abs(want)), 1e-30) if want.size else 1.0
    assert err <= tol * scale, f"{what}: max |err| {err:.3e} > {tol:g} x {scale:.3e}"


# --- synthetic meshes and TFRecords ---------------------------------------------------
def _mesh(rng, n_nodes, n_cells):
    """A mesh with ``n_cells`` triangles over ``n_nodes`` nodes (every node
    in some triangle)."""
    cells = np.stack([rng.permutation(n_nodes)[:3] for _ in range(n_cells)]).astype(np.int32)
    cells[: n_nodes // 3] = np.arange(n_nodes // 3 * 3).reshape(-1, 3)
    return cells


def _padded_batch(seed=0, t_len=None):
    """Two padded samples (7 and 9 nodes of 9; 5 and 7 cells of 7): NaN
    node arrays and -1 cells/types where padded; with ``t_len`` the
    velocities have a time axis."""
    rng = np.random.RandomState(seed)
    n_max, c_max = 9, 7
    batch = {"cells": np.full((2, c_max, 3), -1, np.int32),
             "mesh_pos": np.full((2, n_max, 2), np.nan, np.float32),
             "node_type": np.full((2, n_max), -1, np.int32)}
    shape = (2, n_max, 2) if t_len is None else (2, t_len, n_max, 2)
    batch["velocity"] = np.full(shape, np.nan, np.float32)
    batch["target_velocity"] = np.full(shape, np.nan, np.float32)
    for i, (n, c) in enumerate(((7, 5), (9, 7))):
        batch["cells"][i, :c] = _mesh(rng, n, c)
        batch["mesh_pos"][i, :n] = rng.rand(n, 2)
        batch["node_type"][i, :n] = rng.randint(0, 7, n)
        vel = rng.randn(*(shape[1:-2] + (n, 2))).astype(np.float32)
        batch["velocity"][i, ..., :n, :] = vel
        batch["target_velocity"][i, ..., :n, :] = vel + 0.1 * rng.randn(*vel.shape)
    return batch


def _varint(n):
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _field(num, payload):
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _example(features):
    entries = b""
    for name, values in features.items():
        feature = _field(1, b"".join(_field(1, v) for v in values))
        entries += _field(1, _field(1, name.encode()) + _field(2, feature))
    return _field(1, entries)


def _write_dataset(d, t_len=6):
    """meta.json and three splits of two trajectories, meshes of 8 and 6
    nodes (6 and 4 cells), as DeepMind's cylinder_flow lays them out."""
    rng = np.random.RandomState(1)
    meta = {"trajectory_length": t_len,
            "field_names": ["cells", "mesh_pos", "node_type", "velocity", "pressure"],
            "features": {
                "cells": {"dtype": "int32", "shape": [1, -1, 3], "type": "static"},
                "mesh_pos": {"dtype": "float32", "shape": [1, -1, 2], "type": "static"},
                "node_type": {"dtype": "int32", "shape": [1, -1, 1], "type": "static"},
                "velocity": {"dtype": "float32", "shape": [t_len, -1, 2], "type": "dynamic"},
                "pressure": {"dtype": "float32", "shape": [t_len, -1, 1], "type": "dynamic"}}}
    (d / "meta.json").write_text(json.dumps(meta))
    for split in ("train", "valid", "test"):
        with open(d / f"{split}.tfrecord", "wb") as f:
            for n, c in ((8, 6), (6, 4)):
                p = _example({
                    "cells": [_mesh(rng, n, c)[None].tobytes()],
                    "mesh_pos": [rng.rand(1, n, 2).astype(np.float32).tobytes()],
                    "node_type": [rng.randint(0, 7, (1, n, 1)).astype(np.int32).tobytes()],
                    "velocity": [rng.randn(t_len, n, 2).astype(np.float32).tobytes()],
                    "pressure": [rng.randn(t_len, n, 1).astype(np.float32).tobytes()]})
                f.write(struct.pack("<Q", len(p)) + b"\0" * 4 + p + b"\0" * 4)


# --- graphs ---------------------------------------------------------------------------
@pytest.mark.parametrize("padded", [False, True])
def test_triangles_to_edges_equals_jax(padded):
    rng = np.random.RandomState(3)
    faces = rng.randint(0, 10, (12, 3)).astype(np.int32)
    faces[5] = faces[2]  # shared edges collapse
    if padded:
        faces[-3:] = -1
    s, r = mgn.triangles_to_edges(torch.from_numpy(faces))
    js, jr = jax_mgn.triangles_to_edges(jnp.asarray(faces))
    np.testing.assert_array_equal(_np(s), np.asarray(js))
    np.testing.assert_array_equal(_np(r), np.asarray(jr))
    assert s.shape == (72,) and ((_np(s) == -1) == (_np(r) == -1)).all()
    assert (_np(s)[:36] == -1)[0] == padded  # the (-1, -1) row of padded faces sorts first


def test_build_cylinder_graph_equals_jax():
    b = _padded_batch()
    got = mgn.build_cylinder_graph(*(torch.from_numpy(b[k]) for k in (
        "velocity", "node_type", "mesh_pos", "cells")))
    want = jax.vmap(jax_mgn.build_cylinder_graph)(*(jnp.asarray(b[k]) for k in (
        "velocity", "node_type", "mesh_pos", "cells")))
    np.testing.assert_array_equal(_np(got[0]), np.asarray(want[0]))
    assert_rel(got[1], want[1], 1e-6, "edge features")
    for a, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(_np(a), np.asarray(w))


@pytest.fixture(scope="module")
def processors():
    """JAX's and the port's GraphProcessor with the same weights."""
    b = _padded_batch()
    graph = jax.vmap(jax_mgn.build_cylinder_graph)(*(jnp.asarray(b[k]) for k in (
        "velocity", "node_type", "mesh_pos", "cells")))
    jmodel = jax_mgn.GraphProcessor(n_layers=LAYERS, latent_size=LATENT)
    params = jmodel.init(jax.random.PRNGKey(0), *(g[0] for g in graph))
    model = mgn.GraphProcessor(n_layers=LAYERS, latent_size=LATENT)
    model.load_state_dict(meshgraphnet_state_dict_from_flax(jax.tree.map(np.asarray, params)))
    return jmodel, params, model, graph


def test_graph_processor_matches_jax(processors):
    jmodel, params, model, graph = processors
    cot = np.random.RandomState(4).randn(2, 9, 2).astype(np.float32)

    def jloss(p):
        out = jax.vmap(lambda *g: jmodel.apply(p, *g))(*graph)
        return (out * cot).sum(), out

    (_, want), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    tgraph = [torch.from_numpy(np.array(g)) for g in graph]
    out = model(*tgraph)
    assert_rel(out, want, 1e-5, "forward")
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), list(model.parameters()))
    want_g = meshgraphnet_state_dict_from_flax(jax.tree.map(np.asarray, jg))
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(want_g)
    for name, g in zip(names, grads):
        assert_rel(g, want_g[name], 1e-5, name)
    assert abs(model.node_encoder.norm.eps - 1e-6) == 0


def test_padding_contributes_nothing(processors):
    """The second sample alone, unpadded, and inside a batch padded with
    extra nodes and -1 cells: the same outputs at its nodes."""
    _, _, model, _ = processors
    b = _padded_batch()
    small = {k: v[:1, :7] if k in ("velocity", "mesh_pos", "node_type") else v[:1, :5]
             for k, v in b.items() if k != "target_velocity"}
    graph = lambda d: mgn.build_cylinder_graph(*(torch.from_numpy(d[k]) for k in (
        "velocity", "node_type", "mesh_pos", "cells")))
    with torch.no_grad():
        alone = model(*graph(small))
        padded = model(*graph(b))
    assert_rel(padded[0, :7], alone[0], 1e-6)


def _index_add_forward(model, nodes, edges, senders, receivers):
    """``GraphProcessor.forward`` with the scatter and gathers of before the
    segment sum: ``index_select`` from, and ``index_add_`` into, the
    flattened nodes, an unused edge's index clamped to node 0."""
    def flat_index(index, n):
        return (index.clamp(min=0) + torch.arange(index.shape[0])[:, None] * n).reshape(-1)

    edge_mask = (senders >= 0).to(nodes.dtype)
    h_nodes = model.node_encoder(nodes)
    h_edges = model.edge_encoder(edges) * edge_mask[..., None]
    for layer in model.graph_layers:
        b, n, f = h_nodes.shape
        flat = h_nodes.reshape(b * n, f)
        r_idx = flat_index(receivers, n)
        s_feats = flat.index_select(0, flat_index(senders, n)).reshape(b, -1, f)
        r_feats = flat.index_select(0, r_idx).reshape(b, -1, f)
        new_edges = layer.edge_updater(torch.cat([s_feats, r_feats, h_edges], -1))
        new_edges = new_edges * edge_mask[..., None]
        agg = torch.zeros_like(flat).index_add_(0, r_idx, new_edges.reshape(-1, f))
        h_nodes = h_nodes + layer.node_updater(torch.cat([flat, agg], -1)).reshape(b, n, f)
        h_edges = h_edges + new_edges
    return model.decoder(h_nodes)


@pytest.mark.parametrize("seed", [0, 1])
def test_segment_sum_block_equals_index_add_to_the_bit(seed):
    """The message passing through the segment sum's autograd Functions
    (the scatter, and the gathers whose gradients are segment sums, unused
    edges in no segment) against the ``index_add_`` / ``index_select`` path
    on the padded batch: the output, every parameter's gradient and the
    inputs' gradients equal to the bit."""
    b = _padded_batch(seed=seed)
    graph = mgn.build_cylinder_graph(*(torch.from_numpy(b[k]) for k in (
        "velocity", "node_type", "mesh_pos", "cells")))
    model = mgn.GraphProcessor(n_layers=LAYERS, latent_size=LATENT)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    cot = torch.from_numpy(np.random.RandomState(seed).randn(2, 9, 2).astype(np.float32))
    results = []
    for forward in (lambda *g: model(*g), lambda *g: _index_add_forward(model, *g)):
        nodes, edges = (graph[i].clone().requires_grad_() for i in (0, 1))
        out = forward(nodes, edges, *graph[2:])
        grads = torch.autograd.grad((out * cot).sum(), [nodes, edges, *model.parameters()])
        results.append((out, *grads))
    assert (graph[2] < 0).any()  # unused edge slots are in play
    for got, want in zip(*results, strict=True):
        assert torch.equal(got.detach().view(torch.int32), want.detach().view(torch.int32))


# --- the routine ----------------------------------------------------------------------
def _routines(rollout_steps=50):
    kw = dict(n_layers=LAYERS, latent_size=LATENT, clip_val=0.1, rollout_steps=rollout_steps)
    jr = JaxRoutine(optimizer=jax_make_optimizer(lr=1e-3, weight_decay=1e-4, clip_val=0.1), **kw)
    pr = MeshGraphNetRoutine(optimizer=make_optimizer(lr=1e-3, weight_decay=1e-4, clip_val=0.1),
                             **kw)
    b = _padded_batch()
    js = jr.init(jax.random.PRNGKey(0), b)
    ps = pr.init(0, b, "cpu")
    ps.model.load_state_dict(meshgraphnet_state_dict_from_flax(jax.tree.map(np.asarray,
                                                                            js.params)))
    return jr, js, pr, ps


def test_train_step_matches_jax():
    jr, js, pr, ps = _routines()
    batch = _padded_batch(seed=5)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, jg = jax.value_and_grad(jr._loss)(js.params, jbatch)
    norm = float(np.sqrt(sum((np.asarray(g) ** 2).sum() for g in jax.tree.leaves(jg))))
    assert norm > 0.1  # the global-norm clip acts
    js2, jm = jr.train_step(js, jbatch)
    loss, grads = pr.loss_and_grads(ps, batch)
    assert_rel(loss, want_loss, 1e-5, "loss")
    want_g = meshgraphnet_state_dict_from_flax(jax.tree.map(lambda g: np.asarray(g) * 0.1 / (
        norm + 1e-9), jg))
    for name, g in zip([n for n, _ in ps.model.named_parameters()], grads):
        assert_rel(g, want_g[name], 1e-5, f"grad {name}")
    ps2, pm = pr.train_step(ps, batch)
    assert_rel(pm["train_loss"], jm["train_loss"], 1e-5, "train_loss")
    want_p = meshgraphnet_state_dict_from_flax(jax.tree.map(np.asarray, js2.params))
    for name, p in ps2.model.named_parameters():
        assert_rel(p, want_p[name], 1e-5, f"param {name}")


def test_valid_step_rollout_matches_jax():
    jr, js, pr, ps = _routines(rollout_steps=50)
    batch = _padded_batch(seed=6, t_len=52)
    want = jr.valid_step(js, {k: jnp.asarray(v) for k, v in batch.items()})
    got = pr.valid_step(ps, batch)
    assert sorted(got) == sorted(want) == ["loss", "weight"]
    assert_rel(got["loss"], want["loss"], 1e-5, "loss")
    assert float(got["weight"]) == 2.0


# --- conversion and the builder -------------------------------------------------------
@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    d = tmp_path_factory.mktemp("cylinder_flow")
    _write_dataset(d)
    jax_convert(str(d), str(d / "jax.h5"))
    cli(["convert", "cylinder-flow", "--data-dir", str(d), "--out", str(d / "port.h5")])
    return d


def test_tfrecord_examples_parse_as_in_jax(converted):
    from fourierflow_tpu.commands.convert import parse_example as jax_parse
    from fourierflow_tpu.commands.convert import read_tfrecord as jax_read

    for got, want in zip(read_tfrecord(converted / "train.tfrecord"),
                         jax_read(converted / "train.tfrecord"), strict=True):
        assert parse_example(got) == jax_parse(want)


def test_converted_file_equals_the_jax_converters(converted):
    with h5py.File(converted / "jax.h5", "r") as jf, h5py.File(converted / "port.h5", "r") as pf:
        assert sorted(pf) == sorted(jf) == ["test", "train", "valid"]
        for split in jf:
            assert sorted(pf[split]) == sorted(jf[split])
            for key in jf[split]:
                a, b = pf[split][key][...], jf[split][key][...]
                assert a.dtype == b.dtype and a.shape == b.shape, (split, key)
                np.testing.assert_array_equal(a, b)
        assert pf["train/velocity"].shape == (2, 4, 8, 2)
        assert np.isnan(pf["train/velocity"][1, :, 6:]).all()
        assert (pf["train/cells"][1, 4:] == -1).all() and (pf["train/node_type"][1, 6:] == -1).all()


@pytest.mark.parametrize("which", ["jax.h5", "port.h5"])
def test_builder_batches_equal_the_jax_builders(converted, which):
    pb = CylinderFlowBuilder(str(converted / which), batch_size=3)
    jb = JaxBuilder(str(converted / which), batch_size=3)
    assert pb.batches_per_epoch == jb.batches_per_epoch == 3  # 2 trajectories x 4 steps
    for got, want in zip(pb.train_batches(np.random.default_rng(2)),
                         jb.train_batches(np.random.default_rng(2)), strict=True):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    for got, want in zip(pb.val_batches(), jb.val_batches(), strict=True):
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
    sample = pb.sample_batch()
    assert sample["velocity"].shape == (3, 8, 2) and sample["cells"].shape == (3, 6, 3)
    assert next(pb.test_batches())["velocity"].shape == (2, 4, 8, 2)
