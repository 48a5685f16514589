"""MeshGraphNets (Pfaff et al. 2021): encode-process-decode message passing
on triangular meshes, the counterpart of
``fourierflow_tpu/models/meshgraphnet.py``.

Meshes are padded to a fixed node and cell count (cells with -1 rows,
node arrays with NaN, as ``commands/convert.py`` writes them).
``triangles_to_edges`` gives ``6 * n_faces`` directed edges with -1 for the
unused ones, as the JAX package's ``jnp.unique(..., size=...)`` does; a
padded edge gathers from node 0 and is masked to zero, so it adds nothing to
the scatter. NaN padding of the inputs is zeroed in ``build_cylinder_graph``.

The scatter of the edge messages onto their receivers, and the gradients
of the two gathers of node features onto the edges, are segment sums
(``ops/segment.py``: the kernel of ``csrc/segment_sum.cu`` on the card),
each node's edges summed in ascending edge order, as the CPU's
``index_add_`` into zeros sums them. So a step has no atomics in either
direction: it repeats to the bit on the card, and equals the ``index_add_``
/ ``index_select`` step to the bit on the CPU. An unused edge belongs to no
node in those sums: its message is masked to zero, and so is its gradient,
so leaving it out changes no bit (adding a zero to a sum that starts at +0
changes nothing).

Graphs are batched: nodes ``[B, N, F]``, edges ``[B, E, F]`` and
``senders``/``receivers`` ``[B, E]``.
"""

import enum
import math
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn as nn

from ..ops.segment import segment_csr, segment_sum

__all__ = ["NodeType", "triangles_to_edges", "MLPBlock", "Incidence", "incidence",
           "GraphNetBlock", "GraphProcessor", "build_cylinder_graph"]

# flax's lecun_normal: variance 1/fan_in from a normal truncated at +-2, whose
# standard deviation this constant is (jax.nn.initializers.variance_scaling).
_TRUNC_STD = 0.87962566103423978
LAYER_NORM_EPS = 1e-6  # flax's nn.LayerNorm (haiku's is 1e-5)
NODE_FEATURES = 2 + 9  # the velocity and the one-hot node type
EDGE_FEATURES = 3  # the relative position and its norm


class NodeType(enum.IntEnum):
    """The node categories of the DeepMind meshes."""

    NORMAL = 0
    OBSTACLE = 1
    AIRFOIL = 2
    HANDLE = 3
    INFLOW = 4
    OUTFLOW = 5
    WALL_BOUNDARY = 6
    SIZE = 9


def triangles_to_edges(faces: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two-way unique edges of the triangles ``faces [n_faces, 3]``
    (int, -1 rows unused): ``(senders, receivers)``, each ``[6 n_faces]``.
    Each undirected edge is taken as (larger, smaller) index, the unique
    ones sorted row by row (a padded face gives the row (-1, -1), which
    sorts first) and padded with -1 to ``3 n_faces``; then the same edges
    reversed. -1 marks an unused edge on both sides."""
    edges = torch.cat([faces[:, 0:2], faces[:, 1:3], torch.stack([faces[:, 2], faces[:, 0]], 1)])
    pairs = torch.stack([edges.max(dim=1).values, edges.min(dim=1).values], 1)
    unique = torch.unique(pairs, dim=0)
    pad = unique.new_full((edges.shape[0] - unique.shape[0], 2), -1)
    unique = torch.cat([unique, pad])
    s, r = unique[:, 0], unique[:, 1]
    return torch.cat([s, r]), torch.cat([r, s])


def _dense_init(lin: nn.Linear, generator=None) -> None:
    """flax ``nn.Dense``'s default: LeCun normal weight, zero bias."""
    std = math.sqrt(1.0 / lin.in_features) / _TRUNC_STD
    nn.init.trunc_normal_(lin.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    lin.bias.zero_()


class MLPBlock(nn.Module):
    """Linear layers with ReLU between them (``linear.{i}``), then a
    LayerNorm (``norm``, epsilon 1e-6) unless ``layer_norm`` is false."""

    def __init__(self, in_features: int, output_sizes: Sequence[int], layer_norm: bool = True):
        super().__init__()
        sizes = [in_features] + list(output_sizes)
        self.linear = nn.ModuleList(nn.Linear(a, b) for a, b in zip(sizes[:-1], sizes[1:]))
        self.norm = nn.LayerNorm(sizes[-1], eps=LAYER_NORM_EPS) if layer_norm else None

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            for lin in self.linear:
                _dense_init(lin, generator)
            if self.norm is not None:
                self.norm.reset_parameters()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, lin in enumerate(self.linear):
            x = lin(x)
            if i < len(self.linear) - 1:
                x = torch.relu(x)
        return self.norm(x) if self.norm is not None else x


class Incidence(NamedTuple):
    """One end of every edge as rows of the ``[B * N]`` flattened nodes:
    ``rows`` to gather from (an unused edge reads row 0), and ``index`` (-1
    on an unused edge) with its ``order`` and ``offsets`` (``segment_csr``)
    to sum over."""

    rows: torch.Tensor
    index: torch.Tensor
    order: torch.Tensor
    offsets: torch.Tensor


def incidence(index: torch.Tensor, n_nodes: int) -> Incidence:
    """The :class:`Incidence` of ``[B, E]`` node indices (-1 unused) of a
    batch of ``n_nodes``-node graphs, sorted once for every layer."""
    b = index.shape[0]
    offsets = torch.arange(b, device=index.device)[:, None] * n_nodes
    flat = torch.where(index >= 0, index + offsets, -1).reshape(-1)
    return Incidence(flat.clamp(min=0), flat, *segment_csr(flat, b * n_nodes))


class _Gather(torch.autograd.Function):
    """``x[inc.rows]``; its gradient is the segment sum over ``inc``."""

    @staticmethod
    def forward(ctx, x, inc):
        ctx.inc = inc
        return x.index_select(0, inc.rows)

    @staticmethod
    def backward(ctx, g):
        return segment_sum(g.contiguous(), *ctx.inc[1:]), None


class _Scatter(torch.autograd.Function):
    """The sum of the edges' ``values`` onto their nodes of ``inc`` (the
    segment sum); its gradient is the gather."""

    @staticmethod
    def forward(ctx, values, inc):
        ctx.inc = inc
        return segment_sum(values, *inc[1:])

    @staticmethod
    def backward(ctx, g):
        return g.index_select(0, ctx.inc.rows), None


class GraphNetBlock(nn.Module):
    """One message-passing step with residuals: each edge updated from its
    two end nodes and itself (masked to zero where unused), each node from
    itself and the sum of its incoming edges. ``senders`` and ``receivers``
    are :func:`incidence`s."""

    def __init__(self, latent_size: int = 128):
        super().__init__()
        self.edge_updater = MLPBlock(3 * latent_size, [latent_size] * 2)
        self.node_updater = MLPBlock(2 * latent_size, [latent_size] * 2)

    def reset_parameters(self, generator=None) -> None:
        self.edge_updater.reset_parameters(generator)
        self.node_updater.reset_parameters(generator)

    def forward(self, nodes, edges, senders: Incidence, receivers: Incidence, edge_mask):
        b, n, f = nodes.shape
        flat = nodes.reshape(b * n, f)
        sender_feats = _Gather.apply(flat, senders).reshape(b, -1, f)
        receiver_feats = _Gather.apply(flat, receivers).reshape(b, -1, f)
        new_edges = self.edge_updater(torch.cat([sender_feats, receiver_feats, edges], -1))
        new_edges = new_edges * edge_mask[..., None]
        agg = _Scatter.apply(new_edges.reshape(-1, f), receivers)
        new_nodes = self.node_updater(torch.cat([flat, agg], -1)).reshape(b, n, f)
        return nodes + new_nodes, edges + new_edges


class GraphProcessor(nn.Module):
    """Encode-process-decode: node and edge MLP encoders, ``n_layers``
    message-passing blocks, and a decoder without LayerNorm to
    ``output_dim``. ``forward(nodes [B, N, 11], edges [B, E, 3], senders,
    receivers [B, E]) -> [B, N, output_dim]``."""

    def __init__(self, n_layers: int = 15, latent_size: int = 128, output_dim: int = 2,
                 node_features: int = NODE_FEATURES, edge_features: int = EDGE_FEATURES):
        super().__init__()
        self.node_encoder = MLPBlock(node_features, [latent_size] * 2)
        self.edge_encoder = MLPBlock(edge_features, [latent_size] * 2)
        self.graph_layers = nn.ModuleList(GraphNetBlock(latent_size) for _ in range(n_layers))
        self.decoder = MLPBlock(latent_size, [latent_size, output_dim], layer_norm=False)

    def reset_parameters(self, generator=None) -> None:
        """flax's defaults: LeCun normal Dense kernels, zero biases, unit
        LayerNorm scales."""
        for m in (self.node_encoder, self.edge_encoder, *self.graph_layers, self.decoder):
            m.reset_parameters(generator)

    def forward(self, nodes, edges, senders, receivers):
        edge_mask = (senders >= 0).to(nodes.dtype)
        send, recv = (incidence(i, nodes.shape[1]) for i in (senders, receivers))
        h_nodes = self.node_encoder(nodes)
        h_edges = self.edge_encoder(edges) * edge_mask[..., None]
        for layer in self.graph_layers:
            h_nodes, h_edges = layer(h_nodes, h_edges, send, recv, edge_mask)
        return self.decoder(h_nodes)


def cylinder_edges(mesh_pos: torch.Tensor, cells: torch.Tensor):
    """The edges of a batch of padded meshes: ``(edge_feats [B, E, 3],
    senders, receivers [B, E])``, the relative position of each edge's
    sender to its receiver and its norm (0 on unused edges; NaN positions
    read as 0)."""
    senders, receivers = (torch.stack(a) for a in zip(*(triangles_to_edges(c) for c in cells)))
    pos = torch.nan_to_num(mesh_pos)
    take = lambda idx: torch.gather(pos, 1, idx.clamp(min=0)[..., None].expand(-1, -1, 2))
    rel = take(senders) - take(receivers)
    edge_feats = torch.cat([rel, torch.linalg.vector_norm(rel, dim=-1, keepdim=True)], -1)
    return edge_feats * (senders >= 0).to(edge_feats.dtype)[..., None], senders, receivers


def cylinder_nodes(velocity: torch.Tensor, node_type: torch.Tensor) -> torch.Tensor:
    """The node features ``[B, N, 11]``: the velocity (NaN read as 0) and the
    one-hot node type (all zeros for a padded node, type -1)."""
    one_hot = (node_type[..., None] == torch.arange(int(NodeType.SIZE), device=node_type.device))
    return torch.cat([torch.nan_to_num(velocity), one_hot.to(velocity.dtype)], -1)


def build_cylinder_graph(velocity, node_type, mesh_pos, cells):
    """The graph of a batch of cylinder-flow samples: ``(node_feats [B, N,
    11], edge_feats [B, E, 3], senders, receivers [B, E])``."""
    return (cylinder_nodes(velocity, node_type), *cylinder_edges(mesh_pos, cells))
