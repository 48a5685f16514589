"""Shared layers and small functional ops (counterpart of
``fourierflow_tpu/layers.py``).

Parameter names follow the reference's torch modules, so a port
``state_dict`` reads straight into the JAX package's converter
(``fourierflow_tpu/utils/torch_import.py``): a weight-normed linear layer
holds ``weight_g [out, 1]``, ``weight_v [out, in]`` and ``bias``.
Initialisation takes an explicit ``torch.Generator``.
"""

import math
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .ops.fused_ff import fused_ff
from .parallel.collectives import copy_to, on_first_rank, reduce_from, scatter

__all__ = [
    "torch_linear_kernel_init",
    "xavier_normal_init",
    "row_norms",
    "WNLinear",
    "FeedForward",
    "fourier_encode",
    "encode_positions",
    "lp_loss_rel",
    "NormalizerState",
    "normalizer_init",
    "normalizer_accumulate",
    "normalizer_apply",
    "normalizer_inverse",
]


def torch_linear_kernel_init(weight: torch.Tensor, fan_in: int, generator=None) -> None:
    """torch.nn.Linear's default init, U(-1/sqrt(fan_in), 1/sqrt(fan_in)), in place."""
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        weight.uniform_(-bound, bound, generator=generator)


def xavier_normal_init(weight: torch.Tensor, gain: float = 1.0, generator=None) -> None:
    """torch.nn.init.xavier_normal_ for weights whose first two dims are
    (fan_in, fan_out), the rest a receptive field; in place."""
    receptive = math.prod(weight.shape[2:])
    std = gain * math.sqrt(2.0 / ((weight.shape[0] + weight.shape[1]) * receptive))
    with torch.no_grad():
        weight.normal_(0.0, std, generator=generator)


def row_norms(squares: torch.Tensor) -> torch.Tensor:
    """``||v||`` of each row from its sum of squares ``[out, 1]``, kept from
    0 (the weight norm's denominator). Every path takes the norm so, the
    tensor-parallel one with the squares summed over the ranks first, so
    that on one rank it is the unsplit layer's to the bit."""
    return torch.clamp(torch.sqrt(squares), min=1e-12)


class WNLinear(nn.Module):
    """Linear layer with optional weight normalisation, ``w = g * v / ||v||``
    with per-output-row norms (torch ``weight_norm`` with dim 0); ``g``
    starts at ``||v||``. ``dtype`` is the compute type (parameters stay
    float32): x, weight and bias are cast to it."""

    def __init__(self, in_features: int, out_features: int, wnorm: bool = False,
                 use_bias: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.wnorm = wnorm
        self.dtype = dtype
        shape = (out_features, in_features)
        if wnorm:
            self.weight_g = nn.Parameter(torch.empty(out_features, 1))
            self.weight_v = nn.Parameter(torch.empty(shape))
        else:
            self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.empty(out_features)) if use_bias else None

    def reset_parameters(self, generator=None) -> None:
        v = self.weight_v if self.wnorm else self.weight
        torch_linear_kernel_init(v, self.in_features, generator)
        with torch.no_grad():
            if self.wnorm:
                self.weight_g.copy_(torch.linalg.vector_norm(v, dim=1, keepdim=True))
            if self.bias is not None:
                bound = 1.0 / math.sqrt(self.in_features)
                self.bias.uniform_(-bound, bound, generator=generator)

    def dense(self):
        """The effective ``(weight [out, in], bias)`` in the compute type,
        weight norm folded in."""
        if self.wnorm:
            v = self.weight_v
            w = self.weight_g * v / row_norms(v.square().sum(dim=1, keepdim=True))
        else:
            w = self.weight
        b = self.bias
        if self.dtype is not None:
            w = w.to(self.dtype)
            b = None if b is None else b.to(self.dtype)
        return w, b

    def forward(self, x):
        w, b = self.dense()
        if self.dtype is not None:
            x = x.to(self.dtype)
        return F.linear(x, w, b)


class FeedForward(nn.Module):
    """n-layer MLP with expansion ``factor`` and ReLU between layers,
    optional dropout and a LayerNorm on the last layer. Layer ``j`` is
    ``layers[j][0]`` (the reference's Sequential naming). The plain 2-layer
    shape goes through ``ops.fused_ff`` (the CUDA kernel on a CUDA tensor).

    With ``tensor_parallel`` (an ``Axis`` of the ``model`` mesh axis, set by
    the block's ``set_parallel``) and its weights split by
    ``parallel.shard_state`` (the expansion's ``weight_v`` by output row,
    the contraction's by input column), each rank runs ``relu(x W1[:, h] +
    b1[h]) W2[h, :]`` on its hidden slice ``h`` (``_tp_forward``)."""

    tensor_parallel = None

    def __init__(self, dim: int, factor: int, ff_weight_norm: bool = False, n_layers: int = 2,
                 layer_norm: bool = False, dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_layers, self.layer_norm, self.dropout, self.dtype = n_layers, layer_norm, dropout, dtype
        self.layers = nn.ModuleList()
        for i in range(n_layers):
            in_dim = dim if i == 0 else dim * factor
            out_dim = dim if i == n_layers - 1 else dim * factor
            self.layers.append(nn.Sequential(WNLinear(in_dim, out_dim, wnorm=ff_weight_norm,
                                                      dtype=dtype)))
        self.norm = nn.LayerNorm(dim) if layer_norm else None

    @property
    def fusable(self) -> bool:
        return self.n_layers == 2 and self.dropout == 0.0 and not self.layer_norm

    def reset_parameters(self, generator=None) -> None:
        for seq in self.layers:
            seq[0].reset_parameters(generator)
        if self.norm is not None:
            self.norm.reset_parameters()

    @property
    def split(self) -> bool:
        """Whether ``parallel.shard_state`` split the weights over the hidden dim."""
        lin = self.layers[0][0]
        return getattr(lin.weight_v if lin.wnorm else lin.weight, "tp_dim", None) is not None

    def _tp_forward(self, x):
        """The feed-forward on this rank's hidden slice, summed over the
        ``model`` axis: the expansion's weight-norm gain and bias (replicated)
        sliced to the rank's rows, its row norms local; the contraction's
        squared row norms summed over the axis before ``g * v / ||v||``; its
        bias added on the axis's rank 0 only; x's gradient summed over the
        axis. The JAX package's GSPMD makes the same cut of
        ``fourierflow_tpu/layers.py``'s FeedForward."""
        tp = self.tensor_parallel
        l1, l2 = self.layers[0][0], self.layers[1][0]
        if l1.wnorm:
            v1 = l1.weight_v  # this rank's rows: their norms are whole
            norm = row_norms(v1.square().sum(dim=1, keepdim=True))
            w1 = scatter(l1.weight_g, tp, 0) * v1 / norm
        else:
            w1 = l1.weight
        b1 = scatter(l1.bias, tp, 0)
        if l2.wnorm:
            # The norm and the gain are replicated and used by every rank's
            # block: their gradients are summed over the axis (copy_to).
            v2 = l2.weight_v
            norm = row_norms(reduce_from(v2.square().sum(dim=1, keepdim=True), tp))
            w2 = copy_to(l2.weight_g, tp) * v2 / copy_to(norm, tp)
        else:
            w2 = l2.weight
        b2 = on_first_rank(l2.bias, tp)
        if self.dtype is not None:
            w1, b1, w2, b2 = (t.to(self.dtype) for t in (w1, b1, w2, b2))
            x = x.to(self.dtype)
        out = fused_ff(copy_to(x, tp).contiguous(), w1.t(), b1, w2.t(), b2)
        return reduce_from(out, tp)

    def forward(self, x):
        if self.tensor_parallel is not None and self.split:
            if not self.fusable or self.layers[0][0].bias is None:
                raise NotImplementedError("a tensor-parallel FeedForward is the fused 2-layer "
                                          "shape with biases (no dropout or LayerNorm)")
            return self._tp_forward(x)
        if self.fusable:
            w1, b1 = self.layers[0][0].dense()
            w2, b2 = self.layers[1][0].dense()
            if self.dtype is not None:
                x = x.to(self.dtype)
            return fused_ff(x.contiguous(), w1.t(), b1, w2.t(), b2)
        for i, seq in enumerate(self.layers):
            x = seq(x)
            if self.dropout > 0.0:
                x = F.dropout(x, self.dropout, self.training)
            if i < self.n_layers - 1:
                x = torch.relu(x)
        if self.norm is not None:
            x = self.norm(x)
        return x


def fourier_encode(x: torch.Tensor, max_freq: float, num_bands: int = 4, base: float = 2.0):
    """Perceiver-style encoding: sin/cos at log-spaced scales, raw coordinate appended."""
    orig = x[..., None]
    scales = torch.logspace(0.0, math.log(max_freq / 2) / math.log(base), num_bands,
                            base=base, dtype=x.dtype, device=x.device)
    xs = orig * scales * math.pi
    return torch.cat([torch.sin(xs), torch.cos(xs), orig], dim=-1)


def _linspace(low: float, high: float, n: int, dtype, device) -> torch.Tensor:
    """``n`` points from ``low`` to ``high``, as the JAX package's
    ``jnp.linspace`` computes them on the CPU (XLA folds ``high / (n - 1)``
    and fuses the sum): in float32, ``t = i * (1 / (n - 1))`` and point
    ``i * (high / (n - 1)) + low * (1 - t)`` with one rounding, the last
    point ``high``: the same bits for up to 256 points (a 1,024-point
    linspace of XLA's differs by an ulp in places). ``torch.linspace`` sums
    from both ends and differs by an ulp."""
    f32 = np.float32
    if n == 1:
        return torch.full((1,), low, dtype=dtype, device=device)
    i = np.arange(n - 1, dtype=f32)
    r = f32(1) / f32(n - 1)
    rest = f32(low) * (f32(1) - i * r)
    # The float64 sum of the exact product and ``rest`` rounds once, as a fused multiply-add.
    out = (i.astype(np.float64) * np.float64(r * f32(high)) + rest).astype(f32)
    return torch.from_numpy(np.append(out, f32(high))).to(device=device, dtype=dtype)


def encode_positions(dim_sizes, low: float = -1.0, high: float = 1.0, fourier: bool = False,
                     max_freq: Optional[float] = None, num_bands: int = 8, base: float = 2.0,
                     dtype=torch.float32, device=None, exact: bool = False):
    """Meshgrid of linspace positions ``[*dim_sizes, len(dim_sizes)]``,
    optionally Fourier-encoded. With ``exact`` the points are the JAX
    package's (``_linspace``), else ``torch.linspace``'s."""
    if exact:
        grids = [_linspace(low, high, s, dtype, device) for s in dim_sizes]
    else:
        grids = [torch.linspace(low, high, s, dtype=dtype, device=device) for s in dim_sizes]
    pos = torch.stack(torch.meshgrid(*grids, indexing="ij"), dim=-1)
    if not fourier:
        return pos
    feats = fourier_encode(pos, max_freq, num_bands, base=base)
    return feats.reshape(*feats.shape[:-2], -1)


def lp_loss_rel(x: torch.Tensor, y: torch.Tensor, p: int = 2, reduce_mean: bool = True):
    """Relative Lp loss (N-MSE), the headline metric. For p 2 each norm is
    the square root of a sum of squares, as the spatially split loss
    (``routines/grid_2d_markov.py``) takes it across ranks."""
    b = x.shape[0]
    d, t = (x - y).reshape(b, -1), y.reshape(b, -1)
    if p == 2:
        r = torch.sqrt(d.square().sum(dim=1)) / torch.sqrt(t.square().sum(dim=1))
    else:
        r = torch.linalg.vector_norm(d, ord=p, dim=1) / torch.linalg.vector_norm(t, ord=p, dim=1)
    return r.mean() if reduce_mean else r


@dataclass(frozen=True)
class NormalizerState:
    """Running mean/std statistics over the feature channels."""

    sum: torch.Tensor
    sum_squared: torch.Tensor
    count: torch.Tensor
    n_accumulations: torch.Tensor
    max_accumulations: float
    std_epsilon: float

    @property
    def mean(self):
        return self.sum / torch.clamp(self.count, min=1.0)

    @property
    def std(self):
        var = self.sum_squared / torch.clamp(self.count, min=1.0) - self.mean ** 2
        return torch.clamp(torch.sqrt(torch.clamp(var, min=0.0)), min=self.std_epsilon)


def normalizer_init(size: int, max_accumulations: float = 1e6, std_epsilon: float = 1e-8,
                    device=None) -> NormalizerState:
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    return NormalizerState(z(size), z(size), z(), z(), float(max_accumulations), float(std_epsilon))


def normalizer_accumulate(state: NormalizerState, x: torch.Tensor,
                          all_reduce=None) -> NormalizerState:
    """Accumulate over all leading dims of ``x [..., size]``; a no-op once
    ``max_accumulations`` is reached. ``all_reduce`` (a function of one
    tensor) sums the batch's sums, squares and count over the ranks that
    hold the rest of the batch before they are added."""
    flat = x.reshape(-1, x.shape[-1]).to(torch.promote_types(x.dtype, torch.float32))
    w = (state.n_accumulations < state.max_accumulations).to(flat.dtype)
    total, total_sq, count = flat.sum(dim=0), (flat ** 2).sum(dim=0), flat.shape[0]
    if all_reduce is not None:
        n = flat.shape[1]
        packed = all_reduce(torch.cat([total, total_sq, total.new_full((1,), count)]))
        total, total_sq, count = packed[:n], packed[n:2 * n], packed[2 * n]
    return replace(
        state,
        sum=state.sum + w * total,
        sum_squared=state.sum_squared + w * total_sq,
        count=state.count + w * count,
        n_accumulations=state.n_accumulations + w,
    )


def normalizer_apply(state: NormalizerState, x: torch.Tensor) -> torch.Tensor:
    return (x - state.mean) / state.std


def normalizer_inverse(state: NormalizerState, x: torch.Tensor, channel: Optional[int] = None):
    if channel is None:
        return x * state.std + state.mean
    return x * state.std[channel] + state.mean[channel]
