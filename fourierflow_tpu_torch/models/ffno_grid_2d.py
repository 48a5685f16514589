"""Factorized Fourier Neural Operator on a regular 2D grid, the flagship
model (counterpart of ``fourierflow_tpu/models/ffno_grid_2d.py``).

Per layer: the separable spectral mix along both grid axes
(``ops.fused_mix_2d``, the CUDA kernel on a CUDA tensor), a feed-forward
"backcast" (``ops.fused_ff`` through ``layers.FeedForward``) and the
residual ``x = x + backcast``. The output head reads the last backcast, or
with ``use_fork`` sums per-layer forecasts. ``mode="low-pass"`` replaces the
mix by each axis's truncated spectrum transformed back
(``ops.spectral.spectral_lowpass_axis``) and has no Fourier weights;
``mode="no-fourier"`` skips it.

With ``remat`` each layer's mix and backcast feed-forward run under
``torch.utils.checkpoint``: the backward pass keeps only the layer's input
and recomputes the rest (on the card, kernels A and B launch twice a layer
in a train step). The parameters are the same in both modes.

The layer's parallel forms (``set_parallel``; with neither the layer runs
as above):

- tensor parallelism (``model`` axis): the Fourier weights are column
  shards ``[C, C/tp, M, 2]`` (``parallel.shard_state``, which marks them
  with their ``tp_dim``), so the mix gives
  this rank's C/tp output channels (kernel B with C_out = C/tp), which are
  all-gathered before the feed-forward's tensor-parallel form
  (``layers.FeedForward``); x's gradient from the mix is summed over the
  axis. A Fourier weight that the axis does not divide stays whole.
- spatial parallelism (``spatial`` axis): x is this rank's X rows ``[B,
  X/sp, Y, C]``. The Y branch runs on them (``ops.fused_mix_axis``); the X
  branch runs after an all-to-all to ``[B, X, Y/sp, C]`` and goes back by
  the inverse one (``spatial_mix_2d``). The branches come back in float32
  and are summed and rounded once, as ``fused_mix_2d``'s "Y writes, X adds"
  does, forward and backward; on a spatial axis of one rank the result is
  ``fused_mix_2d``'s to the bit. The low-pass mode and the CNO block's DCT
  mix take the same two branches in autograd (``along_x``), summed where
  the unsplit form sums them; ``no-fourier`` needs no collective. Every
  other part of the layer acts on each cell alone.

A mix of several branches takes x through one view (``x.view_as(x)``, or
``copy_to`` on a split ``model`` axis), in the split and the unsplit form
alike, so that the branches' gradients are summed in one node before the
residual's is added: otherwise the extra nodes of a split form change the
order in which autograd adds them, and a split step of one rank is off the
unsplit step in the last bit.

Parameter names follow the reference's torch ``state_dict``:
``in_proj.*``, ``spectral_layers.{i}.fourier_weight.{0,1}`` (Y then X),
``spectral_layers.{i}.backcast_ff.layers.{j}.0.*`` and ``out.{j}.*``; with
``share_weight``/``share_fork`` the shared tensors also appear at block
level (``fourier_weight.{0,1}``, ``backcast_ff.*``).
"""

from typing import Optional

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..layers import FeedForward, WNLinear, xavier_normal_init
from ..ops.fused_spectral import fused_mix_2d, fused_mix_axis, fused_mix_axis_adjoint
from ..ops.spectral import mix_axis_wgrad, spectral_lowpass_axis
from ..parallel.collectives import copy_to, gather, x_split, y_split

__all__ = ["FNOFactorized2DBlock", "ColumnParallel", "column_split_mix", "along_x",
           "spatial_mix_2d"]

_DTYPES = {None: None, "float32": torch.float32, "bfloat16": torch.bfloat16}


class _SpectralLayer(nn.Module):
    def __init__(self, fourier_weight: Optional[nn.ParameterList], backcast_ff, forecast_ff):
        super().__init__()
        if fourier_weight is not None:
            self.fourier_weight = fourier_weight
        if backcast_ff is not None:
            self.backcast_ff = backcast_ff
        if forecast_ff is not None:
            self.forecast_ff = forecast_ff


class _SpatialMix2d(torch.autograd.Function):
    """The two branches of one layer's mix on a grid split over ``spatial``,
    as one Function, so that each direction sums them in float32 and rounds
    once (an autograd graph of the two branches would round x's gradient
    from each before the engine adds them). The weight gradients are each
    rank's part (its rows for Y, its columns for X), summed over the axis
    with the other gradients (``Routine.reduce_over_mesh``)."""

    @staticmethod
    def forward(ctx, x, wy, wx, sp):
        xt = y_split(x, sp)
        ctx.save_for_backward(x, xt, wy, wx)
        ctx.sp = sp
        out = fused_mix_axis(x, wy, 2) + x_split(fused_mix_axis(xt, wx, 1), sp)
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, xt, wy, wx = ctx.saved_tensors
        sp = ctx.sp
        g = g.contiguous()
        gt = y_split(g, sp)
        need_x, need_wy, need_wx, _ = ctx.needs_input_grad
        dx = ((fused_mix_axis_adjoint(g, wy, 2) + x_split(fused_mix_axis_adjoint(gt, wx, 1), sp))
              .to(g.dtype) if need_x else None)
        wgrad = lambda a, b, w, axis: mix_axis_wgrad(a, b, w.shape[2], axis,
                                                     round_to=x.dtype).to(w.dtype)
        return (dx, wgrad(x, g, wy, 2) if need_wy else None,
                wgrad(xt, gt, wx, 1) if need_wx else None, None)


def column_split_mix(mix, x: torch.Tensor, w0: torch.Tensor, w1: torch.Tensor,
                     tp) -> torch.Tensor:
    """``mix(x, w0, w1)``; where ``shard_state`` split the weights into
    column shards (their ``tp_dim``) over the ``model`` axis ``tp``, this
    rank's output channels all-gathered, x's gradient summed over the axis
    (the tensor-parallel form of every F-FNO's mix)."""
    if tp is not None and getattr(w0, "tp_dim", None) is not None:
        return gather(mix(copy_to(x, tp), w0, w1), tp, 3)
    return mix(x, w0, w1)


class ColumnParallel:
    """``set_parallel`` of a model whose split form on ``model`` splits its
    mixes by output channel in ``forward`` with ``tensor_parallel``, and
    every feed-forward's hidden slice. Its ``spatial`` raises: a model with
    a spatially split form (FNO++) takes that axis in its own
    ``set_parallel``."""

    tensor_parallel = None  # the ``model`` axis (``set_parallel``); None on one device

    def set_parallel(self, tensor=None, spatial=None) -> None:
        """The ``Axis`` of the ``model`` mesh axis that the layers' split
        form uses (None: one device). ``spatial`` raises: the model has no
        spatially split form."""
        if spatial is not None:
            raise NotImplementedError(f"{type(self).__name__} has no spatially split form")
        self.tensor_parallel = tensor
        for m in self.modules():
            if isinstance(m, FeedForward):
                m.tensor_parallel = tensor

    def column_split(self, w: torch.Tensor) -> bool:
        """Whether a mix with the Fourier weight ``w`` runs on this rank's
        output channels: on a ``model`` axis, where ``shard_state`` split
        ``w`` (its ``tp_dim``)."""
        return self.tensor_parallel is not None and getattr(w, "tp_dim", None) is not None

    def mix_input(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x`` as the branches of a mix with the Fourier weight ``w`` take
        it: through ``copy_to`` where the mix is split (their gradient summed
        over the axis), else through a view. Either way the branches'
        gradients are summed in one node before x's other uses add theirs, so
        that a split step of one rank is the unsplit step to the bit."""
        return copy_to(x, self.tensor_parallel) if self.column_split(w) else x.view_as(x)

    def mix_output(self, t: torch.Tensor, w: torch.Tensor, dim: int) -> torch.Tensor:
        """A mix's output ``t``: this rank's channels all-gathered along
        ``dim`` where the mix is split, else ``t``; contiguous either way."""
        return gather(t, self.tensor_parallel, dim) if self.column_split(w) else t.contiguous()


def along_x(branch, x: torch.Tensor, sp) -> torch.Tensor:
    """``branch(x)`` of a branch along X (dim 1) of the whole grid. With the
    ``spatial`` axis ``sp``, x is this rank's X rows ``[B, X/sp, Y, C]``: the
    branch runs on ``[B, X, Y/sp, C]`` between the two all-to-alls, each the
    other's backward, and the result is this rank's rows again."""
    if sp is None:
        return branch(x)
    return x_split(branch(y_split(x, sp)), sp)


def spatial_mix_2d(x: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor, sp) -> torch.Tensor:
    """``fused_mix_2d`` of the whole grid, on this rank's X rows ``x [B,
    X/sp, Y, C]`` of it: the Y branch on the rows (``fused_mix_axis``), the
    X branch between two all-to-alls over the ``spatial`` axis ``sp``,
    summed in float32 and rounded once to x's type."""
    return _SpatialMix2d.apply(x, wy, wx, sp)


class FNOFactorized2DBlock(nn.Module):
    # The per-mode weight's trailing dims (real, imaginary) and the separable
    # mix of both axes, ``mix(x, wy, wx)``; the CNO block replaces both.
    _pair = (2,)
    _mix = staticmethod(fused_mix_2d)
    # ``mix(x, wy, wx, sp)`` on this rank's X rows of a grid split over the
    # ``spatial`` axis ``sp``.
    _spatial_mix = staticmethod(spatial_mix_2d)
    # The parallel axes (``set_parallel``); None on one device.
    tensor_parallel = None
    spatial_parallel = None

    """Stack of factorized spectral layers with residuals. ``forward`` takes
    ``[batch, X, Y, input_dim]`` and returns ``{"forecast": [batch, X, Y, 1],
    "forecast_list": [...]}``; with a compute ``dtype`` the parameters stay
    float32 and the forecast is handed back in float32. ``remat`` is an
    attribute that the forward reads, so a trainer may turn it on after
    construction (``trainers/trainer.py``)."""

    def __init__(self, modes: int, width: int, input_dim: int = 12, dropout: float = 0.0,
                 in_dropout: float = 0.0, n_layers: int = 4, share_weight: bool = False,
                 share_fork: bool = False, factor: int = 2, ff_weight_norm: bool = False,
                 n_ff_layers: int = 2, gain: float = 1.0, layer_norm: bool = False,
                 use_fork: bool = False, mode: str = "full", dtype=None, remat: bool = False):
        super().__init__()
        if mode not in ("full", "low-pass", "no-fourier"):
            raise ValueError(f"FNOFactorized2DBlock mode must be 'full', 'low-pass' or "
                             f"'no-fourier', got {mode!r}")
        self.remat = remat
        self.modes, self.width, self.n_layers = modes, width, n_layers
        self.share_weight, self.share_fork, self.use_fork = share_weight, share_fork, use_fork
        self.mode, self.gain, self.in_dropout, self.dropout = mode, gain, in_dropout, dropout
        self.dtype = _DTYPES[dtype] if dtype is None or isinstance(dtype, str) else dtype

        self.in_proj = WNLinear(input_dim, width, wnorm=ff_weight_norm, dtype=self.dtype)
        wshape = (width, width, modes, *self._pair)
        make_w = lambda: nn.ParameterList([nn.Parameter(torch.empty(wshape)) for _ in range(2)])
        make_ff = lambda: FeedForward(width, factor, ff_weight_norm, n_ff_layers, layer_norm,
                                      dropout, dtype=self.dtype)
        full = mode == "full"
        # Shared weights and feed-forwards are registered at block level AND in
        # every layer, as the reference's torch modules do (its state_dict
        # lists a shared tensor under each path).
        if full and share_weight:
            self.fourier_weight = make_w()
        if share_fork:
            self.backcast_ff = make_ff()
            if use_fork:
                self.forecast_ff = make_ff()
        self.spectral_layers = nn.ModuleList(
            _SpectralLayer(
                (self.fourier_weight if share_weight else make_w()) if full else None,
                self.backcast_ff if share_fork else make_ff(),
                (self.forecast_ff if share_fork else make_ff()) if use_fork else None,
            )
            for _ in range(n_layers)
        )
        self.out = nn.Sequential(
            WNLinear(width, 128, wnorm=ff_weight_norm, dtype=self.dtype),
            WNLinear(128, 1, wnorm=ff_weight_norm, dtype=self.dtype),
        )
        self.reset_parameters(torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Re-initialise every parameter from ``generator``, which must be on
        the parameters' device."""
        self.in_proj.reset_parameters(generator)
        if self.mode == "full" and self.share_weight:
            for w in self.fourier_weight:
                xavier_normal_init(w, self.gain, generator)
        if self.share_fork:
            self.backcast_ff.reset_parameters(generator)
            if self.use_fork:
                self.forecast_ff.reset_parameters(generator)
        for layer in self.spectral_layers:
            if self.mode == "full" and not self.share_weight:
                for w in layer.fourier_weight:
                    xavier_normal_init(w, 1.0, generator)
            if not self.share_fork:
                layer.backcast_ff.reset_parameters(generator)
                if self.use_fork:
                    layer.forecast_ff.reset_parameters(generator)
        for lin in self.out:
            lin.reset_parameters(generator)

    def set_parallel(self, tensor=None, spatial=None) -> None:
        """The ``Axis`` of the ``model`` and of the ``spatial`` mesh axis that
        the layers' parallel forms use (None for neither: one device)."""
        if tensor is not None and spatial is not None:
            raise ValueError("tensor and spatial parallelism cannot be combined")
        if (tensor or spatial) and (self.dropout > 0 or self.in_dropout > 0):
            raise NotImplementedError("dropout has no parallel form: each rank would draw its own")
        self.tensor_parallel, self.spatial_parallel = tensor, spatial
        for m in self.modules():
            if isinstance(m, FeedForward):
                m.tensor_parallel = tensor

    def _layer(self, layer: _SpectralLayer, x: torch.Tensor):
        """One layer's mix and backcast: ``(h, b)``."""
        sp = self.spatial_parallel
        if self.mode == "no-fourier":
            h = x
        elif self.mode == "low-pass":
            xv = x.view_as(x)
            h = (spectral_lowpass_axis(xv, self.modes, 2)
                 + along_x(lambda t: spectral_lowpass_axis(t, self.modes, 1), xv, sp))
        else:
            wy, wx = layer.fourier_weight
            if sp is not None:
                h = self._spatial_mix(x, wy, wx, sp)
            else:
                h = column_split_mix(self._mix, x, wy, wx, self.tensor_parallel)
        return h, layer.backcast_ff(h)

    def forward(self, x: torch.Tensor):
        x = self.in_proj(x)
        if self.in_dropout > 0.0:
            x = nn.functional.dropout(x, self.in_dropout, self.training)
        forecast = 0.0
        forecast_list = []
        b = x
        for layer in self.spectral_layers:
            if self.remat:
                # Dropout in the backcast draws from the default generator, whose
                # state the recompute restores (preserve_rng_state).
                h, b = checkpoint(self._layer, layer, x, use_reentrant=False)
            else:
                h, b = self._layer(layer, x)
            if self.use_fork:
                f = layer.forecast_ff(h)
                f_out = self.out(f)
                forecast = forecast + f_out
                forecast_list.append(f_out)
            x = x + b
        if not self.use_fork:
            forecast = self.out(b)
        if self.dtype is not None:
            forecast = forecast.float()
            forecast_list = [f.float() for f in forecast_list]
        return {"forecast": forecast, "forecast_list": forecast_list}
