"""The original FNO (Li et al. 2021), the torus_li/zongyi baseline
(counterpart of ``fourierflow_tpu/models/zongyi_fno_2d.py``).

Full (not factorized) 2D spectral weights on two corner blocks of modes, a
linear residual branch in each layer, ReLU activations; the input is the
10-step window with two position channels (``input_dim`` 12).

Under tensor parallelism (``set_parallel``) each layer's Fourier weights
are column shards ``[in, out/tp, m, m, 2]`` (``parallel.shard_state``, as
the JAX package's ``tp_state_shardings`` splits them): the spectral
convolution gives this rank's output channels, which are all-gathered
before the residual, and x's gradient from it is summed over the ``model``
axis. Everything else is replicated.

Parameter names follow the reference's torch ``state_dict`` (the JAX
package's ``utils/torch_import.py::convert_zongyi_state_dict``):
``in_proj.*``, ``spectral_layers.{i}.fourier_weight.{0,1}``
``[in, out, m, m, 2]``, ``spectral_layers.{i}.linear.*`` and the head
``feedforward.{0,2}.*``.
"""

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..layers import WNLinear, xavier_normal_init
from ..ops.spectral import spectral_conv_2d_full
from ..parallel.collectives import copy_to, gather

__all__ = ["ZongyiSpectralConv2d", "FNOZongyi2DBlock"]


class ZongyiSpectralConv2d(nn.Module):
    """One original-FNO layer: the full spectral convolution, plus a linear
    residual (``residual``) or a linear layer after it, then ReLU."""

    tensor_parallel = None  # the model mesh axis of the block's set_parallel

    def __init__(self, in_dim: int, out_dim: int, n_modes: int, residual: bool = True):
        super().__init__()
        self.in_dim, self.out_dim, self.residual = in_dim, out_dim, residual
        shape = (in_dim, out_dim, n_modes, n_modes, 2)
        self.fourier_weight = nn.ParameterList(
            [nn.Parameter(torch.empty(shape)) for _ in range(2)])
        self.linear = WNLinear(in_dim, out_dim)

    def reset_parameters(self, generator=None) -> None:
        """Fourier weights: ``xavier_normal_`` with gain 1/(in*out); the
        linear layer: torch's default."""
        for w in self.fourier_weight:
            xavier_normal_init(w, 1.0 / (self.in_dim * self.out_dim), generator)
        self.linear.reset_parameters(generator)

    def forward(self, x):
        tp = self.tensor_parallel
        if tp is not None and getattr(self.fourier_weight[0], "tp_dim", None) is not None:
            h = gather(spectral_conv_2d_full(copy_to(x, tp), *self.fourier_weight, norm="ortho"),
                       tp, 3)
        else:
            # Contiguous, as the split form's gathered channels are: the inverse FFT hands
            # back channel-strided memory, and the linear bias's gradient sums the ReLU's
            # gradient in the order of this layout, so a split step of one rank would
            # differ from this one in the last bit.
            h = spectral_conv_2d_full(x, *self.fourier_weight, norm="ortho").contiguous()
        if self.residual:
            return torch.relu(h + self.linear(x))
        return torch.relu(self.linear(h))


class FNOZongyi2DBlock(nn.Module):
    """Stack of original-FNO layers. ``forward`` takes ``[batch, X, Y,
    input_dim]`` and returns ``{"forecast": [batch, X, Y, 1]}``.

    As in the reference, only ``modes1`` reaches the layers: ``modes2`` is
    accepted and unused, and so is ``dropout``. With ``remat`` each layer
    runs under ``torch.utils.checkpoint`` (its input kept, the rest
    recomputed in the backward pass); the parameters are the same."""

    def __init__(self, modes1: int, modes2: int, width: int, input_dim: int = 12,
                 dropout: float = 0.1, n_layers: int = 4, residual: bool = False,
                 conv_residual: bool = True, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.modes1, self.modes2, self.width, self.residual = modes1, modes2, width, residual
        self.n_layers = n_layers
        self.in_proj = WNLinear(input_dim, width)
        self.spectral_layers = nn.ModuleList(
            ZongyiSpectralConv2d(width, width, modes1, conv_residual) for _ in range(n_layers))
        self.feedforward = nn.Sequential(WNLinear(width, 128), nn.ReLU(), WNLinear(128, 1))
        self.reset_parameters(torch.Generator().manual_seed(0))

    def reset_parameters(self, generator=None) -> None:
        """Re-initialise every parameter from ``generator``, which must be on
        the parameters' device."""
        self.in_proj.reset_parameters(generator)
        for layer in self.spectral_layers:
            layer.reset_parameters(generator)
        self.feedforward[0].reset_parameters(generator)
        self.feedforward[2].reset_parameters(generator)

    def set_parallel(self, tensor=None, spatial=None) -> None:
        """The ``model`` mesh axis of the layers' tensor-parallel form (None:
        one device). The block has no spatially split form."""
        if spatial is not None:
            raise NotImplementedError("FNOZongyi2DBlock has no spatially split form")
        for layer in self.spectral_layers:
            layer.tensor_parallel = tensor

    def forward(self, x: torch.Tensor, **kwargs):
        x = self.in_proj(x)
        for layer in self.spectral_layers:
            h = checkpoint(layer, x, use_reentrant=False) if self.remat else layer(x)
            x = h + x if self.residual else h
        return {"forecast": self.feedforward(x)}
