"""Navier-Stokes rollout builder (counterpart of
``fourierflow_tpu/builders/ns_zongyi.py``): the first ``n_steps`` fields of
each trajectory as the input window, with two linspace position channels
appended, and the next ``n_steps`` as targets."""

import numpy as np

from .base import Builder, load_array

__all__ = ["NSZongyiBuilder"]


class NSZongyiBuilder(Builder):
    name = "ns_zongyi"

    def __init__(self, data_path: str, train_size: int, test_size: int, ssr: int = 1,
                 n_steps: int = 10, append_pos: bool = True, batch_size: int = 32,
                 key: str = "u", **kwargs):
        self.data_path = data_path
        self.key = key
        self.batch_size = batch_size
        data = load_array(data_path, key).astype(np.float32)
        data = data[:, ::ssr, ::ssr]
        a = data[..., :n_steps]
        u = data[..., n_steps: n_steps * 2]
        b, sx, sy, _ = a.shape

        if append_pos:
            ticks = np.linspace(0, 1, sx, dtype=np.float32)
            grid_x = np.broadcast_to(ticks[None, :, None, None], (b, sx, sy, 1))
            grid_y = np.broadcast_to(ticks[None, None, :, None], (b, sx, sy, 1))
            a = np.concatenate([a, grid_x, grid_y], axis=-1)

        times = np.tile(np.arange(n_steps, n_steps * 2, dtype=np.float32), (b, 1))
        self.train_data = {"x": a[:train_size], "y": u[:train_size], "times": times[:train_size]}
        self.valid_data = {"x": a[-test_size:], "y": u[-test_size:], "times": times[-test_size:]}
        self.test_data = self.valid_data

    def inference_data(self):
        """The first 512 trajectories ``[B, X, Y, T]``."""
        data = load_array(self.data_path, self.key).astype(np.float32)[:512]
        return {"data": data}
