"""Navier-Stokes Markov builder: one-step training pairs from torus
trajectories (counterpart of ``fourierflow_tpu/builders/ns_markov.py``).
Training items are all (t, t+1) pairs flattened over trajectories and time;
evaluation items are whole trajectories ``[B, X, Y, T]``."""

import numpy as np

from .base import Builder, load_array

__all__ = ["NSMarkovBuilder"]


class NSMarkovBuilder(Builder):
    name = "ns_markov"

    def __init__(self, data_path: str, train_size: int, test_size: int, ssr: int = 1,
                 batch_size: int = 32, key: str = "u", **kwargs):
        self.data_path = data_path
        self.key = key
        self.batch_size = batch_size
        data = load_array(data_path, key).astype(np.float32)
        data = data[:, ::ssr, ::ssr]
        train = data[:train_size]
        test = data[-test_size:]
        self.train_data = self._one_step_pairs(train)
        times = np.tile(np.arange(0, data.shape[-1], 1, dtype=np.float32), (len(test), 1))
        self.valid_data = {"data": test, "times": times}
        self.test_data = self.valid_data

    @staticmethod
    def _one_step_pairs(data: np.ndarray):
        """(x=t, y=t+1, dx, dy) pairs flattened to ``[(b t), X, Y, 1]``."""
        x = data[..., 1:-1]
        y = data[..., 2:]
        dx = data[..., 1:-1] - data[..., :-2]
        dy = data[..., 2:] - data[..., 1:-1]

        def flat(a):
            a = np.moveaxis(a, -1, 1)
            return a.reshape(-1, *a.shape[2:])[..., None]

        return {"x": flat(x), "y": flat(y), "dx": flat(dx), "dy": flat(dy)}

    def inference_data(self):
        """The first 512 trajectories ``[B, X, Y, T]``."""
        data = load_array(self.data_path, self.key).astype(np.float32)[:512]
        return {"data": data}
