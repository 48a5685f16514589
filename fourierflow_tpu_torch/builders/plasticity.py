"""Plasticity builder, ``plas_N987_T20.mat`` (counterpart of
``fourierflow_tpu/builders/plasticity.py``): the scalar boundary input
``[N, s1]`` broadcast over the 3D space-time mesh to ``[N, s1, s2, t, 1]``,
the 4-channel output ``[N, s1, s2, t, 4]``. The splits are train, valid,
test, in that order.
"""

import numpy as np

from .base import Builder, load_array

__all__ = ["PlasticityBuilder"]


class PlasticityBuilder(Builder):
    name = "plasticity"

    def __init__(self, data_path: str, train_size: int, valid_size: int, test_size: int,
                 s1: int = 101, s2: int = 31, t: int = 20, batch_size: int = 16, **kwargs):
        self.batch_size = batch_size
        x = load_array(data_path, "input").astype(np.float32)
        y = load_array(data_path, "output").astype(np.float32)
        x = np.broadcast_to(x[:, :, None, None, None], (x.shape[0], s1, s2, t, 1)).copy()
        i, j = train_size, train_size + valid_size
        k = j + test_size
        self.train_data = {"x": x[:i], "y": y[:i]}
        self.valid_data = {"x": x[i:j], "y": y[i:j]}
        self.test_data = {"x": x[j:k], "y": y[j:k]}

    def inference_data(self):
        """The first 512 test samples."""
        return {k: v[:512] for k, v in self.test_data.items()}
