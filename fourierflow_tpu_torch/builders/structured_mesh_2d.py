"""Structured 2D mesh builder, airfoil and pipe, the Geo-FNO datasets
(counterpart of ``fourierflow_tpu/builders/structured_mesh_2d.py``): the
mesh coordinates X and Y stacked as the input ``[N, sx, sy, 2]``, one
channel of Q ``[N, channels, sx, sy]`` as the target (only that channel is
read from the file). The splits are taken in the Geo-FNO paper's order:
train, then test, then valid.
"""

import numpy as np

from .base import Builder, load_array

__all__ = ["StructuredMesh2DBuilder"]


class StructuredMesh2DBuilder(Builder):
    name = "structured_mesh_2d"

    def __init__(self, x1_path: str, x2_path: str, sigma_path: str, output_dim: int,
                 train_size: int, valid_size: int, test_size: int, batch_size: int = 20,
                 **kwargs):
        self.batch_size = batch_size
        x = np.stack([load_array(p).astype(np.float32) for p in (x1_path, x2_path)], axis=-1)
        y = load_array(sigma_path, index=(slice(None), output_dim)).astype(np.float32)
        i, j = train_size, train_size + test_size
        k = j + valid_size
        self.train_data = {"x": x[:i], "y": y[:i]}
        self.test_data = {"x": x[i:j], "y": y[i:j]}
        self.valid_data = {"x": x[j:k], "y": y[j:k]}

    def inference_data(self):
        """The first 512 test samples."""
        return {k: v[:512] for k, v in self.test_data.items()}
