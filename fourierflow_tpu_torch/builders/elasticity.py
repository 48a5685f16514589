"""Elasticity point-cloud builder, the Geo-FNO dataset (counterpart of
``fourierflow_tpu/builders/elasticity.py``): the geometry parameters ``rr``
(``[42, N]`` on file, ``[N, 42]`` here), the stress targets ``sigma``
(``[972, N]`` -> ``[N, 972, 1]``) and the point coordinates ``xy`` (``[972,
2, N]`` -> ``[N, 972, 2]``). Train is the first ``train_size`` samples, valid
the ``valid_size`` before the last ``test_size``, test the last
``test_size``.
"""

import numpy as np

from .base import Builder, load_array

__all__ = ["ElasticityBuilder"]


class ElasticityBuilder(Builder):
    name = "elasticity"

    def __init__(self, sigma_path: str, xy_path: str, rr_path: str, train_size: int,
                 valid_size: int, test_size: int, batch_size: int = 20, **kwargs):
        self.batch_size = batch_size
        data = {"rr": load_array(rr_path).astype(np.float32).transpose(1, 0),
                "sigma": load_array(sigma_path).astype(np.float32).transpose(1, 0)[..., None],
                "xy": load_array(xy_path).astype(np.float32).transpose(2, 0, 1)}
        eval_size = valid_size + test_size
        self.train_data = {k: v[:train_size] for k, v in data.items()}
        self.valid_data = {k: v[-eval_size:-test_size] for k, v in data.items()}
        self.test_data = {k: v[-test_size:] for k, v in data.items()}

    def inference_data(self):
        """The first 512 test samples."""
        return {k: v[:512] for k, v in self.test_data.items()}
