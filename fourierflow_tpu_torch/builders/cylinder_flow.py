"""The cylinder-flow builder of MeshGraphNets (counterpart of
``fourierflow_tpu/builders/cylinder_flow.py``), over the HDF5 file that
``commands/convert.py`` writes from DeepMind's TFRecords.

Each split (``train``, ``valid``, ``test``) holds ``cells [B, C, 3]``
(int32, -1 padded), ``mesh_pos [B, N, 2]``, ``node_type [B, N]`` (-1
padded), ``velocity`` and ``target_velocity`` ``[B, T, N, 2]`` (NaN padded),
``n_cells`` and ``n_nodes``. Training items are (trajectory, time) pairs,
item i being trajectory ``i // T`` at time ``i % T``; evaluation items are
whole trajectories. The file is memory-mapped (``utils.hdf5``), so a batch
reads what it takes.
"""

import os
from typing import Dict, Iterator, Optional

import numpy as np

from ..utils.hdf5 import read_dataset
from .base import Builder, num_batches

__all__ = ["CylinderFlowBuilder"]

_KEYS = ("cells", "mesh_pos", "node_type", "velocity", "target_velocity")


class CylinderFlowBuilder(Builder):
    name = "cylinder_flow"

    def __init__(self, path: str, batch_size: int = 1, **kwargs):
        self.batch_size = batch_size
        path = os.path.expandvars(os.path.expanduser(path))
        self.splits = {split: {k: read_dataset(path, f"{split}/{k}", mmap=True) for k in _KEYS}
                       for split in ("train", "valid", "test")}

    @property
    def _train_shape(self):
        return self.splits["train"]["velocity"].shape[:2]  # (B, T)

    def train_batches(self, rng: Optional[np.random.Generator] = None
                      ) -> Iterator[Dict[str, np.ndarray]]:
        """Shuffled one-step items, ``velocity [b, N, 2]``."""
        return self._train_items(shuffle=True, rng=rng)

    def _train_items(self, shuffle: bool, rng=None):
        tr = self.splits["train"]
        n_t = self._train_shape[1]
        idx = np.arange(int(np.prod(self._train_shape)))
        if shuffle:
            (rng or np.random.default_rng()).shuffle(idx)
        for start in range(0, len(idx), self.batch_size):
            sel = idx[start:start + self.batch_size]
            b, t = sel // n_t, sel % n_t
            yield {"cells": np.asarray(tr["cells"][b]), "mesh_pos": np.asarray(tr["mesh_pos"][b]),
                   "node_type": np.asarray(tr["node_type"][b]),
                   "velocity": np.asarray(tr["velocity"][b, t]),
                   "target_velocity": np.asarray(tr["target_velocity"][b, t])}

    def _eval_items(self, split: str):
        arrays = self.splits[split]
        n = arrays["velocity"].shape[0]
        for start in range(0, n, self.batch_size):
            yield {k: np.array(a[start:start + self.batch_size]) for k, a in arrays.items()}

    def val_batches(self):
        return self._eval_items("valid")

    def test_batches(self):
        return self._eval_items("test")

    @property
    def batches_per_epoch(self) -> int:
        return num_batches(int(np.prod(self._train_shape)), self.batch_size)

    def sample_batch(self) -> Dict[str, np.ndarray]:
        """The first training batch in file order."""
        return next(self._train_items(shuffle=False))
