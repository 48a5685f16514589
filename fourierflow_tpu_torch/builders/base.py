"""Data builders: in-memory numpy datasets with a simple batcher
(counterpart of ``fourierflow_tpu/builders/base.py``). Batches are dicts of
numpy arrays; the routine moves them to its device."""

import os
from typing import Dict, Iterator, Optional

import numpy as np

__all__ = ["Builder", "iterate_batches", "num_batches", "load_array"]


def load_array(path: str, key: str = "u", index=Ellipsis) -> np.ndarray:
    """Load ``array[index]`` of a dataset from .npy, .h5/.hdf5 (h5py, or
    ``utils.hdf5`` where h5py is not installed) or .mat (scipy; MATLAB
    v7.3 files through h5py). From .npy and .h5 only what ``index`` keeps
    is read."""
    path = os.path.expandvars(os.path.expanduser(path))
    if path.endswith(".npy"):
        return np.array(np.load(path, mmap_mode="r")[index])
    if path.endswith((".h5", ".hdf5")):
        try:
            import h5py
        except ImportError:
            from ..utils.hdf5 import read_dataset

            a = read_dataset(path, key, mmap=True)[index]
            return np.array(a, dtype=a.dtype.newbyteorder("="))
        with h5py.File(path, "r") as f:
            return f[key][index]
    import scipy.io

    try:
        return scipy.io.loadmat(path)[key][index]
    except NotImplementedError:
        import h5py

        with h5py.File(path, "r") as f:
            return np.asarray(f[key]).T[index]


def num_batches(n: int, batch_size: int, drop_last: bool = False) -> int:
    return n // batch_size if drop_last else -(-n // batch_size)


def iterate_batches(arrays: Dict[str, np.ndarray], batch_size: int, shuffle: bool = False,
                    rng: Optional[np.random.Generator] = None,
                    drop_last: bool = False) -> Iterator[Dict[str, np.ndarray]]:
    n = len(next(iter(arrays.values())))
    idx = np.arange(n)
    if shuffle:
        (rng or np.random.default_rng()).shuffle(idx)
    stop = (n // batch_size) * batch_size if drop_last else n
    for start in range(0, stop, batch_size):
        sel = idx[start:start + batch_size]
        yield {k: v[sel] for k, v in arrays.items()}


class Builder:
    """Subclasses fill ``train_data``/``valid_data``/``test_data`` with
    aligned numpy arrays and set ``batch_size``."""

    batch_size: int = 1
    train_data: Dict[str, np.ndarray]
    valid_data: Dict[str, np.ndarray]
    test_data: Dict[str, np.ndarray]

    def train_batches(self, rng: Optional[np.random.Generator] = None):
        return iterate_batches(self.train_data, self.batch_size, shuffle=True, rng=rng)

    def val_batches(self):
        return iterate_batches(self.valid_data, self.batch_size)

    def test_batches(self):
        return iterate_batches(self.test_data, self.batch_size)

    @property
    def batches_per_epoch(self) -> int:
        return num_batches(len(next(iter(self.train_data.values()))), self.batch_size)

    def sample_batch(self) -> Dict[str, np.ndarray]:
        """One batch for model init and shape inference."""
        return next(iterate_batches(self.train_data, self.batch_size))

    def inference_data(self) -> Dict[str, np.ndarray]:
        """The trajectories the ``predict`` command rolls out."""
        raise NotImplementedError(f"{type(self).__name__} has no inference data")
