"""Contextual Navier-Stokes builder for torus_vis and torus_vis_force
(counterpart of ``fourierflow_tpu/builders/ns_contextual.py``): a
viscosity ``mu`` per trajectory and a constant (``f [n, X, Y]``) or
time-varying (``f [n, X, Y, T]``) force, one-step training pairs with
stride ``k``.

The h5 file holds ``{split}/u [n, X, Y, T]``, ``{split}/f`` and
``{split}/mu [n]`` for the splits train, valid and test, as
``generate navier-stokes`` writes them. Only the ``[:, ::ssr, ::ssr]`` part
of the fields is read (``load_array``'s ``index``).
"""

import numpy as np

from .base import Builder, load_array

__all__ = ["NSContextualBuilder"]


class NSContextualBuilder(Builder):
    name = "ns_contextual"

    def __init__(self, data_path: str, ssr: int = 1, k: int = 1, batch_size: int = 32,
                 **kwargs):
        self.data_path = data_path
        self.batch_size = batch_size
        read = lambda split, key, index=Ellipsis: load_array(data_path, f"{split}/{key}", index)
        grid = np.s_[:, ::ssr, ::ssr]
        self.train_data = self._training_pairs(read("train", "u", grid), read("train", "f", grid),
                                               read("train", "mu"), k)
        every_k = np.s_[:, ::ssr, ::ssr, ::k]
        self.valid_data = self._eval_set(read("valid", "u", every_k), read("valid", "f", grid),
                                         read("valid", "mu"), k)
        self.test_data = self._eval_set(read("test", "u", every_k), read("test", "f", grid),
                                        read("test", "mu"), k)

    @staticmethod
    def _training_pairs(u, f, mu, k):
        """Every (t, t + k) pair, flattened sample-major: ``x``, ``y``
        ``[(n t), X, Y, 1]``, ``mu [(n t)]`` and ``f [(n t), X, Y]``, the
        force at time t + k where it varies."""
        n, sx, sy, t_total = u.shape
        t_pairs = t_total - k
        xs = np.moveaxis(u[..., :t_pairs], -1, 1).reshape(-1, sx, sy, 1)
        ys = np.moveaxis(u[..., k:], -1, 1).reshape(-1, sx, sy, 1)
        mus = np.repeat(mu, t_pairs).astype(np.float32)
        if f.ndim == 3:
            fs = np.repeat(f[:, None], t_pairs, axis=1).reshape(-1, sx, sy)
        else:
            fs = np.moveaxis(f[..., k:], -1, 1).reshape(-1, sx, sy)
        return {"x": xs.astype(np.float32), "y": ys.astype(np.float32), "mu": mus,
                "f": fs.astype(np.float32)}

    @staticmethod
    def _eval_set(u, f, mu, k):
        """Whole trajectories ``u`` (read strided by ``k`` in time), the force
        strided by ``k`` where it varies, and ``times`` ``0, 0.1 k, ...``."""
        if f.ndim == 4:
            f = f[..., ::k]
        times = np.arange(0, 20, 0.1 * k, dtype=np.float32)
        times = np.tile(times[: u.shape[-1]], (u.shape[0], 1))
        return {"data": u.astype(np.float32), "f": f.astype(np.float32),
                "mu": mu.astype(np.float32), "times": times}

    def inference_data(self):
        """The first 512 test items."""
        return {key: v[:512] for key, v in self.test_data.items()}
