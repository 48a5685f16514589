"""Kolmogorov flow: the generator and the dataset builders (counterpart of
``fourierflow_tpu/builders/kolmogorov.py``).

Generation (``generate_kolmogorov``) simulates a batch of trajectories at
once on the tensor's device, by one of two methods:

- ``pseudo_spectral`` (2D): ``utils.equations``' CN-RK4 stepper on the
  vorticity's half-spectrum, from a random divergence-free initial velocity
  (``filtered_velocity_field``, its curl) or given initial vorticities;
  records downsampled by ``downsample_vorticity_snapshot``.
- ``projection`` (2D and 3D): ``utils.finite_volume``'s stepper on the
  staggered velocities, from ``filtered_velocity_field`` (2D) or
  ``finite_volume.filtered_velocity_field_3d`` (3D), or given initial
  velocities; records downsampled by ``downsample_velocity_snapshot``.

``warmup_steps`` outer steps of ``inner_steps`` solver steps run first
without recording, then ``outer_steps`` recorded ones, each record
downsampled to every requested grid. On a CUDA device the solver steps are
replayed from a CUDA graph (``utils.equations.graph_repeated``), to the bit
the eager loop's result.

The files are HDF5 in the JAX package's layout (``commands/generate.py``
writes them): ``vx``, ``vy`` (and ``vz`` in 3D; ``vorticity`` in 2D)
``[sample, time, x, y(, z)]`` with a ``time`` vector (or ``[sample, x, y(,
z)]`` initial conditions), ``elapsed`` and the attributes ``dt`` and
``inner_steps``. The datasets read them as memory maps
(``utils.hdf5.read_dataset``), so a batch reads what it takes: one-step
pairs and whole trajectories of the vorticity (the F-FNO routines), and the
learned-interpolation model's unrolled velocities and initial velocities
with 32^2 vorticity targets. For the Trainer's device-resident epoch the
one-step and unrolled datasets read their arrays whole and gather each
batch of virtual ``(trajectory, time)`` items on the device
(``device_train_data``).
"""

import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..ops.fourier import irfft2
from ..utils.equations import graph_repeated
from ..utils.finite_volume import filtered_velocity_field_3d
from ..utils.grids import Grid, fft_mesh, rfft_mesh
from ..utils.hdf5 import read_dataset
from ..utils.spectral import (downsample_staggered_velocity, downsample_vorticity,
                              downsample_vorticity_hat, velocity_to_vorticity_fd,
                              vorticity_to_velocity_solve)
from .base import Builder, load_array

__all__ = [
    "check_method",
    "filtered_velocity_field",
    "generate_kolmogorov",
    "downsample_vorticity_snapshot",
    "downsample_velocity_snapshot",
    "KolmogorovMarkovDataset",
    "KolmogorovTrajectoryDataset",
    "KolmogorovMultiDataset",
    "KolmogorovVelocityDataset",
    "KolmogorovVelocityTrajectoryDataset",
    "KolmogorovBuilder",
]

_GRAPH_STEPS = 64  # solver steps of a CUDA graph, at most
_FLUSH_RECORDS = 64  # records kept on the device before they move to the host
VELOCITY_NAMES = ("vx", "vy", "vz")


def check_method(method: str, sim_grid: Grid) -> None:
    """Raise for a method and grid the generator does not take: the
    pseudo-spectral method is 2D, the projection method 2D or 3D."""
    if method == "pseudo_spectral":
        if sim_grid.ndim != 2:
            raise NotImplementedError(
                f"the pseudo-spectral method is 2D; a {sim_grid.ndim}-D grid takes the "
                "projection method")
    elif method == "projection":
        if sim_grid.ndim not in (2, 3):
            raise NotImplementedError(f"the projection method on a {sim_grid.ndim}-D grid")
    else:
        raise NotImplementedError(f"unknown method {method!r}")


def filtered_velocity_field(grid: Grid, maximum_velocity: float = 1.0,
                            peak_wavenumber: float = 3.0, batch: int = 1,
                            normals=None, generator: Optional[torch.Generator] = None,
                            device=None):
    """``batch`` random divergence-free velocities ``(vx, vy) [batch, nx, ny]``
    whose spectrum peaks near ``peak_wavenumber`` (``|v(k)| ~ (k/kp)^2
    exp(-(k/kp)^2 / 2)``), each scaled to the speed ``maximum_velocity`` at
    its fastest point. A random stream function with complex normal modes
    ``normals = (real, imaginary)`` (``[batch, nx, ny]`` each; drawn from
    ``generator`` when not given) is shaped, its real part taken, and the
    velocities are its spectral derivatives."""
    nx, ny = grid.shape
    if normals is None:
        draw = lambda: torch.randn((batch, nx, ny), generator=generator, device=device)
        normals = (draw(), draw())
    nr, ni = (torch.as_tensor(a, dtype=torch.float32) for a in normals)
    if device is not None:
        nr, ni = nr.to(device), ni.to(device)
    kx, ky = (torch.from_numpy(a) for a in fft_mesh(grid.shape, grid.domain))
    kmag = torch.sqrt(kx ** 2 + ky ** 2)
    kp = peak_wavenumber / (grid.domain[0][1] - grid.domain[0][0])  # cycles per length
    vel_amp = (kmag / kp) ** 2 * torch.exp(-((kmag / kp) ** 2) / 2.0)
    psi_amp = torch.where(kmag > 0, vel_amp / (2 * np.pi * torch.clamp(kmag, min=1e-12)),
                          torch.zeros(()))
    psi = torch.fft.ifft2(psi_amp.to(nr.device) * torch.complex(nr, ni)).real
    psi_hat = torch.fft.rfft2(psi)
    rkx, rky = (torch.from_numpy(a).to(nr.device) for a in rfft_mesh(grid.shape, grid.domain))
    two_pi_i = 2j * np.pi
    vx, vy = irfft2(torch.stack([two_pi_i * rky * psi_hat, -two_pi_i * rkx * psi_hat]),
                    grid.shape)
    speed = torch.sqrt(vx ** 2 + vy ** 2)
    scale = maximum_velocity / torch.clamp(speed.amax(dim=(-2, -1), keepdim=True), min=1e-12)
    return vx * scale, vy * scale


def downsample_vorticity_snapshot(sim_grid: Grid, out_grids: Dict, velocity_solve,
                                  out_vorticity: bool, vorticity_hat: torch.Tensor):
    """The downsampling of one recorded state of the pseudo-spectral method
    to each grid of ``out_grids`` (keyed ``(size, k)``): ``{key: {"vx",
    "vy"[, "vorticity"]}}``; at the simulation's own size the spectral
    velocity and vorticity, else ``downsample_vorticity_hat``."""
    outs = {}
    for key, out_grid in out_grids.items():
        if key[0] == sim_grid.shape[0]:
            vxhat, vyhat = velocity_solve(vorticity_hat)
            vx, vy, w = irfft2(torch.stack([vxhat, vyhat, vorticity_hat]), sim_grid.shape)
            out = {"vx": vx, "vy": vy, "vorticity": w}
        else:
            out = downsample_vorticity_hat(vorticity_hat, velocity_solve, sim_grid, out_grid)
        if not out_vorticity:
            out.pop("vorticity", None)
        outs[key] = out
    return outs


def downsample_velocity_snapshot(sim_grid: Grid, out_grids: Dict, velocity_solve,
                                 out_vorticity: bool, u):
    """The downsampling of one recorded state of the projection method, the
    staggered velocities ``(vx, vy[, vz])``, to each grid of ``out_grids``
    (keyed ``(size, k)``): ``{key: {"vx", "vy"[, "vz"][, "vorticity"]}}``; the
    state itself at the simulation's own size, else
    ``downsample_staggered_velocity``; the finite-difference vorticity in 2D
    only (``velocity_solve`` is unused)."""
    outs = {}
    for key, out_grid in out_grids.items():
        if key[0] == sim_grid.shape[0]:  # copies: the state may be a CUDA graph's own tensors
            comps, grid = tuple(c.clone() for c in u), sim_grid
        else:
            comps, grid = downsample_staggered_velocity(sim_grid, out_grid, u), out_grid
        out = dict(zip(VELOCITY_NAMES, comps))
        if out_vorticity and len(u) == 2:
            out["vorticity"] = velocity_to_vorticity_fd(comps[0], comps[1], grid)
        outs[key] = out
    return outs


def _graph_steps(inner_steps: int, graph_steps: int) -> int:
    """The largest divisor of ``inner_steps`` up to ``graph_steps`` (0: none)."""
    return max((d for d in range(1, min(graph_steps, inner_steps) + 1) if inner_steps % d == 0),
               default=0)


def _initial_state(method: str, sim_grid: Grid, batch: int, generator, initial_field, dev,
                   peak_wavenumber: float, max_velocity: float):
    """The solver's state: the vorticity's half-spectrum (pseudo-spectral)
    or the velocity tuple (projection), from ``initial_field`` where given,
    else drawn from ``generator``."""
    if method == "projection":
        if initial_field is not None:
            return tuple(torch.as_tensor(np.asarray(initial_field[n]), device=dev).float()
                         for n in VELOCITY_NAMES[:sim_grid.ndim])
        if sim_grid.ndim == 3:
            return filtered_velocity_field_3d(sim_grid, max_velocity, peak_wavenumber, batch,
                                              generator=generator, device=dev)
        return filtered_velocity_field(sim_grid, max_velocity, peak_wavenumber, batch,
                                       generator=generator, device=dev)
    if initial_field is None:
        vx, vy = filtered_velocity_field(sim_grid, max_velocity, peak_wavenumber, batch,
                                         generator=generator, device=dev)
        w0 = velocity_to_vorticity_fd(vx, vy, sim_grid)
    else:
        w0 = torch.as_tensor(np.asarray(initial_field["vorticity"]), device=dev)
    return torch.fft.rfft2(w0.float())


@torch.no_grad()
def generate_kolmogorov(sim_grid: Grid, out_sizes: List[Dict[str, int]], method: str, step_fn,
                        downsample_fn: Callable = downsample_vorticity_snapshot,
                        batch: int = 1, generator: Optional[torch.Generator] = None,
                        initial_field: Optional[Dict[str, np.ndarray]] = None,
                        peak_wavenumber: float = 4.0, max_velocity: float = 7.0,
                        inner_steps: int = 25, outer_steps: int = 200, warmup_steps: int = 40,
                        out_vorticity: bool = True, device=None):
    """Simulate ``batch`` trajectories on ``device`` by ``method`` and
    downsample their records to every ``{"size", "k"}`` of ``out_sizes``.

    The initial state comes from ``initial_field`` where given
    (``"vorticity" [batch, X, Y]`` for the pseudo-spectral method, ``"vx"``,
    ``"vy"`` (, ``"vz"``) ``[batch, X, Y(, Z)]`` for the projection method),
    else from a random divergence-free velocity drawn from ``generator``.
    ``warmup_steps`` outer steps of ``inner_steps`` solver steps run first;
    then with ``outer_steps`` > 0 each of ``outer_steps`` outer steps ends in
    a record, of which a key ``(size, k)`` keeps every k-th (the k-th, 2k-th,
    ...: the JAX package records all and its writer keeps these), else the
    warmed state is the one record. Returns ``(outs, elapsed)``:
    ``outs[(size, k)][field]``, numpy ``[batch, outer_steps // k, size, ...]``
    (``[batch, size, ...]`` when warming up only), and the seconds it took.
    On CUDA, runs of solver steps are replayed from a CUDA graph of at most
    64 steps (the largest divisor of ``inner_steps`` up to that). Records
    move to the host 64 at a time."""
    check_method(method, sim_grid)
    dev = torch.device(device) if device is not None else torch.device("cpu")
    velocity_solve = vorticity_to_velocity_solve(sim_grid) if sim_grid.ndim == 2 else None
    out_grids = {(o["size"], o["k"]): Grid(shape=(o["size"],) * sim_grid.ndim,
                                           domain=sim_grid.domain)
                 for o in out_sizes}
    start = time.time()
    state = _initial_state(method, sim_grid, batch, generator, initial_field, dev,
                           peak_wavenumber, max_velocity)
    g = _graph_steps(inner_steps, _GRAPH_STEPS) if dev.type == "cuda" else 0
    run = graph_repeated(step_fn, state, g)
    if warmup_steps > 0:
        state = run(state, warmup_steps * inner_steps)
    if outer_steps == 0:
        outs = downsample_fn(sim_grid, out_grids, velocity_solve, out_vorticity, state)
        outs = {key: {name: a.cpu().numpy() for name, a in out.items()} for key, out in outs.items()}
        return outs, np.float32(time.time() - start)

    pending = {key: [] for key in out_grids}
    host = {key: [] for key in out_grids}

    def flush():
        for key, recs in pending.items():
            if recs:
                host[key].append({name: torch.stack([r[name] for r in recs], 1).cpu().numpy()
                                  for name in recs[0]})
                recs.clear()

    for i in range(1, outer_steps + 1):
        state = run(state, inner_steps)
        keep = [key for key in out_grids if i % key[1] == 0]
        if keep:
            outs = downsample_fn(sim_grid, {key: out_grids[key] for key in keep}, velocity_solve,
                                 out_vorticity, state)
            for key in keep:
                pending[key].append(outs[key])
        if i % _FLUSH_RECORDS == 0:
            flush()
    flush()
    outs = {}
    for key, parts in host.items():
        fields = parts[0].keys() if parts else []
        outs[key] = {name: np.concatenate([p[name] for p in parts], axis=1) for name in fields}
    return outs, np.float32(time.time() - start)


# --- datasets over the generated files -------------------------------------------------
def _resolve_data_path(path: str) -> str:
    """``path`` with environment variables and ``~`` expanded; where it does
    not exist, the same name with ``.h5`` for ``.nc`` (the generator's
    files) or ``.nc`` for ``.h5`` if that exists."""
    path = os.path.expandvars(os.path.expanduser(path))
    if not os.path.exists(path):
        stem, ext = os.path.splitext(path)
        alt = stem + (".h5" if ext == ".nc" else ".nc")
        if os.path.exists(alt):
            return alt
    return path


def _open(path: str, key: str) -> np.ndarray:
    """The dataset ``key`` of the HDF5 file ``path`` as a read-only memory
    map (``utils.hdf5``); a dataset stored otherwise (chunked, as some
    netCDF writers store it) is read whole with ``load_array``."""
    try:
        return read_dataset(path, key, mmap=True)
    except NotImplementedError:
        return load_array(path, key)


class KolmogorovMarkovDataset:
    """One-step ``(t, t + k)`` training pairs of a trajectory file, with the
    velocity at t: items ``{"x", "vx", "vy", "y"}``, each ``[..., 1]``."""

    def __init__(self, path: str, k: int = 1, in_memory: bool = True):
        del in_memory  # the file is memory-mapped either way
        self.k = k
        path = _resolve_data_path(path)
        self.w, self.vx, self.vy = (_open(path, name) for name in ("vorticity", "vx", "vy"))
        self.B = self.w.shape[0]
        self.T = self.w.shape[1] - k

    def __len__(self):
        return self.B * self.T

    def sample(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        b, t = idx // self.T, idx % self.T
        field = lambda a, tt: np.asarray(a[b, tt], dtype=np.float32)[..., None]
        return {"x": field(self.w, t), "vx": field(self.vx, t), "vy": field(self.vy, t),
                "y": field(self.w, t + self.k)}

    def device_train_data(self, fields=("w", "vx", "vy")):
        """The Trainer's device-resident view: ``(data, sample_fn, n_items)``
        with ``data`` the named ``[S, T, X, Y]`` arrays of ``fields`` read
        whole (float32), and ``sample_fn(data, idx)`` the batch of the
        virtual items ``idx`` gathered on the device: ``x`` = ``w[b, t]``,
        ``y`` = ``w[b, t + k]`` and ``vx``, ``vy`` at t where uploaded, each
        ``[..., 1]``. The Markov routine recovers the velocity from the
        vorticity and asks for ``("w",)``."""
        data = {f: np.array(getattr(self, f), np.float32) for f in fields}
        k, n_t = self.k, self.T

        def sample_fn(arrays, idx):
            b, t = idx // n_t, idx % n_t
            out = {"x": arrays["w"][b, t][..., None], "y": arrays["w"][b, t + k][..., None]}
            for f in ("vx", "vy"):
                if f in arrays:
                    out[f] = arrays[f][b, t][..., None]
            return out

        return data, sample_fn, len(self)


class KolmogorovTrajectoryDataset:
    """Whole trajectories for evaluation: the initial condition prepended,
    every k-th frame up to ``end``, time last (``data``, ``vx``, ``vy``
    ``[S, X, Y, T']``, ``times``), and the reduced-resolution reference
    ``corr_data`` (32^2 in the protocol) on the same frames, its initial
    frame downsampled from the full-resolution one where its file has no
    initial frame (as many frames as the trajectory file)."""

    def __init__(self, init_path: str, path: str, corr_path: str, k: int = 1,
                 end: Optional[int] = None, in_memory: bool = True):
        del in_memory
        self.k = k
        init_path, path, corr_path = map(_resolve_data_path, (init_path, path, corr_path))
        w = _open(path, "vorticity")
        n_frames = w.shape[1]
        # Frame j of the trajectory with its initial condition prepended is
        # file frame j - 1; the kept frames are j = 0, k, 2k, ... before end.
        kept = np.arange(n_frames + 1)[slice(None, end, k)]
        frames = kept[1:] - 1

        def with_init(a0, a):
            return np.concatenate([np.asarray(a0, np.float32)[:, None],
                                   np.asarray(a[:, frames], np.float32)], axis=1)

        fields = {}
        for name in ("vorticity", "vx", "vy"):
            fields[name] = np.moveaxis(with_init(_open(init_path, name), _open(path, name)), 1, -1)
        self.data, self.vx, self.vy = fields["vorticity"], fields["vx"], fields["vy"]
        times = np.asarray(_open(path, "time"))
        self.times = np.concatenate([[0.0], times[frames]]).astype(np.float32)
        cw = _open(corr_path, "vorticity")
        if cw.shape[1] == n_frames:
            w0 = torch.from_numpy(np.array(_open(init_path, "vorticity"), np.float32))
            cw0 = downsample_vorticity(w0[..., None], cw.shape[-1])[..., 0].numpy()
            corr = with_init(cw0, cw)
        else:
            corr = np.asarray(cw[:, np.arange(cw.shape[1])[slice(None, end, k)]], np.float32)
        self.corr_data = np.moveaxis(corr, 1, -1)
        self.B = self.data.shape[0]

    def __len__(self):
        return self.B

    def sample(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        return {"data": self.data[idx], "vx": self.vx[idx], "vy": self.vy[idx],
                "corr_data": self.corr_data[idx],
                "times": np.broadcast_to(self.times, (len(idx), len(self.times)))}


class KolmogorovMultiDataset:
    """One-step datasets at several grid sizes, their batches taken round
    robin (one of each size in turn while a size has batches left), so that
    a batch holds one size."""

    def __init__(self, paths, k: int = 1, batch_size: int = 32, in_memory: bool = True):
        self.datasets = [KolmogorovMarkovDataset(p, k=k) for p in paths]
        self.batch_size = batch_size

    def __len__(self):
        return sum(len(d) for d in self.datasets)

    def batches(self, shuffle: bool = False, rng: Optional[np.random.Generator] = None):
        """The round-robin batches; with ``shuffle`` each dataset's order is
        drawn from ``rng``, dataset by dataset."""
        rng = rng or np.random.default_rng()
        streams = []
        for ds in self.datasets:
            idx = np.arange(len(ds))
            if shuffle:
                rng.shuffle(idx)
            streams.append((ds, [idx[s:s + self.batch_size]
                                 for s in range(0, len(idx), self.batch_size)]))
        for i in range(max(len(chunks) for _, chunks in streams)):
            for ds, chunks in streams:
                if i < len(chunks):
                    yield ds.sample(chunks[i])


class KolmogorovVelocityDataset:
    """The learned-interpolation model's training items: the staggered
    velocity at a frame t and the ``unroll_length`` frames t + k, t + 2k, ...
    after it, time last: ``(inputs, outputs)`` with ``inputs = {"vx", "vy"}``
    ``[b, X, Y]`` and ``outputs = {"vx", "vy"}`` ``[b, X, Y, unroll_length]``
    (``inner_steps`` is accepted for the configs; the stride is ``k``)."""

    def __init__(self, path: str, k: int = 2, unroll_length: int = 32,
                 inner_steps: Optional[int] = None, in_memory: bool = True):
        del inner_steps, in_memory  # the file is memory-mapped either way
        self.k, self.L = k, unroll_length
        path = _resolve_data_path(path)
        self.vx, self.vy = _open(path, "vx"), _open(path, "vy")  # [S, T, X, Y]
        self.B = self.vx.shape[0]
        self.T = self.vx.shape[1] - self.k * self.L

    def __len__(self):
        return self.B * self.T

    def sample(self, idx: np.ndarray):
        b, t = idx // self.T, idx % self.T
        t_out = t[:, None] + (np.arange(1, self.L + 1) * self.k)[None, :]  # [batch, L]
        first = lambda a: np.asarray(a[b, t], np.float32)
        unroll = lambda a: np.moveaxis(np.asarray(a[b[:, None], t_out], np.float32), 1, -1)
        return ({"vx": first(self.vx), "vy": first(self.vy)},
                {"vx": unroll(self.vx), "vy": unroll(self.vy)})

    def device_train_data(self):
        """The Trainer's device-resident view (see
        ``KolmogorovMarkovDataset.device_train_data``): ``vx`` and ``vy``
        ``[S, T, X, Y]`` read whole, and ``sample_fn`` gathering the items'
        ``(inputs, outputs)`` tuples on the device, as ``sample`` does."""
        data = {f: np.array(getattr(self, f), np.float32) for f in ("vx", "vy")}
        k, unroll, n_t = self.k, self.L, self.T

        def sample_fn(arrays, idx):
            b, t = idx // n_t, idx % n_t
            t_out = t[:, None] + torch.arange(1, unroll + 1, device=idx.device) * k
            return ({f: arrays[f][b, t] for f in ("vx", "vy")},
                    {f: arrays[f][b[:, None], t_out].movedim(1, -1) for f in ("vx", "vy")})

        return data, sample_fn, len(self)


class KolmogorovVelocityTrajectoryDataset:
    """The learned-interpolation model's evaluation items: the initial
    staggered velocities ``vx``, ``vy`` ``[S, X, Y]`` and the reference
    vorticity at 32^2 on the validation's snapshots, ``targets [S, 32, 32,
    n]``, with their ``times``.

    The subsampling has two stages, as in the JAX package: the stride ``k``
    turns the file's cadence into the model's, then a snapshot is taken
    every ``inner_steps`` model steps; the initial condition lives in its
    own file, so snapshot i is the file's frame ``i s k - 1``, ``s =
    inner_steps``. At most ``outer_steps`` snapshots, up to ``end``
    (``path`` is accepted for the configs)."""

    def __init__(self, init_path: str, corr_path: str, path: Optional[str] = None, k: int = 1,
                 end: Optional[int] = None, inner_steps: int = 1, outer_steps: int = 100,
                 in_memory: bool = True):
        del path, in_memory
        init_path, corr_path = _resolve_data_path(init_path), _resolve_data_path(corr_path)
        self.vx0, self.vy0 = _open(init_path, "vx"), _open(init_path, "vy")  # [S, X, Y]
        s = inner_steps
        frames = np.arange(_open(corr_path, "vorticity").shape[1])[slice(s * k - 1, end, s * k)]
        frames = frames[:outer_steps]
        cw = np.asarray(_open(corr_path, "vorticity")[:, frames], np.float32)
        self.targets = np.moveaxis(cw, 1, -1)  # [S, 32, 32, n]
        self.times = np.asarray(_open(corr_path, "time"))[frames].astype(np.float32)
        self.B = self.vx0.shape[0]

    def __len__(self):
        return self.B

    def sample(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        return {"vx": np.asarray(self.vx0[idx], np.float32),
                "vy": np.asarray(self.vy0[idx], np.float32), "targets": self.targets[idx],
                "times": np.broadcast_to(self.times, (len(idx), len(self.times)))}


class KolmogorovBuilder(Builder):
    """Batches of the Kolmogorov datasets: shuffled training items (one-step
    pairs, round robin over sizes for ``KolmogorovMultiDataset``, or the
    velocity dataset's ``(inputs, outputs)`` tuples), whole trajectories to
    validate and test on."""

    name = "kolmogorov"

    def __init__(self, train_dataset, valid_dataset, test_dataset, batch_size: int = 32,
                 **kwargs):
        self.batch_size = batch_size
        self.train_dataset = train_dataset
        self.valid_dataset = valid_dataset
        self.test_dataset = test_dataset

    def _batches(self, dataset, shuffle: bool = False, rng=None):
        if hasattr(dataset, "batches"):
            yield from dataset.batches(shuffle=shuffle, rng=rng)
            return
        idx = np.arange(len(dataset))
        if shuffle:
            (rng or np.random.default_rng()).shuffle(idx)
        for start in range(0, len(idx), self.batch_size):
            yield dataset.sample(idx[start:start + self.batch_size])

    def train_batches(self, rng: Optional[np.random.Generator] = None):
        return self._batches(self.train_dataset, shuffle=True, rng=rng)

    def device_train_data(self, **kwargs):
        """The train dataset's device-resident view, ``kwargs`` (``fields``)
        passed on; AttributeError for a dataset without one (the
        multi-resolution dataset), which the Trainer takes for the per-batch
        loop."""
        return self.train_dataset.device_train_data(**kwargs)

    def val_batches(self):
        return self._batches(self.valid_dataset)

    def test_batches(self):
        return self._batches(self.test_dataset)

    @property
    def batches_per_epoch(self) -> int:
        return -(-len(self.train_dataset) // self.batch_size)

    def sample_batch(self):
        """The first training batch in file order (a dict, or an ``(inputs,
        outputs)`` tuple)."""
        return next(iter(self._batches(self.train_dataset)))

    def inference_data(self) -> Dict[str, np.ndarray]:
        """The test trajectories: the vorticity and velocities, or for the
        learned-interpolation model the initial velocities and the 32^2
        targets."""
        ds = self.test_dataset
        if isinstance(ds, KolmogorovVelocityTrajectoryDataset):
            return {"vx": ds.vx0, "vy": ds.vy0, "targets": ds.targets}
        return {"data": ds.data, "vx": ds.vx, "vy": ds.vy}
