"""The port's dataset generator against the JAX package's, on the CPU.

Gaussian random fields (the eigenvalues to the bit; the fields from JAX's
own normal draws, injected), the Crank-Nicolson solver over about 200
steps at n 32 from the same initial field (JAX's random-force weights
injected), the inverse FFT that is defined for non-Hermitian spectra, the
``generate navier-stokes`` h5 file (layout, shapes, dtypes and viscosities
as the JAX command writes them), the HDF5 writer and reader used where
h5py is absent, and the CLI's device rule. The port's draws are never
compared with JAX's: the two generators differ.
"""

import h5py
import jax
import numpy as np
import pytest
import torch

from fourierflow_tpu.builders.synthetic import ns_2d as jax_ns_2d
from fourierflow_tpu.builders.synthetic import random_fields as jax_random_fields
from fourierflow_tpu.commands.generate import navier_stokes as jax_navier_stokes
from fourierflow_tpu_torch.builders import NSMarkovBuilder
from fourierflow_tpu_torch.builders.synthetic import (
    gaussian_random_field, grf_sqrt_eigenvalues, solve_navier_stokes_2d)
from fourierflow_tpu_torch.commands.generate import navier_stokes
from fourierflow_tpu_torch.ops.fourier import irfft2
from fourierflow_tpu_torch.utils.hdf5 import H5Writer, read_dataset

SOLVER_TOL = 1e-5  # max |port - JAX| / max |JAX| over ~200 f32 steps (measured ~4e-7)


def _reference_cn_steps(w0, visc, delta_t, n_steps, f):
    """Independent float64 numpy Crank-Nicolson steps with full fft2 (the
    math of the reference solver)."""
    n = w0.shape[-1]
    k1 = np.fft.fftfreq(n, d=1.0 / n)
    kx, ky = np.meshgrid(k1, k1, indexing="ij")
    lap = 4 * np.pi**2 * (kx**2 + ky**2)
    lap[0, 0] = 1.0
    k_max = n // 2
    dealias = (np.abs(ky) <= 2.0 / 3.0 * k_max) & (np.abs(kx) <= 2.0 / 3.0 * k_max)
    w_h = np.fft.fft2(w0)
    f_h = np.fft.fft2(f)
    for _ in range(n_steps):
        psi_h = w_h / lap
        q = np.real(np.fft.ifft2(2j * np.pi * ky * psi_h))
        v = np.real(np.fft.ifft2(-2j * np.pi * kx * psi_h))
        w_x = np.real(np.fft.ifft2(2j * np.pi * kx * w_h))
        w_y = np.real(np.fft.ifft2(2j * np.pi * ky * w_h))
        F_h = np.fft.fft2(q * w_x + v * w_y) * dealias
        factor = 0.5 * delta_t * visc * lap
        w_h = (-delta_t * F_h + delta_t * f_h + (1.0 - factor) * w_h) / (1.0 + factor)
    return np.real(np.fft.ifft2(w_h))


# --- Gaussian random fields ---------------------------------------------------------
@pytest.mark.parametrize("n_dims,size", [(1, 16), (2, 32), (2, 15), (3, 8)])
@pytest.mark.parametrize("sigma", [None, 2.5])
def test_grf_sqrt_eigenvalues_match_jax_to_the_bit(n_dims, size, sigma):
    args = (n_dims, size, 2.5, 7.0, sigma)
    want = jax_random_fields.grf_sqrt_eigenvalues(*args)
    got = grf_sqrt_eigenvalues(*args)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_dims,size", [(1, 16), (2, 32), (3, 8)])
def test_gaussian_random_field_from_jax_draws(n_dims, size):
    """JAX's normals, drawn with the key split as the JAX function splits
    it, injected into the port: equal to 1e-6 of the largest value."""
    key = jax.random.PRNGKey(3)
    shape = (4,) + (size,) * n_dims
    kr, ki = jax.random.split(key)
    normals = (np.asarray(jax.random.normal(kr, shape)), np.asarray(jax.random.normal(ki, shape)))
    want = np.asarray(jax_random_fields.gaussian_random_field(key, 4, size, n_dims, 2.5, 7.0))
    got = gaussian_random_field(4, size, n_dims, 2.5, 7.0, normals=normals).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_gaussian_random_field_draws_from_the_generator():
    draw = lambda seed: gaussian_random_field(3, 16, alpha=2.5, tau=7.0,
                                              generator=torch.Generator().manual_seed(seed))
    a, b, c = draw(1), draw(1), draw(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (3, 16, 16) and a.mean(dim=(1, 2)).abs().max() < 1e-5
    with pytest.raises(ValueError, match="shape"):
        gaussian_random_field(3, 16, normals=(np.zeros((3, 16)), np.zeros((3, 16))))


# --- the inverse FFT ----------------------------------------------------------------
@pytest.mark.parametrize("sx,sy", [(16, 16), (15, 15), (16, 12), (9, 14)])
def test_irfft2_equals_torch_irfft2_on_non_hermitian_spectra(sx, sy):
    """Random half-spectra (imaginary parts in the self-conjugate bins):
    the same as ``torch.fft.irfft2`` on the CPU, to the bit, on the last
    two axes and on axes (1, 2) of a channels-last tensor."""
    g = torch.Generator().manual_seed(sx * sy)
    z = torch.complex(torch.randn(3, sx, sy // 2 + 1, generator=g),
                      torch.randn(3, sx, sy // 2 + 1, generator=g))
    torch.testing.assert_close(irfft2(z, (sx, sy)), torch.fft.irfft2(z, s=(sx, sy)),
                               rtol=0, atol=0)
    zc = z[..., None].expand(3, sx, sy // 2 + 1, 2).clone()
    torch.testing.assert_close(irfft2(zc, (sx, sy), dim=(1, 2)),
                               torch.fft.irfft2(zc, s=(sx, sy), dim=(1, 2)), rtol=0, atol=0)


# --- the solver ---------------------------------------------------------------------
def _w0(n=32, b=3, seed=1):
    key = jax.random.PRNGKey(seed)
    return np.array(jax_random_fields.gaussian_random_field(key, b, n, 2, 2.5, 7.0))


SOLVER_CASES = {
    "li": dict(force="li"),
    "kolmogorov": dict(force="kolmogorov"),
    "none": dict(force="none"),
    "per-sample viscosity": dict(force="li", visc=np.array([1e-3, 1e-2, 1e-4], np.float32)),
    "random static": dict(force="random", cycles=2, scaling=0.1, t_scaling=0.2),
    "random varying": dict(force="random", cycles=2, scaling=0.1, t_scaling=0.2,
                           varying_force=True),
    "li varying": dict(force="li", varying_force=True),
}


@pytest.mark.parametrize("case", list(SOLVER_CASES))
def test_solver_matches_jax(case):
    """n 32, 201 steps (t 0.2 at delta 1e-3, ceil) in 4 records of 50, from
    the same w0: sol within SOLVER_TOL of the JAX solver's largest value,
    the force to 1e-6 absolute; with JAX's random-force weights injected."""
    kw = dict(SOLVER_CASES[case])
    visc = kw.pop("visc", 1e-4)
    w0 = _w0()
    key = jax.random.PRNGKey(3)
    want, want_f = jax_ns_2d.solve_navier_stokes_2d(w0, visc, 0.2, 1e-3, 4, key=key,
                                                    chunk_records=None, **kw)
    alphas = None
    if kw["force"] == "random":
        alphas = np.asarray(jax.random.uniform(key, (3, kw["cycles"], 6)))
    got, got_f = solve_navier_stokes_2d(torch.from_numpy(w0), visc, 0.2, 1e-3, 4, alphas=alphas,
                                        **kw)
    assert got.shape == want.shape == (3, 32, 32, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SOLVER_TOL * np.abs(want).max())
    if want_f is None:
        assert got_f is None
    else:
        assert tuple(got_f.shape) == want_f.shape
        np.testing.assert_allclose(got_f.numpy(), want_f, rtol=0, atol=1e-6)


def test_solver_matches_float64_reference_math():
    """Against the float64 numpy Crank-Nicolson reference, 20 steps at n 16
    (the JAX package's test_solver tolerance: rtol 1e-2, atol 2e-3, and a
    correlation above 0.999999)."""
    rng = np.random.RandomState(0)
    w0 = rng.randn(2, 16, 16).astype(np.float32)
    w0 -= w0.mean(axis=(1, 2), keepdims=True)
    sol, f = solve_navier_stokes_2d(torch.from_numpy(w0), 1e-2, 20 * 1e-2, 1e-2, 1)
    want = np.stack([_reference_cn_steps(w0[i], 1e-2, 1e-2, 20, f.numpy()) for i in range(2)])
    np.testing.assert_allclose(sol[..., 0].numpy(), want, rtol=1e-2, atol=2e-3)
    assert np.corrcoef(sol[..., 0].numpy().ravel(), want.ravel())[0, 1] > 0.999999


def test_solver_invariants_and_errors():
    """Finite, zero-mean fields that change between records; the force is
    drawn from the generator; too many records and NaN raise."""
    w0 = torch.from_numpy(_w0(n=16, b=2))
    sol, f = solve_navier_stokes_2d(w0, 1e-3, 0.1, 1e-2, 5)
    assert torch.isfinite(sol).all() and sol.mean(dim=(1, 2)).abs().max() < 1e-5
    assert (sol[..., 1] - sol[..., 0]).abs().max() > 0 and tuple(f.shape) == (16, 16)
    kw = dict(force="random", cycles=2, scaling=0.1, t_scaling=0.2)
    run = lambda seed: solve_navier_stokes_2d(w0, 1e-3, 0.02, 1e-2, 1,
                                              generator=torch.Generator().manual_seed(seed), **kw)[1]
    assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))
    with pytest.raises(ValueError, match="record_steps"):
        solve_navier_stokes_2d(w0, 1e-3, 0.02, 1e-2, 3)
    with pytest.raises(ValueError, match="NaN"):
        solve_navier_stokes_2d(w0 * float("nan"), 1e-3, 0.02, 1e-2, 1)


# --- the generate command ---------------------------------------------------------
def _h5_tree(path):
    with h5py.File(path, "r") as f:
        out = {}
        f.visititems(lambda name, obj: out.__setitem__(
            name, (obj.shape, obj.dtype) if isinstance(obj, h5py.Dataset) else "group"))
        return out


GEN_CASES = {
    "li, viscosity range": dict(force="li", mu_min=1e-4, mu_max=1e-3),
    "random varying": dict(force="random", varying_force=True),
    "random static": dict(force="random"),
}


@pytest.mark.parametrize("case", list(GEN_CASES))
def test_navier_stokes_file_has_the_jax_layout(case, tmp_path):
    """The same arguments through both commands (s 16, 3 steps at delta
    1e-3, two batches in train): the same datasets, shapes, dtypes and
    viscosities; a and u finite, f written for the random force only. The
    port's file loads through NSMarkovBuilder (key train/u) and reads the
    same through h5py and the port's reader."""
    kw = dict(n_train=4, n_valid=2, n_test=2, s=16, t=3e-3, steps=3, delta=1e-3, seed=5,
              batch_size=2, **GEN_CASES[case])
    jax_navier_stokes(str(tmp_path / "jax.h5"), **kw)
    navier_stokes(str(tmp_path / "port.h5"), device="cpu", **kw)
    tree = _h5_tree(tmp_path / "port.h5")
    assert tree == _h5_tree(tmp_path / "jax.h5")
    with h5py.File(tmp_path / "jax.h5", "r") as fj, h5py.File(tmp_path / "port.h5", "r") as fp:
        for split in ("train", "valid", "test"):
            np.testing.assert_array_equal(fp[f"{split}/mu"][...], fj[f"{split}/mu"][...])
            for name in ("a", "u"):
                assert np.isfinite(fp[f"{split}/{name}"][...]).all()
            written = np.abs(fp[f"{split}/f"][...]).max() > 0
            assert written == (kw["force"] == "random")
            assert written == (np.abs(fj[f"{split}/f"][...]).max() > 0)
        for name, (shape, _) in ((k, v) for k, v in tree.items() if v != "group"):
            np.testing.assert_array_equal(read_dataset(str(tmp_path / "port.h5"), name),
                                          fp[name][...])
    builder = NSMarkovBuilder(str(tmp_path / "port.h5"), train_size=2, test_size=2, key="train/u")
    assert builder.valid_data["data"].shape == (2, 16, 16, 3)


def test_generate_cli_on_the_cpu_and_its_raise_without_a_card(monkeypatch, tmp_path):
    from fourierflow_tpu_torch.commands.__main__ import main

    args = ["generate", "navier-stokes", "--n-train", "2", "--n-valid", "0", "--n-test", "1",
            "--s", "16", "--t", "2e-3", "--steps", "2", "--delta", "1e-3"]
    main([*args[:2], str(tmp_path / "cpu.h5"), *args[2:], "--device", "cpu"])
    assert read_dataset(str(tmp_path / "cpu.h5"), "train/u").shape == (2, 16, 16, 2)
    assert read_dataset(str(tmp_path / "cpu.h5"), "test/mu").tolist() == [
        pytest.approx(1e-5)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main([*args[:2], str(tmp_path / "card.h5"), *args[2:]])
    assert not (tmp_path / "card.h5").exists()


# --- the HDF5 writer and reader -----------------------------------------------------
def test_h5_writer_files_read_by_h5py(tmp_path):
    rng = np.random.RandomState(0)
    arrays = {"train/a": rng.randn(5, 4, 4).astype(np.float32),
              "train/u": rng.randn(5, 4, 4, 3).astype(np.float32),
              "valid/mu": rng.rand(2).astype(np.float32),
              "x": rng.randn(3).astype(np.float64),
              "t": np.arange(-3, 3, dtype=np.int64), "n": np.arange(4, dtype=np.int32)}
    layout = {k: (v.shape, v.dtype) for k, v in arrays.items()}
    layout["valid/f"] = ((2, 4, 4), np.float32)  # never written
    path = str(tmp_path / "w.h5")
    with H5Writer(path, layout) as w:
        for k, v in arrays.items():
            w.write(k, 0, v[:2])
            w.write(k, 2, v[2:])
        with pytest.raises(ValueError, match="do not fit"):
            w.write("train/a", 4, arrays["train/a"][:2])
    with h5py.File(path, "r") as f:
        for k, v in arrays.items():
            assert f[k].dtype == v.dtype
            np.testing.assert_array_equal(f[k][...], v)
        assert (f["valid/f"][...] == 0).all()
    for k, v in arrays.items():
        np.testing.assert_array_equal(read_dataset(path, k), v)
    with pytest.raises(FileExistsError):
        H5Writer(path, layout)
    with pytest.raises(TypeError, match="complex64"):
        H5Writer(str(tmp_path / "c.h5"), {"c": ((3,), np.complex64)})
    with pytest.raises(KeyError, match="no 'test'"):
        read_dataset(path, "test/u")


def test_h5_reader_reads_h5py_files(tmp_path):
    """h5py's default layout: groups as symbol tables, contiguous datasets,
    a dataset never written, more members than one symbol node holds."""
    rng = np.random.RandomState(1)
    path = str(tmp_path / "h.h5")
    want = {}
    with h5py.File(path, "w") as f:
        for i in range(12):
            want[f"g/d{i:02d}"] = rng.randn(3, i + 1).astype(np.float32)
            f[f"g/d{i:02d}"] = want[f"g/d{i:02d}"]
        f.create_dataset("empty", (2, 3), np.float32)
        want["top"] = np.arange(5, dtype=np.int32)
        f["top"] = want["top"]
    for k, v in want.items():
        got = read_dataset(path, k)
        assert got.dtype == v.dtype
        np.testing.assert_array_equal(got, v)
    assert (read_dataset(path, "empty") == 0).all()


def test_solver_step_count_follows_ceil():
    """ceil(t_end / delta) steps in windows of steps // records: 6.5 steps
    round up to 7, in two windows of 3 (the seventh is not taken), so the
    records equal those of 6 steps, and the first equals 3 steps."""
    w0 = torch.from_numpy(_w0(n=8, b=1))
    dt = 2.0 ** -6
    a, _ = solve_navier_stokes_2d(w0, 1e-3, 6.5 * dt, dt, 2)
    b, _ = solve_navier_stokes_2d(w0, 1e-3, 6 * dt, dt, 2)
    c, _ = solve_navier_stokes_2d(w0, 1e-3, 3 * dt, dt, 1)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(a[..., 0], c[..., 0], rtol=0, atol=0)
