"""The PyTorch port's ops against the JAX package, on the CPU.

On a CPU tensor the port's ops run their plain PyTorch versions; here they
are held against the JAX functions (the Pallas kernels in interpret mode,
and the truncated-DFT einsum chain) on the same numpy inputs. The CUDA
kernels themselves are checked against these plain versions on the card
by ``chip_smoke.py``.

Also: a guard that the port never imports JAX or the JAX package, and that
its ``infer`` entry point raises, rather than running on the CPU, when no
GPU is present and the CPU was not asked for.
"""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourierflow_tpu.ops import dft as jax_dft
from fourierflow_tpu.ops.pallas_ff import fused_ff as jax_fused_ff
from fourierflow_tpu.ops.pallas_spectral import fused_mix_2d as jax_fused_mix_2d
from fourierflow_tpu.ops.spectral import spectral_mix_axis as jax_spectral_mix_axis
from fourierflow_tpu_torch.ops import dft, fused_ff, fused_mix_2d, spectral_mix_axis
from fourierflow_tpu_torch.ops.fused_ff import fused_ff_plain

REPO = pathlib.Path(__file__).resolve().parent.parent


def _np(t):
    return np.asarray(t)


# --- bases -------------------------------------------------------------------
@pytest.mark.parametrize("n,modes", [(16, 4), (15, 8), (16, 9), (64, 16), (7, 1)])
@pytest.mark.parametrize("norm", ["ortho", "backward", "forward"])
def test_dft_bases_match_jax(n, modes, norm):
    for port, ref in ((dft.rdft_basis, jax_dft.rdft_basis), (dft.irdft_basis, jax_dft.irdft_basis)):
        for a, b in zip(port(n, modes, norm), ref(n, modes, norm)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_dft_bases_reject_too_many_modes():
    with pytest.raises(ValueError, match="exceeds"):
        dft.rdft_basis(16, 10)
    with pytest.raises(ValueError, match="exceeds"):
        dft.irdft_basis(16, 10)


# --- fused feed-forward --------------------------------------------------------
def _ff_inputs(rows, cin=8, hidden=32, cout=8, seed=0, lead=()):
    rng = np.random.RandomState(seed)
    x = rng.randn(*lead, rows, cin).astype(np.float32)
    w1 = (rng.randn(cin, hidden) * 0.3).astype(np.float32)
    b1 = (rng.randn(hidden) * 0.1).astype(np.float32)
    w2 = (rng.randn(hidden, cout) * 0.3).astype(np.float32)
    b2 = (rng.randn(cout) * 0.1).astype(np.float32)
    return x, w1, b1, w2, b2


@pytest.mark.parametrize("rows,lead", [(300, ()), (37, ()), (1, ()), (13, (2, 3))])
def test_fused_ff_matches_jax_interpret(rows, lead):
    args = _ff_inputs(rows, lead=lead)
    want = _np(jax_fused_ff(*map(jnp.asarray, args), True))
    got = fused_ff(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_fused_ff_matches_plain_composition():
    x, w1, b1, w2, b2 = _ff_inputs(53, cin=6, hidden=24, cout=5, seed=1)
    want = np.maximum(x @ w1 + b1, 0.0) @ w2 + b2
    got = fused_ff(*map(torch.from_numpy, (x, w1, b1, w2, b2))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_fused_ff_plain_keeps_bf16_type():
    args = [torch.from_numpy(a).to(torch.bfloat16) for a in _ff_inputs(9)]
    out = fused_ff_plain(*args)
    assert out.dtype == torch.bfloat16
    want = fused_ff_plain(*[a.float() for a in args])
    torch.testing.assert_close(out.float(), want, rtol=2e-2, atol=2e-2)


def test_fused_ff_takes_transposed_weight_views():
    """The model hands the kernel ``weight.t()`` of torch's ``[out, in]``
    weights, without a copy; the result is the same."""
    x, w1, b1, w2, b2 = map(torch.from_numpy, _ff_inputs(21, seed=2))
    view = lambda w: w.t().contiguous().t()
    got = fused_ff(x, view(w1), b1, view(w2), b2)
    torch.testing.assert_close(got, fused_ff(x, w1, b1, w2, b2), rtol=0, atol=0)


def test_fused_ff_counts_no_launch_on_cpu():
    before = fused_ff.launches
    fused_ff(*map(torch.from_numpy, _ff_inputs(5)))
    assert fused_ff.launches == before


# --- spectral mix ----------------------------------------------------------------
def _mix_inputs(b=2, sx=16, sy=16, c=8, m=4, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, sx, sy, c).astype(np.float32)
    wy = (rng.randn(c, c, m, 2) * 0.1).astype(np.float32)
    wx = (rng.randn(c, c, m, 2) * 0.1).astype(np.float32)
    return x, wy, wx


def _close_to_max(got, want, tol=1e-5):
    err = np.max(np.abs(got - want))
    assert err <= tol * np.max(np.abs(want)), (err, np.max(np.abs(want)))


# (n, modes): the small case, an odd n, and modes = n//2 + 1 on an even n,
# where the Nyquist row's Hermitian weight changes from 2 to 1.
MIX_CASES = [(16, 4), (15, 4), (16, 9)]


@pytest.mark.parametrize("n,m", MIX_CASES)
def test_fused_mix_2d_matches_jax_interpret(n, m):
    x, wy, wx = _mix_inputs(sx=n, sy=n, m=m)
    want = _np(jax_fused_mix_2d(jnp.asarray(x), jnp.asarray(wy), jnp.asarray(wx), True))
    got = fused_mix_2d(*map(torch.from_numpy, (x, wy, wx))).numpy()
    _close_to_max(got, want)


@pytest.mark.parametrize("n,m", MIX_CASES)
@pytest.mark.parametrize("axis", [1, 2])
def test_spectral_mix_axis_matches_jax_dft(n, m, axis):
    x, wy, _ = _mix_inputs(sx=n, sy=n, m=m, seed=3)
    want = _np(jax_spectral_mix_axis(jnp.asarray(x), jnp.asarray(wy), axis, impl="dft"))
    got = spectral_mix_axis(torch.from_numpy(x), torch.from_numpy(wy), axis).numpy()
    _close_to_max(got, want)


def test_fused_mix_2d_non_square_matches_two_jax_branches():
    x, wy, wx = _mix_inputs(sx=12, sy=10, m=3, seed=5)
    want = sum(_np(jax_spectral_mix_axis(jnp.asarray(x), jnp.asarray(w), a, impl="dft"))
               for w, a in ((wy, 2), (wx, 1)))
    got = fused_mix_2d(*map(torch.from_numpy, (x, wy, wx))).numpy()
    _close_to_max(got, want)


def test_fused_mix_2d_bf16_sums_in_f32_and_rounds_once():
    """In bf16 the two branches are summed in float32 and rounded once, as
    the kernel does; the weights are rounded to bf16 first."""
    x, wy, wx = map(torch.from_numpy, _mix_inputs(sx=12, sy=10, m=3, seed=9))
    xb = x.bfloat16()
    f32 = lambda t: t.bfloat16().float()
    want = (spectral_mix_axis(xb.float(), f32(wy), 2)
            + spectral_mix_axis(xb.float(), f32(wx), 1)).bfloat16()
    got = fused_mix_2d(xb, wy, wx)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_spectral_mix_axis_matches_torch_fft():
    """The basis form equals the rfft -> mix -> irfft definition."""
    x, w, _ = _mix_inputs(sx=16, sy=16, m=5, seed=7)
    xt, wt = torch.from_numpy(x).double(), torch.from_numpy(w).double()
    s = torch.fft.rfft(xt, dim=2, norm="ortho")[:, :, :5]
    y = torch.einsum("bxmi,iom->bxmo", s, torch.view_as_complex(wt.contiguous()))
    want = torch.fft.irfft(y, n=16, dim=2, norm="ortho").numpy()
    got = spectral_mix_axis(torch.from_numpy(x), torch.from_numpy(w), 2).numpy()
    _close_to_max(got, want)


# --- guards ----------------------------------------------------------------------
_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "fourierflow_tpu")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in _FORBIDDEN)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_forbidden_matcher():
    assert _forbidden("jax.numpy") and _forbidden("fourierflow_tpu.ops") and _forbidden("flax")
    assert not _forbidden("fourierflow_tpu_torch.ops") and not _forbidden("jaxtyping")


def test_port_never_imports_jax_or_the_jax_package():
    files = sorted((REPO / "fourierflow_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = [(str(p.relative_to(REPO)), m) for p in files for m in _imports(p) if _forbidden(m)]
    assert not bad, bad


def test_infer_raises_without_gpu_unless_cpu_requested(monkeypatch, tmp_path):
    from fourierflow_tpu_torch.commands.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = tmp_path / "u.npy"
    np.save(data, np.zeros((4, 8, 8, 4), np.float32))
    args = ["infer", str(REPO / "configs/torus_li/markov/24_layers.yaml"),
            f"builder.data_path={data}", "--n-steps", "2"]
    with pytest.raises(RuntimeError, match="CUDA"):
        main(args)


def test_kernel_wrappers_reject_unsupported_devices():
    x = torch.zeros(2, 4, 4, 8, device="meta")
    w = torch.zeros(8, 8, 2, 2, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_mix_2d(x, w, w)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_ff(x, *(torch.zeros(s, device="meta") for s in ((8, 16), (16,), (16, 8), (8,))))


def test_fused_ff_kernel_argument_checks():
    """What the CUDA wrapper checks before a launch, exercised on CPU tensors."""
    from fourierflow_tpu_torch.ops.fused_ff import _check_args

    x, w1, b1, w2, b2 = map(torch.from_numpy, _ff_inputs(6))
    _check_args(x, w1, b1, w2, b2)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        _check_args(x.double(), w1, b1, w2, b2)
    with pytest.raises(ValueError, match="w2 is"):
        _check_args(x, w1, b1, w2[:-1], b2)
    with pytest.raises(ValueError, match="b1 is torch.bfloat16"):
        _check_args(x, w1, b1.bfloat16(), w2, b2)
    with pytest.raises(ValueError, match="contiguous x"):
        _check_args(x.t().contiguous().t(), w1, b1, w2, b2)
    # Weights go in through their strides: transposed views of [out, in] are taken.
    _check_args(x, w1.t().contiguous().t(), b1, w2.t().contiguous().t(), b2)
    with pytest.raises(ValueError, match="C_out <= 64"):
        _check_args(x, w1, b1, torch.zeros(w2.shape[0], 65), torch.zeros(65))
    # Tensors that need a gradient are taken: the backward kernel exists.
    _check_args(x.requires_grad_(), w1.requires_grad_(), b1, w2, b2)
    with torch.no_grad():
        _check_args(x, w1, b1, w2, b2)


def test_fused_mix_kernel_argument_checks():
    from fourierflow_tpu_torch.ops.fused_spectral import _check_args

    x, wy, wx = map(torch.from_numpy, _mix_inputs(sx=12, sy=10, m=3))
    _check_args(x, wy, wx)
    with pytest.raises(ValueError, match=r"\[B, X, Y, C\]"):
        _check_args(x[0], wy, wx)
    with pytest.raises(ValueError, match="contiguous"):
        _check_args(x.transpose(1, 2).contiguous().transpose(1, 2), wy, wx)
    with pytest.raises(ValueError, match="wx must be"):
        _check_args(x, wy, wx[:4])
    with pytest.raises(ValueError, match="axis length 10 allows 6"):
        _check_args(x, torch.zeros(8, 8, 7, 2), wx)
    _check_args(x.bfloat16(), wy, wx.bfloat16())
    with pytest.raises(TypeError, match="float32 or x's"):
        _check_args(x, wy.bfloat16(), wx)
    with pytest.raises(TypeError, match="float32 or x's"):
        _check_args(x, wy, wx.double())
    # Tensors that need a gradient are taken: the adjoint launch exists.
    _check_args(x.requires_grad_(), wy.requires_grad_(), wx)
