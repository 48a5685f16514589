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
    """In bf16 the hidden layer is rounded to bf16 before the second
    product, as the JAX kernel rounds it; the sums stay float32."""
    args = [torch.from_numpy(a).to(torch.bfloat16) for a in _ff_inputs(9)]
    out = fused_ff_plain(*args)
    assert out.dtype == torch.bfloat16
    x, w1, b1, w2, b2 = (a.float() for a in args)
    h = torch.relu(x @ w1 + b1).bfloat16().float()
    torch.testing.assert_close(out, (h @ w2 + b2).bfloat16(), rtol=0, atol=0)


@pytest.mark.parametrize("rows", [300, 1037])
def test_fused_ff_bf16_matches_jax_interpret(rows):
    """bf16 forward against the JAX kernel in interpret mode (1,037 rows:
    a ragged, zero-padded JAX block): both round the hidden layer to bf16,
    so the outputs agree to the bit."""
    args = _ff_inputs(rows, cin=16, hidden=64, cout=16, seed=rows)
    want = jax_fused_ff(*(jnp.asarray(a, jnp.bfloat16) for a in args), True)
    want = _np(want.astype(jnp.float32))
    got = fused_ff(*(torch.from_numpy(a).bfloat16() for a in args))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


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


@pytest.mark.parametrize("n,m", [(16, 4), (16, 9), (15, 4)])
def test_fused_mix_2d_bf16_matches_jax_interpret(n, m):
    """bf16 forward against the JAX kernel in interpret mode: both round the
    bases, the spectra and the mixed spectra to bf16 (``_branch``), sum the
    two branches in float32 and round once, so the outputs agree to the
    bit. The weights stay float32 parameters, rounded to bf16 inside."""
    x, wy, wx = _mix_inputs(sx=n, sy=n, m=m, seed=n + m)
    want = jax_fused_mix_2d(jnp.asarray(x, jnp.bfloat16), jnp.asarray(wy), jnp.asarray(wx), True)
    want = _np(want.astype(jnp.float32))
    got = fused_mix_2d(torch.from_numpy(x).bfloat16(), *map(torch.from_numpy, (wy, wx)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


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

    x, w1, b1, w2, b2 = map(torch.from_numpy, _ff_inputs(6, cin=16, hidden=64, cout=16))
    _check_args(x, w1, b1, w2, b2)
    _check_args(x.bfloat16(), *(t.bfloat16() for t in (w1, b1, w2, b2)))
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

    # The forward kernel's shape limits: its fragments tile C_in by 16, H by 64
    # and C_out by 8, it reads x in 16-byte pieces, and all of W1 and W2 sit
    # in one block's shared memory.
    def ff(rows=6, cin=16, hidden=64, cout=16, dtype=torch.float32):
        a = [torch.from_numpy(t).to(dtype) for t in _ff_inputs(rows, cin, hidden, cout)]
        _check_args(*a)

    ff(cin=64, hidden=256, cout=64)
    ff(cin=64, hidden=256, cout=64, dtype=torch.bfloat16)
    ff(cin=32, hidden=128, cout=40)
    for cin in (8, 24, 80):
        with pytest.raises(ValueError, match="C_in a multiple of 16 and <= 64"):
            ff(cin=cin)
    for hidden in (48, 96):
        with pytest.raises(ValueError, match="H a multiple of 64"):
            ff(hidden=hidden)
    with pytest.raises(ValueError, match="C_out a multiple of 8"):
        ff(cout=12)
    ff(cin=64, hidden=320, cout=64)
    with pytest.raises(ValueError, match="shared memory"):
        ff(cin=64, hidden=384, cout=64)
    ff(cin=64, hidden=704, cout=64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shared memory"):
        ff(cin=64, hidden=768, cout=64, dtype=torch.bfloat16)
    unaligned = torch.zeros(6 * 16 + 1)[1:].view(6, 16)
    with pytest.raises(ValueError, match="aligned to 16 bytes"):
        _check_args(unaligned, w1, b1, w2, b2)
    # The backward kernel has its own limits: it takes C_in 8 and H 48.
    xb, w1b, b1b, w2b, _ = map(torch.from_numpy, _ff_inputs(6, cin=8, hidden=48, cout=8))
    _check_args(xb, w1b, b1b, w2b, g=torch.zeros(6, 8))
    # Any C_in and C_out up to 64 (zero-padded to 64 in shared memory), and H up
    # to what six staged 64x64 tiles and the float32 sums of every 64-wide chunk
    # of H leave room for: 256 in float32, 320 in bf16.
    from fourierflow_tpu_torch.ops.fused_ff import _bwd_smem_bytes

    def bwd(rows=6, cin=16, hidden=64, cout=16, dtype=torch.float32):
        a = [torch.from_numpy(t).to(dtype) for t in _ff_inputs(rows, cin, hidden, cout)[:4]]
        _check_args(*a, g=torch.zeros(rows, cout, dtype=dtype))

    bwd(cin=64, hidden=256, cout=64)
    bwd(cin=32, hidden=128, cout=40)
    bwd(cin=24, hidden=100, cout=12, dtype=torch.bfloat16)
    bwd(cin=64, hidden=320, cout=64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shared memory"):
        bwd(cin=8, hidden=257, cout=8)
    with pytest.raises(ValueError, match="shared memory"):
        bwd(cin=8, hidden=321, cout=8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="C_in <= 64"):
        bwd(cin=80)
    with pytest.raises(ValueError, match="C_out <= 64"):
        bwd(cout=72)
    # The formula, at the flagship (H 256) and the narrow shape (H 128): the
    # tiles (6 x 64 x 64 f32, or 6 x 64 x 72 bf16), 2 x 64 x H + H + 64 sums
    # and H of b1, 4 bytes each.
    assert _bwd_smem_bytes(256, torch.float32) == 98_304 + 4 * (33_088 + 256)
    assert _bwd_smem_bytes(256, torch.bfloat16) == 55_296 + 4 * (33_088 + 256)
    assert _bwd_smem_bytes(128, torch.float32) == 98_304 + 4 * (16_576 + 128)
    assert _bwd_smem_bytes(128, torch.bfloat16) == 55_296 + 4 * (16_576 + 128)
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
    with pytest.raises(ValueError, match="has 0 modes"):
        _check_args(x.detach(), torch.zeros(8, 8, 0, 2), wx)

    # The kernel's own limits: a block walks the modes in chunks, each thread
    # mixes one mode of a chunk for at most three output channels, C <= 3 *
    # (512 // chunk), and a block's rings, bases and spectra fit in 232,448
    # bytes of shared memory. Shapes beyond one chunk take several.
    def mix(b=1, sx=64, sy=64, c=64, m=16, dtype=torch.float32, w_dtype=torch.float32):
        _check_args(torch.zeros(b, sx, sy, c, dtype=dtype),
                    *(torch.zeros(c, c, m, 2, dtype=w_dtype) for _ in range(2)))

    mix()
    mix(dtype=torch.bfloat16)
    mix(sx=63, sy=65)
    mix(sx=32, sy=32, m=17)
    mix(sx=128, sy=128)
    mix(c=48, m=32, dtype=torch.bfloat16, w_dtype=torch.bfloat16)
    mix(c=49, m=32, dtype=torch.bfloat16, w_dtype=torch.bfloat16)  # two chunks of 16
    mix(c=72)
    mix(c=72, dtype=torch.bfloat16, w_dtype=torch.bfloat16)
    mix(sx=160)
    mix(b=2, sx=256, sy=256, m=64)  # the torus_kochkov grids
    mix(b=8, sx=128, sy=128, m=32)
    with pytest.raises(ValueError, match=r"C above 3 \* 512 = 1536"):
        mix(c=1537, m=1, sx=4, sy=4)
    with pytest.raises(ValueError, match="wx at n=5000, C=64 needs 250256 B of shared memory"):
        mix(sx=5000, sy=8, m=2)


def test_fused_mix_kernel_smem_formula():
    """The wrapper's mirror of the kernel's shared-memory layout: the weight
    ring (2 x 4 input channels x C x 2M in the weights' type), the x ring
    (2 x 10 lines x 8 samples x C in x's type), the bases [n, 2M padded to
    8] and [2M, n padded to 8], and the spectra [10, C, 2 (M | 1)], in f32, and 10 int64 line
    offsets.
    ``chip_smoke.py`` holds it to the kernel's own at every checked shape."""
    from fourierflow_tpu_torch.ops.fused_spectral import _smem_bytes

    f32, bf16 = torch.float32, torch.bfloat16
    # The flagship (n 64, M 16, C 64).
    assert _smem_bytes(64, 16, 64, f32, f32) == 65_536 + 40_960 + 8_192 + 8_192 + 87_040 + 80
    assert _smem_bytes(64, 16, 64, bf16, f32) == 65_536 + 20_480 + 8_192 + 8_192 + 87_040 + 80
    assert _smem_bytes(64, 16, 64, bf16, bf16) == 32_768 + 20_480 + 8_192 + 8_192 + 87_040 + 80
    # An odd n (padded to 72 samples), 17 modes (34 columns padded to 40;
    # rows of 34), and a small grid with rows of 2 x 5.
    assert _smem_bytes(65, 16, 64, f32, f32) == 65_536 + 40_960 + 8_320 + 9_216 + 87_040 + 80
    assert _smem_bytes(32, 17, 64, f32, f32) == 69_632 + 40_960 + 5_120 + 4_352 + 87_040 + 80
    assert _smem_bytes(7, 4, 64, f32, f32) == 16_384 + 40_960 + 224 + 256 + 25_600 + 80


@pytest.mark.parametrize("n,modes,dtype,chunk", [
    (32, 16, torch.float32, 16), (64, 16, torch.float32, 16), (128, 16, torch.float32, 16),
    (128, 32, torch.float32, 16), (128, 32, torch.bfloat16, 16), (256, 16, torch.float32, 8),
    (256, 32, torch.float32, 12), (256, 64, torch.float32, 12), (256, 64, torch.bfloat16, 12),
    (64, 33, torch.float32, 12), (32, 17, torch.float32, 17)])
def test_fused_mix_kernel_mode_chunks(n, modes, dtype, chunk):
    """The modes a block takes at once (``mode_chunk`` in the source): all
    of them where they fit (the flagship), else the largest multiple of 4
    that fits, evened out over the chunks (64 modes at n 256: 12 x 5 + 4;
    16 modes: 8 + 8). ``_smem_bytes`` is the layout at that chunk, within a
    block's shared memory. ``chip_smoke.py`` holds both to the kernel's."""
    from fourierflow_tpu_torch.ops import _cuda
    from fourierflow_tpu_torch.ops.fused_spectral import _layout_bytes, _mode_chunk, _smem_bytes

    assert _mode_chunk(n, modes, 64, dtype, torch.float32) == chunk
    size = torch.finfo(dtype).bits // 8
    assert _smem_bytes(n, modes, 64, dtype, torch.float32) == _layout_bytes(n, chunk, 64, size, 4)
    assert _smem_bytes(n, modes, 64, dtype, torch.float32) <= _cuda.MAX_SMEM
    if chunk < modes:  # as few chunks as the largest multiple of 4 that fits needs
        best = max(mc for mc in range(4, modes, 4)
                   if _layout_bytes(n, mc, 64, size, 4) <= _cuda.MAX_SMEM)
        assert -(-modes // chunk) == -(-modes // best)
