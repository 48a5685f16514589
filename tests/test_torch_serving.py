"""The port's serving path and reference-checkpoint interop against the JAX
package's, on the CPU.

- The four kernels are ``fourierflow_tpu_torch`` operators with CPU, CUDA
  and Meta implementations; gradients through them equal, to the bit,
  those of the plain versions wired as autograd Functions directly.
- A reference (Lightning) checkpoint with the reference's names, F-FNO
  and FNO-4, loads through the JAX package's ``import_reference_checkpoint``
  and the port's: the same forward outputs and normalizer statistics; a
  mismatched one raises and names its keys.
- ``make_rollout_fn`` against the JAX package's with the same weights and
  normalizer; ``export_rollout``/``load_exported`` round trip on the CPU,
  with one operator node a layer and step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourierflow_tpu.layers import normalizer_init as jax_normalizer_init
from fourierflow_tpu.models import FNOFactorized2DBlock as JaxBlock
from fourierflow_tpu.models import FNOZongyi2DBlock as JaxZongyi
from fourierflow_tpu.routines import Grid2DMarkovRoutine as JaxRoutine
from fourierflow_tpu.routines.base import TrainState
from fourierflow_tpu.utils.serving import make_rollout_fn as jax_make_rollout_fn
from fourierflow_tpu.utils.torch_import import \
    import_reference_checkpoint as jax_import_reference_checkpoint
from fourierflow_tpu_torch.layers import normalizer_init
from fourierflow_tpu_torch.models import FNOFactorized2DBlock, FNOZongyi2DBlock
from fourierflow_tpu_torch.ops import fused_ff, fused_mix_2d
from fourierflow_tpu_torch.ops.fused_ff import fused_ff_bwd_plain, fused_ff_plain
from fourierflow_tpu_torch.ops.fused_spectral import (fused_mix_2d_adjoint_plain,
                                                      fused_mix_2d_plain)
from fourierflow_tpu_torch.ops.spectral import mix_axis_wgrad
from fourierflow_tpu_torch.routines import Grid2DMarkovRoutine
from fourierflow_tpu_torch.routines.base import State
from fourierflow_tpu_torch.utils.serving import export_rollout, load_exported, make_rollout_fn
from fourierflow_tpu_torch.utils.torch_import import (import_reference_checkpoint,
                                                      load_reference_state_dict)
from fourierflow_tpu_torch.utils.weights import state_dict_from_flax

MODES, WIDTH, IN_DIM, N_LAYERS, FACTOR, GRID = 4, 8, 3, 2, 2, 16
FFNO = dict(modes=MODES, width=WIDTH, input_dim=IN_DIM, n_layers=N_LAYERS, share_weight=True,
            factor=FACTOR, ff_weight_norm=True)
ZONGYI = dict(modes1=3, modes2=3, width=6, input_dim=4, n_layers=2, dropout=0.0)
OPS = torch.ops.fourierflow_tpu_torch
OP_NAMES = ("fused_ff", "fused_ff_bwd", "fused_mix_2d", "fused_mix_2d_adjoint")
# Port against JAX after a reference checkpoint's import: forward outputs and
# normalizer statistics, float32 on the CPU.
IMPORT_RTOL, IMPORT_ATOL = 1e-5, 1e-6
# Serving rollout against the JAX package's over 3 steps (as the eval rollout's test).
ROLLOUT_RTOL, ROLLOUT_ATOL = 1e-4, 1e-4
# The loaded artifact against the live module it was exported from.
ARTIFACT_RTOL = 1e-6


# --- operators -----------------------------------------------------------------------
@pytest.mark.parametrize("name", OP_NAMES)
@pytest.mark.parametrize("key", ["CPU", "CUDA", "Meta"])
def test_kernels_are_operators_with_three_implementations(name, key):
    assert torch._C._dispatch_has_kernel_for_dispatch_key(f"fourierflow_tpu_torch::{name}", key)


def _ff_args(rows=21, cin=8, hidden=32, cout=8, seed=0):
    rng = np.random.RandomState(seed)
    t = lambda *s, scale=1.0: torch.from_numpy((rng.randn(*s) * scale).astype(np.float32))
    # Weights as the model passes them: transposed views of [out, in] tensors.
    return (t(rows, cin), t(hidden, cin, scale=0.3).t(), t(hidden, scale=0.1),
            t(cout, hidden, scale=0.3).t(), t(cout, scale=0.1))


def _mix_args(b=2, sx=16, sy=12, c=8, m=4, seed=0):
    rng = np.random.RandomState(seed)
    t = lambda *s, scale=1.0: torch.from_numpy((rng.randn(*s) * scale).astype(np.float32))
    return t(b, sx, sy, c), t(c, c, m, 2, scale=0.1), t(c, c, m, 2, scale=0.1)


def test_meta_implementations_give_shapes_only():
    x, w1, b1, w2, b2 = (a.to("meta") for a in _ff_args(cout=16))
    out = OPS.fused_ff(x, w1, b1, w2, b2)
    assert out.device.type == "meta" and out.shape == (21, 16) and out.dtype == torch.float32
    g = torch.empty(21, 16, device="meta")
    grads = OPS.fused_ff_bwd(x, g, w1, b1, w2)
    assert [tuple(t.shape) for t in grads] == [(21, 8), (8, 32), (32,), (32, 16), (16,)]
    assert [t.dtype for t in grads] == [torch.float32] * 5
    x, wy, wx = (a.to("meta").bfloat16() if i == 0 else a.to("meta")
                 for i, a in enumerate(_mix_args()))
    for op in (OPS.fused_mix_2d, OPS.fused_mix_2d_adjoint):
        out = op(x, wy, wx)
        assert out.shape == x.shape and out.dtype == torch.bfloat16 and out.device.type == "meta"


def test_operators_raise_on_other_backends():
    """A tensor that is neither on the CPU nor on CUDA (nor a shape-only
    meta tensor) finds no implementation."""
    x, w1, b1, w2, b2 = _ff_args()
    with pytest.raises(NotImplementedError, match="fused_ff"):
        OPS.fused_ff(x.to_sparse(), w1, b1, w2, b2)
    x, wy, wx = _mix_args()
    with pytest.raises(NotImplementedError, match="fused_mix_2d"):
        OPS.fused_mix_2d(x.to_sparse(), wy, wx)


class _PlainFF(torch.autograd.Function):
    """The feed-forward Function as it was before the operators: the plain
    versions called directly."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2)
        ctx.b2_dtype = b2.dtype
        return fused_ff_plain(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w2 = ctx.saved_tensors
        dx, dw1, db1, dw2, db2 = fused_ff_bwd_plain(x, g.contiguous(), w1, b1, w2)
        return dx, dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype), db2.to(ctx.b2_dtype)


class _PlainMix(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wy, wx):
        ctx.save_for_backward(x, wy, wx)
        return fused_mix_2d_plain(x, wy, wx)

    @staticmethod
    def backward(ctx, g):
        x, wy, wx = ctx.saved_tensors
        g = g.contiguous()
        return (fused_mix_2d_adjoint_plain(g, wy, wx),
                mix_axis_wgrad(x, g, wy.shape[2], 2, round_to=x.dtype).to(wy.dtype),
                mix_axis_wgrad(x, g, wx.shape[2], 1, round_to=x.dtype).to(wx.dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["ff", "mix"])
def test_gradients_through_operators_equal_plain_functions(case, dtype):
    fn, plain, args = ((fused_ff, _PlainFF.apply, _ff_args()) if case == "ff"
                       else (fused_mix_2d, _PlainMix.apply, _mix_args()))
    args = [a.to(dtype) if i == 0 or case == "ff" else a for i, a in enumerate(args)]
    go = torch.from_numpy(np.random.RandomState(5).randn(*fn(*args).shape).astype(np.float32))

    def grads(f):
        leaves = [a.detach().requires_grad_() for a in args]
        out = f(*leaves)
        return (out, *torch.autograd.grad(out, leaves, go.to(out.dtype)))

    for got, want in zip(grads(fn), grads(plain), strict=True):
        assert got.dtype == want.dtype
        torch.testing.assert_close(got, want, rtol=0, atol=0)


# --- reference checkpoints --------------------------------------------------------------
def _t(rng, *shape, scale=1.0):
    return torch.tensor((rng.randn(*shape) * scale).astype(np.float32))


def _wn_linear(rng, sd, base, in_f, out_f):
    """A weight-normed linear layer at the scale of torch's default init:
    ``g`` near the row norms of ``v``, as ``weight_norm`` starts it."""
    v = _t(rng, out_f, in_f, scale=in_f ** -0.5)
    sd[f"{base}.weight_v"] = v
    sd[f"{base}.weight_g"] = torch.linalg.vector_norm(v, dim=1, keepdim=True) * (
        1 + _t(rng, out_f, 1, scale=0.1))
    sd[f"{base}.bias"] = _t(rng, out_f, scale=in_f ** -0.5)


def ffno_reference_state_dict(seed=3):
    """A Lightning F-FNO state dict with the reference's names: share_weight,
    weight-normed feed-forwards, each shared tensor under every path, and
    the normalizer's buffers."""
    rng = np.random.RandomState(seed)
    sd = {}
    _wn_linear(rng, sd, "conv.in_proj", IN_DIM, WIDTH)
    wy, wx = _t(rng, WIDTH, WIDTH, MODES, 2, scale=0.2), _t(rng, WIDTH, WIDTH, MODES, 2, scale=0.2)
    sd["conv.fourier_weight.0"], sd["conv.fourier_weight.1"] = wy, wx
    for i in range(N_LAYERS):
        sd[f"conv.spectral_layers.{i}.fourier_weight.0"] = wy
        sd[f"conv.spectral_layers.{i}.fourier_weight.1"] = wx
        base = f"conv.spectral_layers.{i}.backcast_ff"
        _wn_linear(rng, sd, f"{base}.layers.0.0", WIDTH, WIDTH * FACTOR)
        _wn_linear(rng, sd, f"{base}.layers.1.0", WIDTH * FACTOR, WIDTH)
    _wn_linear(rng, sd, "conv.out.0", WIDTH, 128)
    _wn_linear(rng, sd, "conv.out.1", 128, 1)
    sd["normalizer.sum"] = _t(rng, IN_DIM, scale=10)
    sd["normalizer.sum_squared"] = torch.abs(_t(rng, IN_DIM)) * 100 + 50
    sd["normalizer.count"] = torch.tensor(37.0)
    return sd


def zongyi_reference_state_dict(seed=5):
    rng = np.random.RandomState(seed)
    w, m, sd = ZONGYI["width"], ZONGYI["modes1"], {}

    def lin(base, i, o):
        sd[f"{base}.weight"], sd[f"{base}.bias"] = _t(rng, o, i, scale=0.3), _t(rng, o, scale=0.1)

    lin("conv.in_proj", ZONGYI["input_dim"], w)
    for i in range(ZONGYI["n_layers"]):
        for j in range(2):
            sd[f"conv.spectral_layers.{i}.fourier_weight.{j}"] = _t(rng, w, w, m, m, 2, scale=0.1)
        lin(f"conv.spectral_layers.{i}.linear", w, w)
    lin("conv.feedforward.0", w, 128)
    lin("conv.feedforward.2", 128, 1)
    return sd


def _save_lightning(tmp_path, sd, name="ref.ckpt"):
    path = tmp_path / name
    # Lightning's metadata is more than weights-only loading takes.
    torch.save({"state_dict": sd, "epoch": 11, "hyper_parameters": {"modes": MODES},
                "loops": {"fit_loop": _Opaque()}}, path)
    return str(path)


class _Opaque:
    """Stands for the pickled objects of a Lightning checkpoint."""


def _jax_ffno_state(width=WIDTH):
    model = JaxBlock(**dict(FFNO, width=width))
    init = model.init(jax.random.PRNGKey(1), jnp.zeros((1, GRID, GRID, IN_DIM)))
    return model, TrainState(params=init, opt_state=None, normalizer=jax_normalizer_init(IN_DIM),
                             step=0)


def _port_ffno_state(width=WIDTH):
    return State(FNOFactorized2DBlock(**dict(FFNO, width=width)), normalizer_init(IN_DIM))


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=IMPORT_RTOL,
                               atol=IMPORT_ATOL, err_msg=what)


def test_ffno_reference_checkpoint_matches_jax_import(tmp_path):
    path = _save_lightning(tmp_path, ffno_reference_state_dict())
    model, jstate = _jax_ffno_state()
    jstate = jax_import_reference_checkpoint(path, jstate)
    state = import_reference_checkpoint(path, _port_ffno_state())
    x = np.random.RandomState(0).randn(2, GRID, GRID, IN_DIM).astype(np.float32)
    want = model.apply(jstate.params, jnp.asarray(x))["forecast"]
    with torch.no_grad():
        got = state.model.eval()(torch.from_numpy(x))["forecast"]
    _close(got.numpy(), want, "forecast")
    for f in ("mean", "std", "count", "n_accumulations"):
        _close(getattr(state.normalizer, f).numpy(), getattr(jstate.normalizer, f), f)
    assert float(state.normalizer.n_accumulations) == 37.0


def test_zongyi_reference_checkpoint_matches_jax_import(tmp_path):
    path = _save_lightning(tmp_path, zongyi_reference_state_dict())
    model = JaxZongyi(**ZONGYI)
    x = np.random.RandomState(1).randn(2, 12, 12, ZONGYI["input_dim"]).astype(np.float32)
    init = model.init(jax.random.PRNGKey(0), jnp.asarray(x))
    jstate = jax_import_reference_checkpoint(
        path, TrainState(params=init, opt_state=None, normalizer=None, step=0))
    state = import_reference_checkpoint(path, State(FNOZongyi2DBlock(**ZONGYI), None))
    want = model.apply(jstate.params, jnp.asarray(x))
    want = want["forecast"] if isinstance(want, dict) else want
    with torch.no_grad():
        got = state.model.eval()(torch.from_numpy(x))
    got = got["forecast"] if isinstance(got, dict) else got
    _close(got.numpy(), want, "forecast")
    assert state.normalizer is None


def test_bare_state_dict_loads_without_lightning_wrapper(tmp_path):
    sd = ffno_reference_state_dict()
    torch.save(sd, tmp_path / "bare.pt")
    got = load_reference_state_dict(str(tmp_path / "bare.pt"))
    assert sorted(got) == sorted(sd)
    assert all(torch.equal(got[k], sd[k]) for k in sd)


def test_mismatched_reference_checkpoint_names_its_keys(tmp_path):
    sd = ffno_reference_state_dict()
    path = _save_lightning(tmp_path, sd)
    with pytest.raises(ValueError, match=r"mismatch: shape of in_proj\.weight_g: checkpoint "
                                         r"\(8, 1\) vs model \(16, 1\)"):
        import_reference_checkpoint(path, _port_ffno_state(width=16))
    partial = {k: v for k, v in sd.items() if k != "conv.out.1.bias"}
    with pytest.raises(ValueError, match=r"missing in checkpoint: \['out\.1\.bias'\]"):
        import_reference_checkpoint(_save_lightning(tmp_path, partial, "p.ckpt"),
                                    _port_ffno_state())
    extra = dict(sd, **{"conv.spectral_layers.0.extra": torch.zeros(2)})
    with pytest.raises(ValueError, match=r"unexpected in checkpoint: \['spectral_layers\.0\.extra"):
        import_reference_checkpoint(_save_lightning(tmp_path, extra, "e.ckpt"), _port_ffno_state())
    with pytest.raises(ValueError, match="holds a FNOZongyi2DBlock"):
        import_reference_checkpoint(_save_lightning(tmp_path, zongyi_reference_state_dict(),
                                                    "z.ckpt"), _port_ffno_state())
    with pytest.raises(ValueError, match="Unrecognized reference checkpoint"):
        import_reference_checkpoint(_save_lightning(tmp_path, {"a.b": torch.zeros(1)}, "u.ckpt"),
                                    _port_ffno_state())


# --- serving ----------------------------------------------------------------------------
def _routines(learn_difference=False):
    """JAX and port routines with the same weights and normalizer."""
    jr = JaxRoutine(JaxBlock(**FFNO), n_steps=4, max_accumulations=100,
                    learn_difference=learn_difference)
    rng = np.random.RandomState(0)
    batch = {"x": rng.randn(2, GRID, GRID, 1).astype(np.float32),
             "y": rng.randn(2, GRID, GRID, 1).astype(np.float32)}
    js = jr.accumulate_step(jr.init(jax.random.PRNGKey(0), batch), batch)
    pr = Grid2DMarkovRoutine(FNOFactorized2DBlock(**FFNO), n_steps=4, max_accumulations=100,
                             learn_difference=learn_difference)
    ps = pr.init(0, batch, "cpu")
    ps.model.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, js.params), N_LAYERS))
    ps = pr.accumulate_step(ps, batch)
    _close(ps.normalizer.mean.numpy(), js.normalizer.mean, "normalizer mean")
    return jr, js, pr, ps


def _w0(batch=2, seed=1):
    return np.random.RandomState(seed).randn(batch, GRID, GRID, 1).astype(np.float32)


@pytest.mark.parametrize("learn_difference", [False, True])
def test_rollout_fn_matches_jax(learn_difference):
    jr, js, pr, ps = _routines(learn_difference)
    w0 = _w0()
    want = np.asarray(jax_make_rollout_fn(jr, js, 3)(jnp.asarray(w0)))
    with torch.no_grad():
        got = make_rollout_fn(pr, ps, 3)(torch.from_numpy(w0)).numpy()
    assert got.shape == (2, GRID, GRID, 3)
    np.testing.assert_allclose(got, want, rtol=ROLLOUT_RTOL, atol=ROLLOUT_ATOL)


def test_rollout_fn_matches_eval_rollout():
    """The serving module (weight norm folded in once) gives the eval
    rollout's predictions to the bit."""
    _, _, pr, ps = _routines()
    w0 = torch.from_numpy(_w0())
    data = torch.cat([w0, torch.zeros(2, GRID, GRID, 3)], dim=-1)
    pr.n_steps = 3
    want = pr.rollout(ps, {"data": data})[0]
    with torch.no_grad():
        got = make_rollout_fn(pr, ps, 3)(w0)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _operator_nodes(program):
    counts = {}
    for node in program.graph.nodes:
        if node.op == "call_function" and "fourierflow_tpu_torch" in str(node.target):
            name = str(node.target).split(".")[1]
            counts[name] = counts.get(name, 0) + 1
    return counts


def test_export_roundtrip_matches_live_module(tmp_path):
    _, _, pr, ps = _routines()
    n_steps = 3
    path = export_rollout(pr, ps, str(tmp_path / "rollout.pt2"), n_steps=n_steps, batch_size=2,
                          size=GRID, device="cpu", precision="highest")
    artifact = load_exported(path)
    assert artifact.device == torch.device("cpu")
    assert _operator_nodes(artifact.program) == {"fused_mix_2d": N_LAYERS * n_steps,
                                                 "fused_ff": N_LAYERS * n_steps}
    w0 = torch.from_numpy(_w0())
    with torch.no_grad():
        live = make_rollout_fn(pr, ps, n_steps)(w0)
    got = artifact(w0)
    torch.testing.assert_close(got, live, rtol=ARTIFACT_RTOL, atol=0)
    with pytest.raises(ValueError, match="serves on cpu"):
        artifact(w0.to("meta"))


def test_export_refuses_other_precisions_and_devices(tmp_path):
    _, _, pr, ps = _routines()
    with pytest.raises(ValueError, match="precision 'high' is not supported"):
        export_rollout(pr, ps, str(tmp_path / "a.pt2"), 2, 1, GRID, precision="high")
    with pytest.raises(ValueError, match="export it on that device"):
        export_rollout(pr, ps, str(tmp_path / "a.pt2"), 2, 1, GRID, device="cuda")
    (tmp_path / "not.pt2").write_bytes(b"")
    with pytest.raises(ValueError, match="not a rollout exported by export_rollout"):
        load_exported(str(tmp_path / "not.pt2"))


def test_rollout_fn_refuses_a_force_channel():
    """The serving module refuses a force where its routine appends none,
    and a force laid out [X, Y] (the JAX export's declaration, with which
    its serving function raises): it takes [b, X, Y]."""
    _, _, pr, ps = _routines()
    w0 = torch.from_numpy(_w0())
    with pytest.raises(ValueError, match="takes w0 alone"):
        make_rollout_fn(pr, ps, 2)(w0, torch.zeros(2, GRID, GRID))
    pr.append_force = True
    with pytest.raises(ValueError, match=r"force must be \[b, X, Y\]"):
        make_rollout_fn(pr, ps, 2)(w0, torch.zeros(GRID, GRID))
