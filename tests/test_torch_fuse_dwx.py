"""The fused dW_x of the port's reverse diagonal (the TPU kernel's
``fuse_dwx`` mode): its switch, its plain route against the JAX package's
fused route, and its equality with the unfused route.

With ``RST_WAVEFRONT_FUSE_DWX=1`` on both sides, the JAX
``lstm_stack_wavefront_train`` (its ``_wavefront_stack_core`` VJP, Pallas
kernels in TPU interpret mode) and the port's plain route run drop mode 0
at L=3, H=32, B=4, T=12 with ragged lengths and a zero-length row, on the
same numpy-seeded weights, states and cotangent; each side must really
take its fused route (``_hgrad_only`` runs).  Drop mode 2's bits cannot be
reproduced across the packages, so there the port's fused route must equal
its unfused route on the same seed words.

Tolerances, as in ``tests/test_torch_wavefront_dropout.py``: float32 1e-5
(the same arithmetic in another summation order); bf16 2e-3 (both sides
round the same operands to bf16 and sum in float32; a rounding flip of one
bf16 residual, 2^-8 relative, is the only divergence).  The fused and
unfused routes of the port round the same operands and sum each boundary's
product in one float32 matmul: 1e-5 in both dtypes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rnn_speech_tpu.ops import lstm_wavefront as jwave
from rnn_speech_tpu_torch.ops import grad_matmul as tgm
from rnn_speech_tpu_torch.ops import lstm as tlstm
from rnn_speech_tpu_torch.ops import lstm_wavefront as twave
from rnn_speech_tpu_torch.train import optim as toptim

DTYPES = {"f32": (jnp.float32, torch.float32, dict(rtol=1e-5, atol=1e-5)),
          "bf16": (jnp.bfloat16, torch.bfloat16, dict(rtol=2e-3, atol=2e-3))}
ROUTES = dict(rtol=1e-5, atol=1e-5)
L, T, B, D, H = 3, 12, 4, 6, 32
LENS = np.asarray([12, 7, 0, 10], np.int32)
KP = 0.4                      # ko·ki = 0.5 · 0.8


def _problem(seed):
    rng = np.random.default_rng(seed)
    layers = [{"w_x": rng.normal(0, 0.3, (D if l == 0 else H, 4 * H)),
               "w_h": rng.normal(0, 0.3, (H, 4 * H)),
               "b": rng.normal(0, 0.1, (4 * H,))} for l in range(L)]
    layers = jax.tree.map(lambda a: a.astype(np.float32), layers)
    x = rng.normal(0, 1, (T, B, D)).astype(np.float32)
    states = [tuple(rng.normal(0, 0.2, (B, H)).astype(np.float32) for _ in "ch")
              for _ in range(L)]
    cot = rng.normal(0, 1, (T, B, H)).astype(np.float32)
    return layers, x, states, cot


def _loss(out, new_states, xp, cot):
    return (xp.sum(out * cot)
            + sum(xp.sum(c) * 0.3 + xp.sum(h) * 0.7 for c, h in new_states))


def _spy(module, name, monkeypatch):
    """Counts the calls of ``module.name``."""
    calls = []
    fn = getattr(module, name)

    def counted(*args, **kw):
        calls.append(1)
        return fn(*args, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


def _port_run(layers, x, states, cot, td, **drop):
    tl = toptim.tree_map(lambda a: torch.tensor(a, requires_grad=True), layers)
    tx = torch.tensor(x, requires_grad=True)
    ts = toptim.tree_map(lambda a: torch.tensor(a, requires_grad=True), states)
    out, ns = twave.lstm_stack_wavefront_train(tl, tx, torch.as_tensor(LENS), ts,
                                               compute_dtype=td, **drop)
    _loss(out.float(), ns, torch, torch.as_tensor(cot)).backward()
    leaves = [out.float(), *[t for pair in ns for t in pair]]
    return leaves + toptim.tree_leaves(toptim.tree_map(lambda t: t.grad, (tl, tx, ts)))


@pytest.mark.parametrize("dtype,fused_wgrad", [("f32", "1"), ("bf16", "1"), ("f32", "0")])
def test_fused_route_matches_jax_fused_route(dtype, fused_wgrad, monkeypatch):
    """Values and every gradient (weights, biases, input, initial states)
    of the stack on the fused reverse pass, in drop mode 0, against the
    JAX package's fused route; ``RST_FUSED_WGRAD`` picks dW_h and db's form
    on both sides."""
    jd, td, tol = DTYPES[dtype]
    monkeypatch.setenv("RST_WAVEFRONT_FUSE_DWX", "1")
    monkeypatch.setenv("RST_FUSED_WGRAD", fused_wgrad)
    jax_fused = _spy(jwave, "_hgrad_only", monkeypatch)
    port_fused = _spy(twave, "_hgrad_only", monkeypatch)
    layers, x, states, cot = _problem(21)

    def jloss(layers, x, states):
        out, ns = jwave.lstm_stack_wavefront_train(
            layers, x, jnp.asarray(LENS), states, compute_dtype=jd, interpret=True)
        return _loss(out.astype(jnp.float32), ns, jnp, cot), (out, ns)

    with pltpu.force_tpu_interpret_mode():
        (_, (ref_out, ref_ns)), ref_g = jax.jit(jax.value_and_grad(
            jloss, argnums=(0, 1, 2), has_aux=True))(
            jax.tree.map(jnp.asarray, layers), jnp.asarray(x),
            jax.tree.map(jnp.asarray, states))
    got = _port_run(layers, x, states, cot, td)
    assert len(jax_fused) == len(port_fused) == L - 1
    ref = ([np.asarray(ref_out, np.float32)]
           + [np.asarray(t, np.float32) for pair in ref_ns for t in pair]
           + [np.asarray(a, np.float32) for a in jax.tree.leaves(ref_g)])
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.detach().float().numpy(), r, **tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mode2_fused_route_equals_unfused_route(dtype, monkeypatch):
    """In drop mode 2 the fused route's values and gradients equal the
    unfused route's on the same seed words; only the fused one runs
    ``_hgrad_only``, and dropout changes the result."""
    _, td, _ = DTYPES[dtype]
    layers, x, states, cot = _problem(22)
    drop = dict(drop_seed=(1234, 98765), drop_keep=KP, drop_scale=1.0 / KP)
    runs = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("RST_WAVEFRONT_FUSE_DWX", flag)
        with monkeypatch.context() as m:
            calls = _spy(twave, "_hgrad_only", m)
            runs[flag] = _port_run(layers, x, states, cot, td, **drop)
        assert len(calls) == (L - 1 if flag == "1" else 0)
    for a, b in zip(runs["1"], runs["0"]):
        np.testing.assert_allclose(a.detach().float().numpy(), b.detach().float().numpy(),
                                   **ROUTES)
    none = _port_run(layers, x, states, cot, td)
    assert not torch.equal(runs["1"][0], none[0])


GiB10_B = 83       # the smallest flagship batch at or over 10 GiB of residuals


@pytest.mark.parametrize("env,L_,B_,mode,want", [
    (None, 3, GiB10_B - 1, 2, False), (None, 3, GiB10_B, 2, True),
    (None, 3, GiB10_B, 0, True), (None, 3, 400, 1, False), (None, 1, 400, 0, False),
    ("1", 3, 4, 0, True), ("1", 3, 4, 2, True), ("1", 3, 4, 1, False),
    ("1", 1, 4, 0, False), ("0", 3, 400, 2, False), ("0", 3, 400, 0, False),
])
def test_switch_decision(env, L_, B_, mode, want, monkeypatch):
    """``fuse_dwx_enabled`` copies the JAX package's switch: forced by
    RST_WAVEFRONT_FUSE_DWX=0/1, else on from L·T·B·6H·2 >= 10 GiB at the
    flagship T=3510, H=1024 in bf16 (B >= 83); never in drop mode 1 or
    for one layer."""
    if env is None:
        monkeypatch.delenv("RST_WAVEFRONT_FUSE_DWX", raising=False)
    else:
        monkeypatch.setenv("RST_WAVEFRONT_FUSE_DWX", env)
    assert 3 * 3510 * (GiB10_B - 1) * 6 * 1024 * 2 < 10 << 30 <= \
        3 * 3510 * GiB10_B * 6 * 1024 * 2
    assert twave.fuse_dwx_enabled(L_, 3510, B_, 1024, 2, mode) is want


def _bwd_case(mode, seed=3):
    """Residuals of the plain training forward (bf16) and the backward's
    cotangents at L=3, H=32, B=4, T=12 with ragged lengths."""
    g = torch.Generator().manual_seed(seed)
    bf = torch.bfloat16
    r = lambda *s, scale: (torch.randn(s, generator=g) * scale)
    mask = tlstm.length_mask(T, torch.as_tensor(LENS), "cpu")
    w_h, w_x_rest = r(L, H, 4 * H, scale=0.3).to(bf), r(L - 1, H, 4 * H, scale=0.3).to(bf)
    h0, c0 = r(L, B, H, scale=0.2), r(L, B, H, scale=0.2)
    drop = (2, (5, 6), 1.0 / KP, KP) if mode == 2 else (0, None, 1.0, 1.0)
    outs, gates, cseq, _, _ = twave.wavefront_train_plain(
        r(T, B, H, scale=1.0).to(bf), r(H, 4 * H, scale=0.3).to(bf), w_h, w_x_rest,
        r(L, 4 * H, scale=0.1), mask, h0, c0, bf, *drop)
    args = (r(T, B, H, scale=1.0).to(bf), w_h, w_x_rest, mask, gates, cseq, c0,
            r(L, B, H, scale=0.5), r(L, B, H, scale=0.5), outs, *drop)
    return args, outs


@pytest.mark.parametrize("mode", [0, 2])
def test_fused_pass_returns_dwx_and_allocates_no_xdrop_stream(mode):
    """The fused plain pass returns (dgates, dh0, dc0, dwx) with dwx (L-1,
    H, 4H) float32 equal to the weight-gradient pass over the unfused
    pass's xdrop (mode 2) or outs (mode 0), and dgates, dh0, dc0 bit-equal
    to the unfused pass's; no result has the (L-1, T, B, H) stream's
    shape.  The kernel wrapper's buffers at the flagship B=394 (on the meta
    device): a (L-1, W, B, H) ring in mode 2, none in mode 0, never the
    (L-1, T, B, H) stream, which the unfused mode-2 pass does allocate."""
    args, outs = _bwd_case(mode)
    clone = lambda: [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
    fused = twave.wavefront_bwd_plain(*clone(), fuse_dwx=True)
    plain = twave.wavefront_bwd_plain(*clone())
    assert len(fused) == 4 and fused[3].shape == (L - 1, H, 4 * H)
    assert fused[3].dtype == torch.float32
    assert all(tuple(t.shape) != (L - 1, T, B, H) for t in fused)
    for a, b in zip(fused[:3], plain[:3]):
        assert torch.equal(a, b)
    x_in = plain[3] if mode == 2 else outs[:L - 1]
    for l in range(1, L):
        want = tgm.weight_grad_plain(x_in[l - 1], plain[0][l])[0]
        np.testing.assert_allclose(fused[3][l - 1].numpy(), want.numpy(), **ROUTES)

    Lf, Tf, Bf, Hf = 3, 3510, 394, 1024
    ring, dwx, window = twave._bwd_buffers(Lf, Tf, Bf, Hf, mode, True, "meta")
    assert window == twave.FUSE_DWX_WINDOW < Tf
    assert dwx.shape == (Lf - 1, Hf, 4 * Hf) and dwx.dtype == torch.float32
    if mode == 2:
        assert ring.shape == (Lf - 1, window, Bf, Hf) and ring.dtype == torch.bfloat16
    else:
        assert ring is None
    stream, none, _ = twave._bwd_buffers(Lf, Tf, Bf, Hf, 2, False, "meta")
    assert stream.shape == (Lf - 1, Tf, Bf, Hf) and none is None


def test_fused_mode_refuses_drop_mode_1_and_needs_outs():
    args, _ = _bwd_case(0)
    with pytest.raises(ValueError, match="drop mode 0 or 2"):
        twave.wavefront_bwd_plain(*args[:9], args[9], 1, torch.ones((L - 1, T, B, H)),
                                  2.5, 1.0, fuse_dwx=True)
    with pytest.raises(ValueError, match="outs"):
        twave.wavefront_bwd_plain(*args[:9], None, fuse_dwx=True)


def test_window_products_alone_equal_the_fused_pass_dwx():
    """``dwx_windows`` (the fused pass's window products alone, for timing
    and card tests) takes its plain version on the CPU: in drop mode 0 it
    gives the fused plain pass's dW_x from the outs residual and that
    pass's dgates."""
    args, outs = _bwd_case(0)
    fused = twave.wavefront_bwd_plain(*[a.clone() if isinstance(a, torch.Tensor) else a
                                        for a in args], fuse_dwx=True)
    got = twave.dwx_windows(outs, fused[0])
    assert got.shape == (L - 1, H, 4 * H) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), fused[3].numpy(), **ROUTES)
