"""Widths the LSTM kernels take only padded, the mixed compute and residual
modes, the float32 persistent plans and the float32 layer sweep, on the
CPU against the JAX package.

* Padding (``lstm_recurrence.HiddenPad``): every LSTM wrapper's padded
  branch (its ``PAD_KINDS``) run through the plain versions at H=48,
  D=40, where the card's kernels pad to 64, against the JAX layer
  (``lstm_layer_pallas``, both residual modes) and stack
  (``lstm_stack_wavefront_train``, L=2, drop modes 0 and 1, both
  backwards) in TPU interpret mode: outputs, final states and gradients;
  and each wrapper's padded plain version against the unpadded one.
* Mixed modes: ``lstm_layer_train`` and ``lstm_stack_wavefront_train``
  with bf16 compute and float32 residuals, and the reverse, against JAX.
* Plans: ``bwd_f32_plan`` (shared memory within a block's, grid within
  the card, row groups) and what ``bwd_plan``/``wavefront_bwd_plan``
  answer with it.
* The layer sweep's decomposition in plain PyTorch: each layer's reverse
  walk (``recurrence_bwd_plain``) then ``sweep_dout_plain`` for the layer
  below's cotangent and the xdrop stream, against JAX's ``_wavefront_bwd``
  in drop modes 0, 1 and 2 (mode 2's keep bits read back from JAX's own
  xdrop stream).

Tolerances, relative to each tensor's largest magnitude: float32 1e-4
(another summation order over T = 12 steps, readings ~1e-6); bf16 compute
or residuals 2e-2 (the same bf16 roundings of values that differ in the
last float32 bit now and then flip one rounding, 2^-8, which the
recurrence carries); padded against unpadded plain versions 1e-6 (zero
terms added to the same sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rnn_speech_tpu.ops import lstm_pallas as jpal
from rnn_speech_tpu.ops import lstm_wavefront as jwave
from rnn_speech_tpu_torch import params as tparams
from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt
from rnn_speech_tpu_torch.ops import lstm_recurrence as trec
from rnn_speech_tpu_torch.ops import lstm_wavefront as twave

f32, bf16 = torch.float32, torch.bfloat16
T, B, D, H, L = 12, 4, 40, 48, 2
LENS = np.asarray([12, 7, 0, 12], np.int32)
F32_TOL, BF16_TOL, PAD_TOL = 1e-4, 2e-2, 1e-6
JDT = {f32: jnp.float32, bf16: jnp.bfloat16}


def _rel(got, ref):
    ref = np.asarray(ref, np.float32)
    got = got.detach().to(torch.float32).numpy()
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _check(ref_tree, got, tol):
    ref = jax.tree.leaves(ref_tree)
    assert len(ref) == len(got)
    worst = max(_rel(g, r) for g, r in zip(got, ref))
    assert worst <= tol, worst


def _padded(name, plain, width_h, width_d=None):
    """``plain`` behind the wrapper ``name``'s padded branch: its arguments
    padded by ``PAD_KINDS[name]`` (drop mode 1's masks along H, as the
    wavefront wrappers pad them), its results sliced back, and the gates
    argument of the backwards overwritten with dgates, as the wrappers
    do."""
    pad = trec.HiddenPad(width_h, width_d)
    kinds, out_kinds = trec.PAD_KINDS[name]
    in_place = {"recurrence_bwd": 1, "wavefront_bwd": 4}.get(name)

    def run(*args, **kw):
        args = list(args)
        if name.startswith("wavefront_") and len(args) > len(kinds) + 2 and args[-4] == 1:
            args[-3] = pad.pad(args[-3], "h")        # drop mode 1's (L-1, T, B, H) masks
        out = pad.call(plain, args, kinds, out_kinds, **kw)
        if in_place is None:
            return out
        return (args[in_place].copy_(out[0]),) + out[1:]

    return run


def _layer_problem(seed=0):
    rng = np.random.default_rng(seed)
    lim = np.sqrt(6.0 / (5 * H))
    params = {"w_x": rng.uniform(-lim, lim, (D, 4 * H)), "w_h": rng.uniform(-lim, lim, (H, 4 * H)),
              "b": rng.normal(0, 0.1, (4 * H,))}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rng.normal(size=(T, B, D)).astype(np.float32)
    state = (np.full((B, H), 0.2, np.float32), np.full((B, H), -0.1, np.float32))
    wy = (rng.normal(size=(T, B, H)) * 0.1).astype(np.float32)
    return params, x, state, wy


def _layer_vs_jax(mode, cd, rd, tol):
    params, x, state, wy = _layer_problem()

    def jloss(p, xx, st):
        out, (c, h) = jpal.lstm_layer_pallas(p, xx, jnp.asarray(LENS), st, compute_dtype=JDT[cd],
                                             residual_dtype=JDT[rd], residual_mode=mode)
        return jnp.sum(out * wy) + jnp.sum(c ** 2) + jnp.sum(jnp.abs(h)), (out, c, h)

    with pltpu.force_tpu_interpret_mode():
        (_, ref_vals), ref_g = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                                          has_aux=True))(
            jax.tree.map(jnp.asarray, params), jnp.asarray(x), tuple(map(jnp.asarray, state)))
    tp = {k: v.requires_grad_() for k, v in tparams.params_from_jax(params, "cpu").items()}
    tx = torch.tensor(x, requires_grad=True)
    ts = tuple(torch.tensor(s, requires_grad=True) for s in state)
    out, (c, h) = tlt.lstm_layer_train(tp, tx, torch.as_tensor(LENS), ts, compute_dtype=cd,
                                       residual_dtype=rd, residual_mode=mode)
    ((out * torch.as_tensor(wy)).sum() + (c ** 2).sum() + h.abs().sum()).backward()
    _check(ref_vals, [out, c, h], tol)
    _check(ref_g, [tp["b"].grad, tp["w_h"].grad, tp["w_x"].grad, tx.grad, ts[0].grad,
                   ts[1].grad], tol)


def _pad_layer_wrappers(monkeypatch):
    for name in ("recurrence_train", "recurrence_train_lean", "recurrence_bwd",
                 "recurrence_bwd_recompute"):
        monkeypatch.setattr(tlt, name, _padded(name, getattr(tlt, name + "_plain"), H, D))


@pytest.mark.parametrize("mode", ["gates", "recompute"])
def test_padded_layer_matches_lstm_layer_pallas(monkeypatch, mode):
    """The layer's four wrappers through their padded branches (H=48 ->
    64, D=40 -> 64) in float32 against JAX at the true widths."""
    _pad_layer_wrappers(monkeypatch)
    _layer_vs_jax(mode, f32, f32, F32_TOL)


@pytest.mark.parametrize("cd,rd", [(bf16, f32), (f32, bf16)], ids=["bf16_f32", "f32_bf16"])
@pytest.mark.parametrize("mode", ["gates", "recompute"])
def test_mixed_layer_matches_lstm_layer_pallas(mode, cd, rd):
    """The mixed compute and residual modes of the layer (the kernels' mixed
    instances' plain versions) against JAX's."""
    _layer_vs_jax(mode, cd, rd, BF16_TOL)


def _stack_vs_jax(cd, rd, tol, drop_mode, bwd_wavefront):
    rng = np.random.default_rng(1)
    lim = np.sqrt(6.0 / (5 * H))
    layers = [{"w_x": rng.uniform(-lim, lim, (D if l == 0 else H, 4 * H)),
               "w_h": rng.uniform(-lim, lim, (H, 4 * H)), "b": rng.normal(0, 0.1, (4 * H,))}
              for l in range(L)]
    layers = [{k: v.astype(np.float32) for k, v in p.items()} for p in layers]
    x = rng.normal(size=(T, B, D)).astype(np.float32)
    states = [tuple((rng.normal(size=(B, H)) * 0.1).astype(np.float32) for _ in "ch")
              for _ in range(L)]
    wy = (rng.normal(size=(T, B, H)) * 0.1).astype(np.float32)
    masks = (rng.uniform(size=(L - 1, T, B, H)) < 0.6).astype(np.float32) if drop_mode else None
    kw = dict(drop_masks=masks, drop_scale=1 / 0.6) if drop_mode else {}

    def jloss(p, xx, sts):
        out, new = jwave.lstm_stack_wavefront_train(
            p, xx, jnp.asarray(LENS), sts, compute_dtype=JDT[cd], residual_dtype=JDT[rd],
            bwd_wavefront=bwd_wavefront,
            **({k: (jnp.asarray(v) if k == "drop_masks" else v) for k, v in kw.items()}))
        loss = jnp.sum(out.astype(jnp.float32) * wy) + sum(
            jnp.sum(c) * 0.3 + jnp.sum(h) * 0.7 for c, h in new)
        return loss, (out, new)

    with pltpu.force_tpu_interpret_mode():
        (_, ref_vals), ref_g = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                                          has_aux=True))(
            jax.tree.map(jnp.asarray, layers), jnp.asarray(x),
            [tuple(map(jnp.asarray, s)) for s in states])
    tl = tparams.params_from_jax({"lstm": layers}, "cpu")["lstm"]
    tl = [{k: v.requires_grad_() for k, v in p.items()} for p in tl]
    tx = torch.tensor(x, requires_grad=True)
    ts = [tuple(torch.tensor(s, requires_grad=True) for s in st) for st in states]
    tkw = {k: (torch.as_tensor(v) if k == "drop_masks" else v) for k, v in kw.items()}
    out, new = twave.lstm_stack_wavefront_train(tl, tx, torch.as_tensor(LENS), ts,
                                                compute_dtype=cd, residual_dtype=rd,
                                                bwd_wavefront=bwd_wavefront, **tkw)
    loss = (out.float() * torch.as_tensor(wy)).sum() + sum(c.sum() * 0.3 + h.sum() * 0.7
                                                           for c, h in new)
    loss.backward()
    _check(ref_vals, [out] + [t for st in new for t in st], tol)
    _check(ref_g, [p[k].grad for p in tl for k in ("b", "w_h", "w_x")] + [tx.grad]
           + [t.grad for st in ts for t in st], tol)


@pytest.mark.parametrize("bwd_wavefront", [True, False])
@pytest.mark.parametrize("drop_mode", [0, 1])
def test_padded_stack_matches_jax(monkeypatch, drop_mode, bwd_wavefront):
    """The wavefront stack's wrappers (and, off the reverse diagonal, the
    layer backward's) through their padded branches in float32 against
    JAX's stack at the true widths."""
    for name in ("wavefront_train", "wavefront_bwd"):
        monkeypatch.setattr(twave, name, _padded(name, getattr(twave, name + "_plain"), H, D
                                                 if name == "wavefront_train" else None))
    monkeypatch.setattr(tlt, "recurrence_bwd", _padded("recurrence_bwd", tlt.recurrence_bwd_plain,
                                                       H))
    _stack_vs_jax(f32, f32, F32_TOL, drop_mode, bwd_wavefront)


@pytest.mark.parametrize("cd,rd", [(bf16, f32), (f32, bf16)], ids=["bf16_f32", "f32_bf16"])
def test_mixed_stack_matches_jax(cd, rd):
    _stack_vs_jax(cd, rd, BF16_TOL, 1, True)


def _rows(dtype, seed=5):
    """Each wrapper's (name, plain version, positional arguments) at H=48,
    D=40 in ``dtype`` (weights and residuals)."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, scale=1.0: torch.randn(s, generator=g) * scale
    w = lambda *s: (r(*s, scale=0.1)).to(dtype)
    mask = (torch.arange(T)[:, None] < torch.as_tensor(LENS)[None]).float()[:, None, :]
    xp, w_h, h0, c0 = r(T, B, 4 * H), w(H, 4 * H), r(B, H, scale=0.2), r(B, H, scale=0.2)
    _, _, _, gates, cseq = tlt.recurrence_train_plain(xp, w_h, mask, h0, c0, dtype)
    x, w_x, b = r(T, B, D).to(dtype), w(D, 4 * H), r(4 * H, scale=0.1)
    dh = (r(T, B, H, scale=0.1), r(B, H, scale=0.1), r(B, H, scale=0.1))
    stack = (x, w_x, w(L, H, 4 * H), w(L - 1, H, 4 * H), r(L, 4 * H), mask,
             r(L, B, H, scale=0.2), r(L, B, H, scale=0.2), dtype)
    outs, sgates, scseq, _, _ = twave.wavefront_train_plain(*stack)
    return [
        ("lstm_recurrence", trec.lstm_recurrence_plain, (xp, w_h, mask, h0, c0)),
        ("lstm_stack_wavefront", twave.lstm_stack_wavefront_plain,
         (xp, stack[2], stack[3], r(L - 1, 1, 4 * H), mask, stack[6], stack[7])),
        ("recurrence_train", tlt.recurrence_train_plain, (xp, w_h, mask, h0, c0, dtype)),
        ("recurrence_train_lean", tlt.recurrence_train_lean_plain,
         (xp.to(dtype), w_h, mask, h0, c0, dtype)),
        ("recurrence_bwd", tlt.recurrence_bwd_plain,
         (dh[0], gates.clone(), cseq, c0, mask, w_h, dh[1], dh[2])),
        ("recurrence_bwd_recompute", tlt.recurrence_bwd_recompute_plain,
         (dh[0], x, cseq, cseq, c0, mask, w_x, b, w_h, dh[1], dh[2])),
        ("rebuild_gates", lambda *a: (tlt.rebuild_gates_plain(*a),),
         (x[0], cseq[0], w_x, w_h, b)),
        ("wavefront_train", twave.wavefront_train_plain, stack),
        ("wavefront_bwd", twave.wavefront_bwd_plain,
         (dh[0], stack[2], stack[3], mask, sgates.clone(), scseq, stack[7], stack[6],
          stack[7], outs)),
    ]


@pytest.mark.parametrize("dtype", [f32, bf16], ids=["f32", "bf16"])
def test_padded_plain_versions_equal_unpadded(dtype):
    """Each wrapper's padded branch (its ``PAD_KINDS``) around its plain
    version gives the unpadded plain version's results: the padded units
    stay zero and leave the real ones alone."""
    for name, plain, args in _rows(dtype):
        pad_d = D if name in ("recurrence_bwd_recompute", "rebuild_gates",
                              "wavefront_train") else None
        got = _padded(name, plain, H, pad_d)(*[a.clone() if torch.is_tensor(a) else a
                                               for a in args])
        ref = plain(*[a.clone() if torch.is_tensor(a) else a for a in args])
        assert len(got) == len([r for r in ref if r is not None]), name
        for gt, rt in zip(got, ref):
            assert gt.shape == rt.shape and gt.dtype == rt.dtype, name
            scale = float(rt.float().abs().max()) or 1.0
            assert float((gt.float() - rt.float()).abs().max()) <= PAD_TOL * scale, name


def test_hidden_pad_layout():
    """Gate block by gate block: column g·H + j of a 4H axis lands at
    g·Hp + j; rows of D past D and units past H are zero."""
    pad = trec.HiddenPad(48, 40)
    assert (pad.Hp, pad.Dp, pad.needed) == (64, 64, True)
    assert not trec.HiddenPad(128, 64).needed
    w = torch.arange(40 * 4 * 48, dtype=f32).reshape(40, 4 * 48)
    p = pad.pad(w, "wd")
    assert p.shape == (64, 256)
    for g in range(4):
        assert torch.equal(p[:40, 64 * g:64 * g + 48], w[:, 48 * g:48 * g + 48])
        assert not p[:, 64 * g + 48:64 * (g + 1)].any()
    assert not p[40:].any()
    assert torch.equal(pad.unpad(p, "wd"), w)


PLAN_B = (1, 63, 64, 65, 128, 394, 400, 473)


@pytest.mark.parametrize("H_", [64, 128, 256, 512, 1024, 2048])
def test_f32_persistent_plan_arithmetic(H_):
    """``bwd_f32_plan``: H/64 slices of 8 CTAs on the card, the W_h slice
    (64 units x H/2 K, rows padded by 4 floats), four 64x68 float32 boxes
    and the (64, 64) second-half sums within a block's shared memory,
    ceil(B/64) row groups; H=2048 neither fits the grid nor the shared
    memory, H=64 is no multiple of 128."""
    for Bn in PLAN_B:
        plan = tlt.bwd_f32_plan(Bn, H_)
        smem = 4 * (64 * (H_ // 2 + 4) + 4 * 64 * 68 + 64 * 64)
        if H_ % 128 or H_ // 64 * 8 > trec.H100_SMS:
            assert plan == {"kernel": "per_step"}
            continue
        assert smem <= trec.SMEM_LIMIT
        assert plan == {"kernel": "persistent_f32", "groups": -(-Bn // 64), "slices": H_ // 64,
                        "grid": H_ // 64 * 8, "stages": 4, "smem": smem}
        assert tlt.bwd_plan(Bn, H_, dtype=f32, recompute=True) == plan
        assert tlt.bwd_plan(Bn, H_, dtype=f32) == {"kernel": "per_step"}   # row 6: next PR
        assert twave.wavefront_bwd_plan(Bn, H_, 3, dtype=f32) == {"kernel": "layer_sweep",
                                                                  "chain": plan}
    assert tlt.bwd_f32_plan(64, 1024, sms=100) == {"kernel": "per_step"}   # 128 CTAs > 100


def _jax_bwd(drop_mode, seed=7):
    """JAX's forward residuals and reverse diagonal (``_wavefront_train``,
    ``_wavefront_bwd``, TPU interpret mode) at L=3, float32, drop mode
    ``drop_mode``; numpy in and out."""
    Lj, Hj = 3, 64
    rng = np.random.default_rng(seed)
    lim = np.sqrt(6.0 / (5 * Hj))
    u = lambda *s: rng.uniform(-lim, lim, s).astype(np.float32)
    n = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    x, w_x0, w_h, w_x_rest = n(T, B, Hj), u(Hj, 4 * Hj), u(Lj, Hj, 4 * Hj), u(Lj - 1, Hj, 4 * Hj)
    b_all = n(Lj, 1, 4 * Hj, scale=0.1)
    mask = (np.arange(T)[:, None] < LENS[None]).astype(np.float32)[:, None, :]
    h0, c0 = n(Lj, B, Hj, scale=0.2), n(Lj, B, Hj, scale=0.2)
    dout, dhn, dcn = n(T, B, Hj, scale=0.1), n(Lj, B, Hj, scale=0.1), n(Lj, B, Hj, scale=0.1)
    keep = 0.6
    drop_arr = {0: None, 1: (rng.uniform(size=(Lj - 1, T, B, Hj)) < keep).astype(np.float32),
                2: np.asarray([11, 23], np.int32)}[drop_mode]
    scale = 1 / keep if drop_mode else 1.0
    j = lambda a: None if a is None else jnp.asarray(a)
    with pltpu.force_tpu_interpret_mode():
        outs, gates, cseqs, _, _ = jwave._wavefront_train(
            j(x), j(w_x0), j(w_h), j(w_x_rest), j(b_all), drop_mode, j(drop_arr), scale, keep,
            j(mask), j(h0), j(c0), jnp.float32)
        dgates, xdrops, _, dh0, dc0 = jwave._wavefront_bwd(
            j(dout), j(w_h), j(w_x_rest), drop_mode, j(drop_arr), scale, keep, j(mask),
            list(gates), list(cseqs), list(outs), j(c0), j(dhn), j(dcn))
    arr = lambda t: np.stack([np.asarray(a) for a in t]) if len(t) else None
    return dict(w_h=w_h, w_x_rest=w_x_rest, mask=mask, c0=c0, dout=dout, dhn=dhn, dcn=dcn,
                outs=arr(outs), gates=arr(gates), cseq=arr(cseqs), scale=scale,
                drop_arr=drop_arr, keep=keep, dgates=arr(dgates), xdrop=arr(xdrops),
                dh0=np.asarray(dh0), dc0=np.asarray(dc0))


@pytest.mark.parametrize("drop_mode", [0, 1, 2])
def test_layer_sweep_decomposition_matches_wavefront_bwd(drop_mode):
    """The float32 layer sweep in plain PyTorch, from the top layer down:
    the layer's reverse walk (``recurrence_bwd_plain``), then the layer
    below's cotangent (dgates·W_xᵀ)·keep·scale and the xdrop stream
    outs·keep·scale (``sweep_dout_plain``), against JAX's reverse diagonal
    in drop modes 0-2: every layer's dgates, dh0, dc0 and the xdrop
    stream JAX emits in modes 1 and 2 (mode 2's keep bits read back from
    it: keep·scale = xdrop / outs where outs is not zero; rows past their
    length see no cotangent)."""
    ref = _jax_bwd(drop_mode)
    t = lambda k: torch.as_tensor(ref[k])
    Lj = ref["w_h"].shape[0]
    keep_scale = None
    if drop_mode == 1:
        keep_scale = t("drop_arr") * ref["scale"]
    elif drop_mode == 2:
        outs = t("outs")[:Lj - 1]
        keep_scale = torch.where(outs != 0, t("xdrop") / torch.where(outs != 0, outs, 1.0), 0.0)
    gates = t("gates").clone()
    dout = t("dout")
    dh0, dc0, xdrop = [None] * Lj, [None] * Lj, [None] * (Lj - 1)
    for l in reversed(range(Lj)):
        _, dh0[l], dc0[l] = tlt.recurrence_bwd_plain(dout, gates[l], t("cseq")[l], t("c0")[l],
                                                     t("mask"), t("w_h")[l], t("dhn")[l],
                                                     t("dcn")[l])
        if l > 0:
            ks = None if keep_scale is None else keep_scale[l - 1]
            dout, xdrop[l - 1] = twave.sweep_dout_plain(gates[l], t("w_x_rest")[l - 1],
                                                        t("outs")[l - 1], ks)
    for got, want in ((gates, ref["dgates"]), (torch.stack(dh0), ref["dh0"]),
                      (torch.stack(dc0), ref["dc0"])):
        assert _rel(got, want) <= F32_TOL
    if drop_mode:
        assert _rel(torch.stack(xdrop), ref["xdrop"]) <= F32_TOL
