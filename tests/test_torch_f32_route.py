"""The float32 compute mode of the LSTM and weight-gradient kernels (rows
1-8, 14 and 15 of ``PERF.md``'s table): its routing and its arithmetic
against the JAX package, on the CPU.

* Routing: a float32 compute dtype never reaches a bf16 persistent or
  tensor-core plan: the recompute backward (row 8) takes the float32
  persistent kernel and the reverse diagonal (row 4) the float32 layer
  sweep where ``bwd_f32_plan`` takes the shape, the training forward (row
  3) the float32 layer sweep where ``fwd_f32_plan`` takes it, the rest the
  per-step and per-diagonal kernels; the projections' weight gradients the
  float32 skinny tile and every other product the float32 tile; the bf16
  plans are unchanged at the shapes the plan tests use; mixed compute and
  residual dtypes are a mode of their own, on the per-step kernels.
* Arithmetic: ``lstm_layer_train`` (gates and recompute residuals) at the
  on-card parity tool's LSTM shape (T=96, B=8, D=16, H=256) and
  ``lstm_stack_wavefront_train`` at its wavefront shape (L=3, D=H=128,
  T=64, B=8), both with float32 compute and residuals, against JAX's
  ``lstm_layer_pallas`` and ``lstm_stack_wavefront_train`` with their
  Pallas kernels in TPU interpret mode, with weights carried over by
  ``params.params_from_jax``.  The port's wrappers take their plain
  versions on the CPU: the same float32 arithmetic as the kernels, in
  another summation order than JAX's, so outputs, final states and
  gradients agree within 1e-4 of each tensor's largest magnitude (the
  readings are ~1e-6; T=96 steps of H=256 sums).
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
from rnn_speech_tpu_torch.ops import grad_matmul as gm
from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt
from rnn_speech_tpu_torch.ops import lstm_recurrence as trec
from rnn_speech_tpu_torch.ops import lstm_wavefront as twave

f32, bf16 = torch.float32, torch.bfloat16
TOL = 1e-4

# Shapes of the existing plan tests (the layered, recompute, eval, default,
# wide and card-test batches) at which the bf16 plans must not move.
BATCHES = (1, 8, 16, 64, 70, 96, 128, 129, 200, 260, 394, 400, 473)
WIDTHS = (64, 128, 256, 512, 1024, 1152)


@pytest.mark.parametrize("H", WIDTHS)
@pytest.mark.parametrize("B", BATCHES)
def test_float32_never_reaches_a_persistent_plan(B, H):
    """No bf16 persistent kernel takes float32: rows 1, 2, 5-7 stay on the
    per-step and per-diagonal kernels; rows 8 and 4 go to the float32
    persistent backward and its layer sweep, and row 3 to the float32
    persistent forward's layer sweep (whatever D), exactly where their
    plans fit (H a multiple of 128, H/64 x 8 and H/32 x 4 CTAs on the card:
    the same widths), any batch in ceil(B/64) row groups, else to the
    per-diagonal kernels; the fused dW_x stays bf16 only."""
    for x_f32 in (False, True):
        assert trec.lean_plan(B, H, x_f32=x_f32, dtype=f32) == {"kernel": "per_step"}
    assert tlt.bwd_plan(B, H, dtype=f32) == {"kernel": "per_step"}
    assert twave.wavefront_eval_plan(B, H, 3, dtype=f32) == {"kernel": "per_diagonal"}
    chain, fwd = tlt.bwd_f32_plan(B, H), tlt.fwd_f32_plan(B, H)
    fits = H % 128 == 0 and H // 64 * 8 <= 132
    assert tlt.bwd_plan(B, H, dtype=f32, recompute=True) == chain
    if fits:
        assert chain == {"kernel": "persistent_f32", "groups": -(-B // 64), "slices": H // 64,
                         "grid": H // 64 * 8, "stages": 4, "smem": tlt.bwd_f32_smem(H)}
        assert chain["smem"] <= trec.SMEM_LIMIT
        assert twave.wavefront_bwd_plan(B, H, 3, False, dtype=f32) == {"kernel": "layer_sweep",
                                                                        "chain": chain}
        assert fwd == {"kernel": "persistent_f32", "groups": -(-B // 64), "slices": H // 32,
                       "grid": H // 32 * 4, "stages": 8, "smem": tlt.fwd_f32_smem(H)}
        assert fwd["smem"] <= trec.SMEM_LIMIT
        for D in (H, 120):
            assert twave.wavefront_plan(B, H, 3, D, dtype=f32) == {"kernel": "layer_sweep",
                                                                   "chain": fwd}
            assert twave.wavefront_plan(B, H, 3, D, dtype=f32, res_dtype=f32) == {
                "kernel": "layer_sweep", "chain": fwd}
    else:
        assert chain == {"kernel": "per_step"} and fwd == {"kernel": "per_step"}
        assert twave.wavefront_bwd_plan(B, H, 3, False, dtype=f32) == {"kernel": "per_diagonal"}
        assert twave.wavefront_plan(B, H, 3, H, dtype=f32) == {"kernel": "per_diagonal"}
    assert twave.wavefront_bwd_plan(B, H, 3, True, dtype=f32) == {"kernel": "per_diagonal"}


@pytest.mark.parametrize("H", WIDTHS)
@pytest.mark.parametrize("B", BATCHES)
def test_bf16_plans_are_unchanged(B, H):
    """The dtype keyword defaults to bf16 and changes nothing there."""
    for x_f32 in (False, True):
        assert trec.lean_plan(B, H, x_f32=x_f32, dtype=bf16) == trec.lean_plan(B, H, x_f32=x_f32)
    assert tlt.bwd_plan(B, H, dtype=bf16) == tlt.bwd_plan(B, H)
    assert twave.wavefront_eval_plan(B, H, 3, dtype=bf16) == twave.wavefront_eval_plan(B, H, 3)
    assert twave.wavefront_plan(B, H, 3, H, dtype=bf16) == twave.wavefront_plan(B, H, 3, H)
    for fuse in (False, True):
        assert (twave.wavefront_bwd_plan(B, H, 3, fuse, dtype=bf16)
                == twave.wavefront_bwd_plan(B, H, 3, fuse))


@pytest.mark.parametrize("dims,N,G", [([1024, 1024], 224640, 4096), ([120], 224640, 1024),
                                      ([1024], 224640, 80), ([256, 120], 768, 1024),
                                      ([1024], 3510 * 96, 4096), ([7], 100003, 13),
                                      ([256], 5000, 1024), ([257], 4099, 300),
                                      ([1024], 3510 * 394, 80), ([120, 1024], 224640, 80)])
def test_weight_grads_in_float32_take_the_float32_tile(dims, N, G):
    """Every float32-compute product runs a float32 tile (never the Hopper,
    skinny or WMMA tiles, which round to bf16): one operand with a narrow
    side of at most 256 columns (the projections) the float32 skinny tile,
    every other product (two operands: row 14; both sides wide: the dW_x of
    layers 1..L-1) the float32 tile; its K split into slices of a multiple
    of its K step that cover N once; the bf16 plans stay as they were."""
    path = "skinny_f32" if len(dims) == 1 and min(dims[0], G) <= 256 else "f32"
    for dg_dtype in (f32, bf16):
        assert gm.product_path(dims, G, dg_dtype, f32) == path
        pl = gm.plan(dims, N, G, dg_dtype, 132, f32, compute_dtype=f32)
        assert pl.path == path and pl.rows_per_split % gm.TILES[path][2] == 0
        assert pl.splits * pl.rows_per_split >= N > (pl.splits - 1) * pl.rows_per_split
        assert gm.plan(dims, N, G, dg_dtype, 132) == gm.plan(dims, N, G, dg_dtype, 132,
                                                             compute_dtype=bf16)
        assert gm.product_path(dims, G, dg_dtype) == gm.product_path(dims, G, dg_dtype, bf16)


def test_mixed_compute_and_residual_dtypes_raise():
    """Mixed compute and residual dtypes no longer raise: ``kernel_dtype``
    answers the (compute, residual) pair, the C entries' suffix names it,
    and every plan sends a mixed mode to the per-step and per-diagonal
    kernels; other dtypes still raise."""
    assert trec.kernel_dtype(bf16) == (bf16, bf16) and trec.kernel_dtype(f32, f32) == (f32, f32)
    suffix = {(bf16, bf16): "", (f32, f32): "_f32", (bf16, f32): "_bf16_f32",
              (f32, bf16): "_f32_bf16"}
    for (w, r), tag in suffix.items():
        assert trec.kernel_dtype(w, r) == (w, r)
        assert trec.entry_suffix(w, r) == tag
    for w, r in ((bf16, f32), (f32, bf16)):
        assert trec.lean_plan(64, 1024, dtype=w, res_dtype=r) == {"kernel": "per_step"}
        assert tlt.bwd_plan(64, 1024, dtype=w, res_dtype=r) == {"kernel": "per_step"}
        assert tlt.bwd_plan(400, 1024, dtype=w, res_dtype=r, recompute=True) == {
            "kernel": "per_step"}
        assert twave.wavefront_plan(64, 1024, 3, 1024, dtype=w, res_dtype=r) == {
            "kernel": "per_diagonal"}
        assert twave.wavefront_bwd_plan(64, 1024, 3, dtype=w, res_dtype=r) == {
            "kernel": "per_diagonal"}
    for w, r in ((torch.float16, bf16), (bf16, torch.float16)):
        with pytest.raises(TypeError, match="bfloat16 or float32"):
            trec.kernel_dtype(w, r)
    with pytest.raises(TypeError, match="bf16 or float32"):
        gm._launch([torch.zeros((8, 8))], torch.zeros((8, 8)), torch.float16)


def test_the_bf16_rebuild_alone_needs_d_a_multiple_of_64():
    """The rebuild takes any D: ``_rebuild_checks`` no longer refuses one
    that is not a multiple of 64 (x and h_prev in the residual dtype, w_x in
    the compute dtype), and ``HiddenPad`` widens D to 64 with zero rows of
    W_x and zero columns of x, which leaves the rebuilt gates as they are."""
    x, h = torch.zeros((4, 16)), torch.zeros((4, 64))
    w_x, b = torch.zeros((16, 256)), torch.zeros((256,))
    assert [c[2] for c in tlt._rebuild_checks(x, h, w_x, b, f32)][:3] == [f32] * 3
    assert [c[2] for c in tlt._rebuild_checks(x.to(bf16), h.to(bf16), w_x, b, f32, bf16)][:3] \
        == [bf16, bf16, f32]
    g = torch.Generator().manual_seed(3)
    x, h = torch.randn((5, 16), generator=g), torch.randn((5, 64), generator=g)
    w_x, w_h = torch.randn((16, 256), generator=g), torch.randn((64, 256), generator=g)
    b = torch.randn((256,), generator=g)
    pad = trec.HiddenPad(64, 16)
    assert (pad.Hp, pad.Dp, pad.needed) == (64, 64, True)
    got = pad.call(lambda *a: (tlt.rebuild_gates_plain(*a),), (x, h, w_x, w_h, b),
                   ("d", "h", "wd", "wh", "g"), ("g",))[0]
    torch.testing.assert_close(got, tlt.rebuild_gates_plain(x, h, w_x, w_h, b), rtol=1e-6,
                               atol=1e-6)


def _rel(got, ref):
    ref = np.asarray(ref, np.float32)
    got = got.detach().to(torch.float32).numpy()
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _check(ref_tree, got_tree):
    ref = jax.tree.leaves(ref_tree)
    got = got_tree
    assert len(ref) == len(got)
    worst = max(_rel(g, r) for g, r in zip(got, ref))
    assert worst <= TOL, worst


# check_lstm's problem (rnn_speech_tpu_torch/tools/hw_parity.py), from numpy.
LT, LB, LD, LH = 96, 8, 16, 256
LLENS = np.asarray([96, 50, 0, 96, 31, 96, 7, 96], np.int32)


def _lstm_problem():
    rng = np.random.default_rng(0)
    lim = lambda fi, fo: np.sqrt(6.0 / (fi + fo))
    params = {"w_x": rng.uniform(-1, 1, (LD, 4 * LH)) * lim(LD, 4 * LH),
              "w_h": rng.uniform(-1, 1, (LH, 4 * LH)) * lim(LH, 4 * LH),
              "b": rng.normal(0, 0.1, (4 * LH,))}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rng.normal(size=(LT, LB, LD)).astype(np.float32)
    state = (np.full((LB, LH), 0.2, np.float32), np.full((LB, LH), -0.1, np.float32))
    wy = (rng.normal(size=(LT, LB, LH)) * 0.1).astype(np.float32)
    return params, x, state, wy


@pytest.mark.parametrize("mode", ["gates", "recompute"])
def test_layer_in_float32_matches_lstm_layer_pallas(mode):
    """``lstm_layer_train`` in float32 (the kernels' float32 route) against
    ``lstm_layer_pallas`` in float32, TPU interpret mode: outputs, final
    state and the gradients of the weights, input and initial state."""
    params, x, state, wy = _lstm_problem()

    def jloss(p, xx, st):
        out, (c, h) = jpal.lstm_layer_pallas(p, xx, jnp.asarray(LLENS), st,
                                             compute_dtype=jnp.float32,
                                             residual_dtype=jnp.float32, residual_mode=mode)
        return jnp.sum(out * wy) + jnp.sum(c ** 2) + jnp.sum(jnp.abs(h)), (out, c, h)

    with pltpu.force_tpu_interpret_mode():
        (_, ref_vals), ref_g = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                                          has_aux=True))(
            jax.tree.map(jnp.asarray, params), jnp.asarray(x), tuple(map(jnp.asarray, state)))

    tp = {k: v.requires_grad_() for k, v in tparams.params_from_jax(params, "cpu").items()}
    tx = torch.tensor(x, requires_grad=True)
    ts = tuple(torch.tensor(s, requires_grad=True) for s in state)
    out, (c, h) = tlt.lstm_layer_train(tp, tx, torch.as_tensor(LLENS), ts, compute_dtype=f32,
                                       residual_dtype=f32, residual_mode=mode)
    ((out * torch.as_tensor(wy)).sum() + (c ** 2).sum() + h.abs().sum()).backward()
    _check(ref_vals, [out, c, h])
    _check(ref_g, [tp["b"].grad, tp["w_h"].grad, tp["w_x"].grad, tx.grad, ts[0].grad,
                   ts[1].grad])


# check_wavefront's problem, from numpy.
WT, WB, WD, WH, WL = 64, 8, 128, 128, 3
WLENS = np.asarray([64, 50, 0, 64, 31, 64, 7, 13], np.int32)


@pytest.mark.parametrize("bwd_wavefront", [True, False])
def test_wavefront_stack_in_float32_matches_jax(bwd_wavefront):
    """``lstm_stack_wavefront_train`` with float32 compute and residuals
    (the reverse diagonal or the layered backward) against JAX's, TPU
    interpret mode: the top output, every layer's final state and the
    gradients of every weight, the input and every initial state."""
    rng = np.random.default_rng(1)
    lim = np.sqrt(6.0 / (WH + 4 * WH))
    layers = [{"w_x": rng.uniform(-lim, lim, (WD if l == 0 else WH, 4 * WH)),
               "w_h": rng.uniform(-lim, lim, (WH, 4 * WH)), "b": rng.normal(0, 0.1, (4 * WH,))}
              for l in range(WL)]
    layers = [{k: v.astype(np.float32) for k, v in p.items()} for p in layers]
    x = rng.normal(size=(WT, WB, WD)).astype(np.float32)
    states = [tuple((rng.normal(size=(WB, WH)) * 0.1).astype(np.float32) for _ in "ch")
              for _ in range(WL)]
    wy = (rng.normal(size=(WT, WB, WH)) * 0.1).astype(np.float32)

    def jloss(p, xx, sts):
        out, new = jwave.lstm_stack_wavefront_train(p, xx, jnp.asarray(WLENS), sts,
                                                    residual_dtype=jnp.float32,
                                                    bwd_wavefront=bwd_wavefront)
        loss = jnp.sum(out * wy) + sum(jnp.sum(c) * 0.3 + jnp.sum(h) * 0.7 for c, h in new)
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
    out, new = twave.lstm_stack_wavefront_train(tl, tx, torch.as_tensor(WLENS), ts,
                                                compute_dtype=f32, residual_dtype=f32,
                                                bwd_wavefront=bwd_wavefront)
    loss = (out * torch.as_tensor(wy)).sum() + sum(c.sum() * 0.3 + h.sum() * 0.7
                                                   for c, h in new)
    loss.backward()
    _check(ref_vals, [out] + [t for st in new for t in st])
    _check(ref_g, [p[k].grad for p in tl for k in ("b", "w_h", "w_x")] + [tx.grad]
           + [t.grad for st in ts for t in st])
