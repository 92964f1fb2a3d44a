"""Inter-layer dropout of the port's wavefront training stack (drop modes
1 and 2) and the dropout sites of ``lstm_stack`` and the train step.

Mode 1 (explicit {0, 1} masks times a static scale) is the parity form:
its plain route is held against the JAX package's
``lstm_stack_wavefront_train(drop_masks=...)`` with its Pallas kernels in
TPU interpret mode, values and every gradient, for L = 2 and 3 in float32
and bf16.  Mode 2 draws the masks from two seed words; its plain route
must EQUAL mode 1's fed the generator's masks (``random_bits``), bit for
bit.  Inputs, weights, states and masks come from numpy seeds, with
ragged lengths and a zero-length row.

Tolerances against JAX: float32 1e-5 (the same arithmetic in another
summation order); bf16 2e-3 (both sides round the same operands to bf16
and sum in float32; a rounding flip of one bf16 residual, 2^-8 relative,
is the only divergence).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rnn_speech_tpu.ops import lstm_wavefront as jwave
from rnn_speech_tpu_torch.models import acoustic as tac
from rnn_speech_tpu_torch.ops import dropout as tdrop
from rnn_speech_tpu_torch.ops import lstm as tlstm
from rnn_speech_tpu_torch.ops import lstm_wavefront as twave
from rnn_speech_tpu_torch.ops import random_bits as rb
from rnn_speech_tpu_torch.train import optim as toptim
from rnn_speech_tpu_torch.train import step as tstep

DTYPES = {"f32": (jnp.float32, torch.float32, dict(rtol=1e-5, atol=1e-5)),
          "bf16": (jnp.bfloat16, torch.bfloat16, dict(rtol=2e-3, atol=2e-3))}
T, B, D, H = 5, 4, 6, 16
KP = 0.4                      # ko·ki = 0.5 · 0.8


def _problem(L, seed):
    rng = np.random.default_rng(seed)
    layers = [{"w_x": rng.normal(0, 0.3, (D if l == 0 else H, 4 * H)),
               "w_h": rng.normal(0, 0.3, (H, 4 * H)),
               "b": rng.normal(0, 0.1, (4 * H,))} for l in range(L)]
    layers = jax.tree.map(lambda a: a.astype(np.float32), layers)
    x = rng.normal(0, 1, (T, B, D)).astype(np.float32)
    states = [tuple(rng.normal(0, 0.2, (B, H)).astype(np.float32) for _ in "ch")
              for _ in range(L)]
    masks = (rng.random((L - 1, T, B, H)) < KP).astype(np.float32)
    cot = rng.normal(0, 1, (T, B, H)).astype(np.float32)
    return layers, x, states, masks, cot


LENS = np.asarray([5, 3, 0, 4], np.int32)


def _loss(out, new_states, xp, cot):
    return (xp.sum(out * cot)
            + sum(xp.sum(c) * 0.3 + xp.sum(h) * 0.7 for c, h in new_states))


def _port_run(layers, x, states, cot, td, **drop):
    tl = toptim.tree_map(lambda a: torch.tensor(a, requires_grad=True), layers)
    tx = torch.tensor(x, requires_grad=True)
    ts = toptim.tree_map(lambda a: torch.tensor(a, requires_grad=True), states)
    out, ns = twave.lstm_stack_wavefront_train(tl, tx, torch.as_tensor(LENS), ts,
                                               compute_dtype=td, **drop)
    _loss(out.float(), ns, torch, torch.as_tensor(cot)).backward()
    leaves = [out.float(), *[t for pair in ns for t in pair]]
    return leaves + toptim.tree_leaves(toptim.tree_map(lambda t: t.grad, (tl, tx, ts)))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("L", [2, 3])
def test_mode1_plain_route_matches_jax(L, dtype):
    jd, td, tol = DTYPES[dtype]
    layers, x, states, masks, cot = _problem(L, 10 + L)

    def jloss(layers, x, states):
        out, ns = jwave.lstm_stack_wavefront_train(
            layers, x, jnp.asarray(LENS), states,
            drop_masks=jnp.asarray(masks, jnp.bfloat16), drop_scale=1.0 / KP,
            compute_dtype=jd, interpret=True)
        return _loss(out.astype(jnp.float32), ns, jnp, cot), (out, ns)

    with pltpu.force_tpu_interpret_mode():
        (_, (ref_out, ref_ns)), ref_g = jax.jit(jax.value_and_grad(
            jloss, argnums=(0, 1, 2), has_aux=True))(
            jax.tree.map(jnp.asarray, layers), jnp.asarray(x),
            jax.tree.map(jnp.asarray, states))
    got = _port_run(layers, x, states, cot, td, drop_masks=torch.as_tensor(masks),
                    drop_scale=1.0 / KP)
    ref = ([np.asarray(ref_out, np.float32)]
           + [np.asarray(t, np.float32) for pair in ref_ns for t in pair]
           + [np.asarray(a, np.float32) for a in jax.tree.leaves(ref_g)])
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.detach().float().numpy(), r, **tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mode2_plain_equals_mode1_on_the_generators_masks(dtype):
    """Drop mode 2 regenerates the masks from the seed words in both
    kernels' plain versions: values and gradients equal mode 1's fed
    ``wavefront_masks``, bit for bit, and differ from no dropout."""
    _, td, _ = DTYPES[dtype]
    L, seed = 3, (1234, 98765)
    layers, x, states, _, cot = _problem(L, 7)
    masks = rb.wavefront_masks(seed, L - 1, T, B, H, KP, "cpu")
    mode2 = _port_run(layers, x, states, cot, td, drop_seed=seed, drop_keep=KP,
                      drop_scale=1.0 / KP)
    mode1 = _port_run(layers, x, states, cot, td, drop_masks=masks.float(),
                      drop_scale=1.0 / KP)
    none = _port_run(layers, x, states, cot, td)
    for a, b in zip(mode2, mode1):
        assert torch.equal(a, b)
    assert not torch.equal(mode2[0], none[0])


def test_backward_emits_the_dropped_boundary_inputs():
    """The reverse diagonal's xdrop = bf16(outs·keep·scale) of boundaries
    0..L-2; a neighbouring boundary's bits give another stream."""
    L = 3
    g = torch.Generator().manual_seed(0)
    bf = torch.bfloat16
    args = dict(x=torch.randn((T, B, H), generator=g).to(bf),
                w_x0=(torch.randn((H, 4 * H), generator=g) * 0.3).to(bf),
                w_h=(torch.randn((L, H, 4 * H), generator=g) * 0.3).to(bf),
                w_x_rest=(torch.randn((L - 1, H, 4 * H), generator=g) * 0.3).to(bf),
                b_all=torch.zeros((L, 4 * H)),
                mask=tlstm.length_mask(T, torch.as_tensor(LENS), "cpu"),
                h0=torch.zeros((L, B, H)), c0=torch.zeros((L, B, H)))
    seed = (5, 6)
    drop = (2, seed, 1.0 / KP, KP)
    outs, gates, cseq, _, _ = twave.wavefront_train(*args.values(), bf, *drop)
    res = twave.wavefront_bwd(torch.randn((T, B, H), generator=g).to(bf), args["w_h"],
                              args["w_x_rest"], args["mask"], gates, cseq, args["c0"],
                              torch.zeros((L, B, H)), torch.zeros((L, B, H)), outs,
                              *drop)
    assert len(res) == 4
    keeps = rb.wavefront_masks(seed, L - 1, T, B, H, KP, "cpu").float()
    want = (outs[:L - 1].float() * (keeps / KP)).to(bf)
    assert torch.equal(res[3], want)
    assert not torch.equal(res[3], (outs[:L - 1].float() * (keeps.flip(0) / KP)).to(bf))


def test_stack_dropout_sites_on_the_wavefront_route():
    """``lstm_stack`` draws, in order: the input site's seed (fused
    dropout of x), the inter-layer seed (mode 2 with keep ko·ki), the top
    site's seed (``head_fused``, or the fused dropout of the output)."""
    L = 3
    layers, x, states, _, _ = _problem(L, 3)
    tl = toptim.tree_map(torch.as_tensor, layers)
    ts = toptim.tree_map(torch.as_tensor, states)
    tx, lens = torch.as_tensor(x), torch.as_tensor(LENS)
    kw = dict(input_keep_prob=0.8, output_keep_prob=0.5, use_kernels=True, wavefront=True)
    got, _ = tlstm.lstm_stack(tl, tx, lens, ts, dropout_rng=torch.Generator().manual_seed(4),
                              **kw)
    g = torch.Generator().manual_seed(4)
    xd = tdrop.dropout(tx, rb.seed_words(g), [0.8])
    out, _ = twave.lstm_stack_wavefront_train(tl, xd, lens, ts, drop_seed=rb.seed_words(g),
                                              drop_keep=KP, drop_scale=1.0 / KP)
    want = tdrop.dropout(out, rb.seed_words(g), [0.5])
    assert torch.equal(got, want)
    fused, _ = tlstm.lstm_stack(tl, tx, lens, ts,
                                dropout_rng=torch.Generator().manual_seed(4),
                                head_fused=lambda seed, h: tdrop.dropout(h, seed, [0.5]),
                                **kw)
    assert torch.equal(fused, want)


def test_stack_dropout_sites_on_the_layered_route():
    """Without kernels: [input] before layer 0, [output, input] stacked
    before each layer above, [output] after the top."""
    L = 2
    layers, x, states, _, _ = _problem(L, 4)
    tl = toptim.tree_map(torch.as_tensor, layers)
    ts = toptim.tree_map(torch.as_tensor, states)
    tx, lens = torch.as_tensor(x), torch.as_tensor(LENS)
    got, _ = tlstm.lstm_stack(tl, tx, lens, ts, dropout_rng=torch.Generator().manual_seed(2),
                              input_keep_prob=0.8, output_keep_prob=0.5)
    g = torch.Generator().manual_seed(2)
    h = tdrop.dropout(tx, rb.seed_words(g), [0.8])
    h, _ = tlstm.lstm_layer_scan(tl[0], h, lens, ts[0])
    h = tdrop.dropout(h, rb.seed_words(g), [0.5, 0.8])
    h, _ = tlstm.lstm_layer_scan(tl[1], h, lens, ts[1])
    assert torch.equal(got, tdrop.dropout(h, rb.seed_words(g), [0.5]))


@pytest.mark.parametrize("use_pallas_ctc", [False, True])
def test_default_train_step_runs_on_the_cpu(use_pallas_ctc):
    """The default StepConfig (keeps 0.8 / 0.5) on the kernel route's plain
    versions: finite loss and gradients, every parameter moves, and the
    same generator state repeats the step exactly."""
    cfg = tac.AcousticConfig(num_layers=3, hidden_size=16, input_dim=4, num_labels=6,
                             compute_dtype=torch.bfloat16, use_kernels=True,
                             wavefront=True)
    scfg = tstep.StepConfig(model=cfg, use_pallas_ctc=use_pallas_ctc)
    assert (scfg.input_keep_prob, scfg.output_keep_prob) == (0.8, 0.5)
    state = tstep.init_train_state(torch.Generator().manual_seed(0), cfg, 3, 1e-3,
                                   device="cpu")
    g = torch.Generator().manual_seed(1)
    batch = {"features": torch.randn((2, 3, 7, 4), generator=g),
             "frame_lengths": torch.as_tensor([[7, 4, 0], [5, 7, 6]], dtype=torch.int32),
             "labels": torch.as_tensor([[[1, 2], [3, -1], [-1, -1]],
                                        [[4, -1], [0, 1], [2, 2]]], dtype=torch.int32),
             "label_lengths": torch.as_tensor([[2, 1, 0], [1, 2, 2]], dtype=torch.int32)}
    _, grads, loss, _, _ = tstep.accumulate_grads(scfg, state["params"], state["states"],
                                                  batch, torch.Generator().manual_seed(5))
    assert np.isfinite(float(loss))
    assert all(bool(torch.isfinite(t).all()) for t in toptim.tree_leaves(grads))
    new, m = tstep.train_step(scfg, state, batch, torch.Generator().manual_seed(5), False)
    again, _ = tstep.train_step(scfg, state, batch, torch.Generator().manual_seed(5), False)
    for a, b, c in zip(*(toptim.tree_leaves(s["params"]) for s in (state, new, again))):
        assert not torch.equal(a, b) and torch.equal(b, c)
    other, _ = tstep.train_step(dataclasses.replace(scfg), state, batch,
                                torch.Generator().manual_seed(6), False)
    assert not torch.equal(toptim.tree_leaves(other["params"])[0],
                           toptim.tree_leaves(new["params"])[0])
