"""The wavefront training stack's other routes against the JAX package:
the layered backward (``bwd_wavefront=False``, ``RST_WAVEFRONT_BWD=0``),
the materialized inter-layer masks (``RST_WAVEFRONT_SEED_DROP=0`` with
both ``RST_PALLAS_MASKGEN`` values) and the Bernoulli mask stream's plain
version (``dropout.bernoulli_mask_plain``).

The JAX side runs ``lstm_stack_wavefront_train(drop_masks=...,
bwd_wavefront=False)`` with its Pallas kernels in TPU interpret mode; the
port's kernel wrappers take their plain versions on the CPU.  Inputs,
weights, states, cotangents and masks come from numpy seeds, with ragged
lengths and a zero-length row.  The mask bits cannot be the TPU's, so the
seed routes are held to drop mode 1 fed the same masks, bit for bit.

Tolerances against JAX: float32 1e-5, ``test_torch_wavefront_dropout.py``'s
(the same arithmetic in another summation order).  bf16 4e-3,
``test_torch_layered_train.py``'s: both sides round the same operands to
bf16 and sum in float32, and a rounding flip of one bf16 residual (2^-8
relative) then propagates; at H = 128 a step sums 8x the products of
that file's H = 16, so flips are more frequent (the wavefront route's own
drop-mode-1 parity, 2e-3 at H = 16, reads 1.4e-2 at H = 128 with its 0.3
weight scale; these 0.1-scale weights read 3.4e-3).  The one
train step against JAX adds, as ``test_torch_ctc_kernel.py`` states for
the CTC kernels' float32 posteriors, 5e-5 for the JAX posterior sums'
two-term bf16 split.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rnn_speech_tpu.models import acoustic as jac
from rnn_speech_tpu.ops import lstm_wavefront as jwave
from rnn_speech_tpu.train import step as jstep
from rnn_speech_tpu_torch import params as tparams
from rnn_speech_tpu_torch.models import acoustic as tac
from rnn_speech_tpu_torch.ops import dropout as tdrop
from rnn_speech_tpu_torch.ops import lstm as tlstm
from rnn_speech_tpu_torch.ops import lstm_wavefront as twave
from rnn_speech_tpu_torch.ops import random_bits as rb
from rnn_speech_tpu_torch.train import optim as toptim
from rnn_speech_tpu_torch.train import step as tstep

DTYPES = {"f32": (jnp.float32, torch.float32, dict(rtol=1e-5, atol=1e-5)),
          "bf16": (jnp.bfloat16, torch.bfloat16, dict(rtol=4e-3, atol=4e-3))}
T, B, D, H = 5, 4, 24, 128
KP = 0.4                      # ko·ki = 0.5 · 0.8
LENS = np.asarray([5, 3, 0, 4], np.int32)


def _problem(L, seed):
    rng = np.random.default_rng(seed)
    layers = [{"w_x": rng.normal(0, 0.1, (D if l == 0 else H, 4 * H)),
               "w_h": rng.normal(0, 0.1, (H, 4 * H)),
               "b": rng.normal(0, 0.1, (4 * H,))} for l in range(L)]
    layers = jax.tree.map(lambda a: a.astype(np.float32), layers)
    x = rng.normal(0, 1, (T, B, D)).astype(np.float32)
    states = [tuple(rng.normal(0, 0.2, (B, H)).astype(np.float32) for _ in "ch")
              for _ in range(L)]
    masks = (rng.random((L - 1, T, B, H)) < KP).astype(np.float32)
    cot = rng.normal(0, 1, (T, B, H)).astype(np.float32)
    return layers, x, states, masks, cot


def _loss(out, new_states, xp, cot):
    return (xp.sum(out * cot)
            + sum(xp.sum(c) * 0.3 + xp.sum(h) * 0.7 for c, h in new_states))


def _port_run(layers, x, states, cot, td, **kw):
    """Value leaves and every gradient of the port's wavefront stack."""
    tl = toptim.tree_map(lambda a: torch.tensor(a, requires_grad=True), layers)
    tx = torch.tensor(x, requires_grad=True)
    ts = toptim.tree_map(lambda a: torch.tensor(a, requires_grad=True), states)
    out, ns = twave.lstm_stack_wavefront_train(tl, tx, torch.as_tensor(LENS), ts,
                                               compute_dtype=td, **kw)
    _loss(out.float(), ns, torch, torch.as_tensor(cot)).backward()
    leaves = [out.float(), *[t for pair in ns for t in pair]]
    return leaves + toptim.tree_leaves(toptim.tree_map(lambda t: t.grad, (tl, tx, ts)))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("L", [2, 3])
def test_layered_backward_matches_jax(L, dtype):
    """The layered backward on explicit masks: values and every gradient
    against JAX's layered fallback (``bwd_wavefront=False``)."""
    jd, td, tol = DTYPES[dtype]
    layers, x, states, masks, cot = _problem(L, 30 + L)

    def jloss(layers, x, states):
        out, ns = jwave.lstm_stack_wavefront_train(
            layers, x, jnp.asarray(LENS), states,
            drop_masks=jnp.asarray(masks, jnp.bfloat16), drop_scale=1.0 / KP,
            compute_dtype=jd, interpret=True, bwd_wavefront=False)
        return _loss(out.astype(jnp.float32), ns, jnp, cot), (out, ns)

    with pltpu.force_tpu_interpret_mode():
        (_, (ref_out, ref_ns)), ref_g = jax.jit(jax.value_and_grad(
            jloss, argnums=(0, 1, 2), has_aux=True))(
            jax.tree.map(jnp.asarray, layers), jnp.asarray(x),
            jax.tree.map(jnp.asarray, states))
    got = _port_run(layers, x, states, cot, td, drop_masks=torch.as_tensor(masks),
                    drop_scale=1.0 / KP, bwd_wavefront=False)
    ref = ([np.asarray(ref_out, np.float32)]
           + [np.asarray(t, np.float32) for pair in ref_ns for t in pair]
           + [np.asarray(a, np.float32) for a in jax.tree.leaves(ref_g)])
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.detach().float().numpy(), r, **tol)


@pytest.mark.parametrize("drop", ["none", "masks"])
def test_layered_backward_equals_the_reverse_diagonal(drop):
    """The two backward schedules of the port give the same values and
    gradients in float32 (the same math in another order), to 1e-5.  In
    bf16 they round at other places (the layered reverse starts from c0
    rounded to the residual dtype, as JAX's does), so there each is held
    to JAX instead."""
    _, td, tol = DTYPES["f32"]
    L = 3
    layers, x, states, masks, cot = _problem(L, 40)
    kw = {} if drop == "none" else dict(drop_masks=torch.as_tensor(masks),
                                        drop_scale=1.0 / KP)
    layered = _port_run(layers, x, states, cot, td, bwd_wavefront=False, **kw)
    diagonal = _port_run(layers, x, states, cot, td, bwd_wavefront=True, **kw)
    for a, b in zip(layered, diagonal):
        torch.testing.assert_close(a, b, **tol)


def test_bwd_wavefront_reads_the_environment_and_takes_the_mask_stream(monkeypatch):
    """``bwd_wavefront=None`` reads RST_WAVEFRONT_BWD (on by default).  Off,
    seed-mode dropout becomes the mask stream of the seed words with scale
    1/keep: equal, bit for bit, to drop mode 1 fed ``bernoulli_mask_plain``
    of the same seed, and unlike the seed route's own (wavefront) bits."""
    L, seed = 3, (1234, 98765)
    layers, x, states, _, cot = _problem(L, 7)
    seeded = dict(drop_seed=seed, drop_keep=KP, drop_scale=1.0 / KP)
    monkeypatch.setenv("RST_WAVEFRONT_BWD", "0")
    off = _port_run(layers, x, states, cot, torch.float32, **seeded)
    masks = tdrop.bernoulli_mask_plain(seed, (L - 1, T, B, H), KP)
    mode1 = _port_run(layers, x, states, cot, torch.float32, drop_masks=masks.float(),
                      drop_scale=1.0 / KP, bwd_wavefront=False)
    for a, b in zip(off, mode1):
        assert torch.equal(a, b)
    monkeypatch.delenv("RST_WAVEFRONT_BWD")
    on = _port_run(layers, x, states, cot, torch.float32, **seeded)
    assert not torch.equal(on[0], off[0])


@pytest.mark.parametrize("maskgen", ["1", "0"])
def test_seed_drop_off_routes_equal_mode1_on_the_same_masks(maskgen, monkeypatch):
    """``lstm_stack`` with RST_WAVEFRONT_SEED_DROP=0 draws one seed per site
    (input, boundary, top), as with seed-mode dropout, and feeds the
    boundary's (L-1, T, B, H) bf16 masks to drop mode 1: from the mask
    kernel's plain version (RST_PALLAS_MASKGEN=1) or from torch's generator
    seeded with the site's words (=0).  Values and every gradient equal
    the same stack run by hand on those masks, bit for bit."""
    monkeypatch.setenv("RST_WAVEFRONT_SEED_DROP", "0")
    monkeypatch.setenv("RST_PALLAS_MASKGEN", maskgen)
    L = 3
    layers, x, states, _, cot = _problem(L, 9)
    kw = dict(input_keep_prob=0.8, output_keep_prob=0.5, use_kernels=True,
              wavefront=True)

    def run(fn):
        tl = toptim.tree_map(lambda a: torch.tensor(a, requires_grad=True), layers)
        tx = torch.tensor(x, requires_grad=True)
        ts = toptim.tree_map(lambda a: torch.tensor(a, requires_grad=True), states)
        out, ns = fn(tl, tx, ts)
        _loss(out.float(), ns, torch, torch.as_tensor(cot)).backward()
        return [out, *[t for p in ns for t in p]] + toptim.tree_leaves(
            toptim.tree_map(lambda t: t.grad, (tl, tx, ts)))

    lens = torch.as_tensor(LENS)
    got = run(lambda tl, tx, ts: tlstm.lstm_stack(
        tl, tx, lens, ts, dropout_rng=torch.Generator().manual_seed(4), **kw))

    def by_hand(tl, tx, ts):
        g = torch.Generator().manual_seed(4)
        xd = tdrop.dropout(tx, rb.seed_words(g), [0.8])
        seed = rb.seed_words(g)
        shape = (L - 1, T, B, H)
        if maskgen == "1":
            masks = tdrop.bernoulli_mask_plain(seed, shape, KP)
        else:
            gen = torch.Generator().manual_seed((seed[0] << 32) | seed[1])
            masks = (torch.rand(shape, generator=gen) < KP).to(torch.bfloat16)
        out, ns = twave.lstm_stack_wavefront_train(tl, xd, lens, ts, drop_masks=masks,
                                                   drop_scale=1.0 / KP)
        return tdrop.dropout(out, rb.seed_words(g), [0.5]), ns

    want = run(by_hand)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    monkeypatch.setenv("RST_WAVEFRONT_SEED_DROP", "1")
    seeded = run(lambda tl, tx, ts: tlstm.lstm_stack(
        tl, tx, lens, ts, dropout_rng=torch.Generator().manual_seed(4), **kw))
    assert not torch.equal(seeded[0], got[0])


def test_bernoulli_mask_plain():
    """Shape and dtype as asked, the same mask for the same seed, another
    for another seed, the kept fraction within 4 sigma of keep, and the
    dropout kernel's first-keep bits on the flat index."""
    shape, keep = (3, 50, 7, 64), 0.4
    a = tdrop.bernoulli_mask_plain((5, 6), shape, keep)
    assert a.shape == shape and a.dtype == torch.bfloat16
    assert set(torch.unique(a).tolist()) == {0.0, 1.0}
    assert torch.equal(a, tdrop.bernoulli_mask_plain((5, 6), shape, keep))
    assert not torch.equal(a, tdrop.bernoulli_mask_plain((5, 7), shape, keep))
    n = a.numel()
    frac = float(a.float().mean())
    assert abs(frac - keep) <= 4 * (keep * (1 - keep) / n) ** 0.5
    x = torch.ones(shape)
    assert torch.equal(a.float(), (tdrop.dropout_plain(x, (5, 6), [keep]) != 0).float())
    f32 = tdrop.bernoulli_mask((5, 6), shape, keep, torch.float32)
    assert f32.dtype == torch.float32 and torch.equal(f32, a.float())
    assert tdrop.bernoulli_mask.launches == 0            # the CPU takes the plain version


def test_boundary_masks_are_the_mask_stream_with_its_scale():
    """The one rule both seed-to-mask places share: the bf16 mask stream
    of the seed words and drop_scale = 1/keep."""
    shape, keep = (2, 9, 3, 16), 0.4
    masks, scale = tdrop.boundary_masks(np.asarray([5, 6], np.uint32), shape, keep)
    assert masks.dtype == torch.bfloat16
    assert torch.equal(masks, tdrop.bernoulli_mask_plain((5, 6), shape, keep))
    assert scale == 1.0 / keep


# ------------------------------------------------------------- the train step

MB, SB, ST, SD, V, U = 1, 5, 6, 8, 7, 4
SH = 32
STEP_CASES = {
    "f32": ("f32", {}),
    "bf16": ("bf16", {"RST_CTC_POST_F32": "1"}),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_on_the_alt_routes_matches_jax(case, monkeypatch):
    """One ``train_step`` (keeps 1, the CTC kernels, wavefront) with the
    layered backward (RST_WAVEFRONT_BWD=0) and the alpha-stream CTC
    backward (RST_CTC_ALPHA_STREAM=1) against JAX ``train_step`` under the
    same switches: the new parameters, Adam moments, recurrent states and
    the metrics.  The bf16 case keeps JAX's posteriors in float32
    (RST_CTC_POST_F32=1), as the port keeps them."""
    dtype, env = STEP_CASES[case]
    for k, v in {"RST_WAVEFRONT_BWD": "0", "RST_CTC_ALPHA_STREAM": "1", **env}.items():
        monkeypatch.setenv(k, v)
    L = 2
    jd, td, tol = DTYPES[dtype]
    tol = {k: max(v, 5e-5) for k, v in tol.items()}
    param_atol = 1e-4 if dtype == "f32" else 2e-4
    jcfg = jac.AcousticConfig(num_layers=L, hidden_size=SH, input_dim=SD, num_labels=V,
                              compute_dtype=jd, use_pallas=True, wavefront=True)
    tcfg = tac.AcousticConfig(num_layers=L, hidden_size=SH, input_dim=SD, num_labels=V,
                              compute_dtype=td, use_kernels=True, wavefront=True)
    common = dict(input_keep_prob=1.0, output_keep_prob=1.0, grad_clip=5.0,
                  use_pallas_ctc=True)
    jscfg = jstep.StepConfig(model=jcfg, **common)
    tscfg = tstep.StepConfig(model=tcfg, **common)
    state = jax.tree.map(np.asarray, jstep.init_train_state(
        jax.random.PRNGKey(L), dataclasses.replace(jcfg, compute_dtype=jnp.float32),
        SB, 1e-3))
    rng = np.random.default_rng(L)
    state["states"] = [tuple(rng.normal(0, 0.2, (SB, SH)).astype(np.float32) for _ in "ch")
                       for _ in range(L)]
    label_lengths = np.asarray([[3, 2, 0, 1, 4]], np.int32)
    labels = rng.integers(0, V - 1, (MB, SB, U)).astype(np.int32)
    labels[np.arange(U)[None, None] >= label_lengths[..., None]] = -1
    batch = {"features": rng.normal(0, 1, (MB, SB, ST, SD)).astype(np.float32),
             "frame_lengths": np.asarray([[6, 5, 0, 3, 6]], np.int32),
             "labels": labels, "label_lengths": label_lengths}
    with pltpu.force_tpu_interpret_mode():
        ref, ref_m = jax.jit(jstep.train_step, static_argnums=0)(
            jscfg, jax.tree.map(jnp.asarray, state), jax.tree.map(jnp.asarray, batch),
            jax.random.PRNGKey(2), jnp.asarray(False))
    tst = tparams.train_state_from_jax(state, device="cpu")
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    got, got_m = tstep.train_step(tscfg, tst, tb, torch.Generator(), False)
    ref_leaves = jax.tree.leaves(ref["params"])
    got_leaves = toptim.tree_leaves(got["params"])
    assert len(ref_leaves) == len(got_leaves)
    for r, g in zip(ref_leaves, got_leaves):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(r, np.float32), rtol=0,
                                   atol=param_atol)
    for r, g in zip(jax.tree.leaves((ref["opt"]["m"], ref["opt"]["v"], ref["states"])),
                    toptim.tree_leaves((got["opt"]["m"], got["opt"]["v"], got["states"]))):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(r, np.float32), **tol)
    for key in ("mean_loss", "mean_error_rate", "grad_norm"):
        np.testing.assert_allclose(float(got_m[key]), float(ref_m[key]), **tol)
