"""The port's layered training route (``ops/lstm_layer_train.py``) and the
stack options that run it (wavefront off, one layer, ``remat``, recompute
residuals, ``time_chunk``) against the JAX package, at small sizes.

The JAX side runs its Pallas kernels (``ops/lstm_pallas.py``) in TPU
interpret mode; the port's kernel wrappers take their plain versions on
the CPU.  Under ``jax.checkpoint`` (``remat``, ``time_chunk``) the TPU
interpreter's callbacks cannot be differentiated, so those cases run the
same kernels in Pallas's generic interpreter (``interpret=True``, set at
the one ``pl.pallas_call`` the JAX package calls through, in the test
only).  Inputs, weights, states and cotangents come from numpy seeds,
with ragged lengths, a zero-length row and non-zero initial states.

Tolerances, stated per comparison:
* float32: the same float32 arithmetic in another summation order, 1e-5
  relative and absolute.
* bf16 (compute, residuals or both): both sides round the same operands to
  bf16 and sum in float32; where the two sums land on either side of a
  rounding boundary a bf16 residual differs by one step (2^-8 relative)
  and the difference propagates, so 4e-3 relative and absolute on values
  and gradients of magnitude up to about 1.
* Parameters after one Adam step at lr 1e-3: as ``test_torch_train.py``
  states, 1e-4 absolute in float32 and 2e-4 in bf16.
* Dropout: its bits cannot match the TPU's, so ``remat`` and ``time_chunk``
  with keeps 0.8 / 0.5 are held to the same route without recomputation
  under the same generator seed: equal bit for bit.
"""

import contextlib
import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from rnn_speech_tpu.ops import lstm as jlstm
from rnn_speech_tpu.ops import lstm_pallas as jpal
from rnn_speech_tpu.ops import pallas_vma
from rnn_speech_tpu.models import acoustic as jac
from rnn_speech_tpu.train import step as jstep
from rnn_speech_tpu_torch import params as tparams
from rnn_speech_tpu_torch.models import acoustic as tac
from rnn_speech_tpu_torch.ops import lstm as tlstm
from rnn_speech_tpu_torch.ops import lstm_layer_train as tlt
from rnn_speech_tpu_torch.train import optim as toptim
from rnn_speech_tpu_torch.train import step as tstep

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=4e-3, atol=4e-3)
# residual dtype -> (JAX dtype, torch dtype, tolerance); the weights and
# the compute dtype follow the residual dtype.
DTYPES = {"f32": (jnp.float32, torch.float32, F32),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16)}
T, B, D, H = 9, 4, 24, 16
LENS = np.asarray([9, 5, 0, 7], np.int32)


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _close(ref, got, tol):
    ref_leaves = [np.asarray(a, np.float32) for a in jax.tree.leaves(ref)]
    got_leaves = [_np(t) for t in toptim.tree_leaves(got)]
    assert len(ref_leaves) == len(got_leaves)
    for r, g in zip(ref_leaves, got_leaves):
        assert r.shape == g.shape
        np.testing.assert_allclose(g, r, **tol)


@contextlib.contextmanager
def _generic_interpreter():
    """Every Pallas kernel of the JAX package in the generic interpreter."""
    original = pl.pallas_call

    def interpret(kernel, **kw):
        kw.pop("compiler_params", None)
        kw["interpret"] = True
        return original(kernel, **kw)

    with mock.patch.object(pallas_vma.pl, "pallas_call", interpret):
        yield


def _interpreter(kw):
    """The JAX reference's interpreter for a case's stack options."""
    if kw.get("remat") or kw.get("time_chunk"):
        return _generic_interpreter()
    return pltpu.force_tpu_interpret_mode()


def _mask(lens, steps=T):
    return (np.arange(steps)[:, None] < lens[None]).astype(np.float32)[:, None, :]


# ------------------------------------------------------- each kernel's plain


def _kernel_inputs(seed, rd):
    """Inputs of the four kernels: x_proj, W_h, W_x, b, x, states, the
    forward's residuals (from the JAX gates forward) and cotangents."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale: (rng.normal(0, scale, s)).astype(np.float32)
    w_h = jnp.asarray(f(H, 4 * H, scale=0.3), rd)
    w_x = jnp.asarray(f(D, 4 * H, scale=0.3), rd)
    return dict(x_proj=f(T, B, 4 * H, scale=1.0), w_h=w_h, w_x=w_x,
                b=f(4 * H, scale=0.1), x=jnp.asarray(f(T, B, D, scale=1.0), rd),
                h0=f(B, H, scale=0.3), c0=f(B, H, scale=0.3),
                dout=f(T, B, H, scale=1.0), dhn=f(B, H, scale=0.5),
                dcn=f(B, H, scale=0.5), mask=_mask(LENS))


def _t(a):
    """A JAX or numpy array as a torch tensor of the same dtype."""
    if isinstance(a, jax.Array) and a.dtype == jnp.bfloat16:
        return torch.tensor(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("rd", list(DTYPES))
@pytest.mark.parametrize("mode", ["gates", "recompute"])
def test_kernel_plain_versions_match_jax(mode, rd):
    """The two kernels of a residual mode, forward then backward, against
    ``_lstm_recurrence_train`` / ``_lstm_recurrence_bwd`` (gates) or
    ``_lstm_recurrence_train_lean`` / ``_lstm_recurrence_bwd_recompute``
    (recompute), in TPU interpret mode, on the same inputs: the backward
    runs on the JAX forward's own residuals."""
    jd, td, tol = DTYPES[rd]
    x = _kernel_inputs(3 if mode == "gates" else 4, jd)
    xp = jnp.asarray(x["x_proj"]) if mode == "gates" else jnp.asarray(x["x_proj"], jd)
    with pltpu.force_tpu_interpret_mode():
        if mode == "gates":
            fwd = jax.jit(jpal._lstm_recurrence_train, static_argnums=5)(
                xp, x["w_h"], x["mask"], x["h0"], x["c0"], jd)
            out, hn, cn, gates, cseq = fwd
        else:
            fwd = jax.jit(jpal._lstm_recurrence_train_lean, static_argnums=5)(
                xp, x["w_h"], x["mask"], x["h0"], x["c0"], jd)
            out, hn, cn, cseq = fwd
        c0_rd = jnp.asarray(x["c0"]).astype(jd)
        c_prev = jnp.concatenate([c0_rd[None], cseq[:-1]], axis=0)
        h_prev = jnp.concatenate([jnp.asarray(x["h0"]).astype(jd)[None],
                                  out.astype(jd)[:-1]], axis=0)
        if mode == "gates":
            bwd = jax.jit(jpal._lstm_recurrence_bwd)(
                x["dout"], gates, cseq, c_prev, x["mask"], x["w_h"], x["dhn"], x["dcn"])
        else:
            bwd = jax.jit(jpal._lstm_recurrence_bwd_recompute)(
                x["dout"], x["x"], h_prev, cseq, c_prev, x["mask"], x["w_x"],
                jnp.asarray(x["b"]).reshape(1, -1), x["w_h"], x["dhn"], x["dcn"])

    args = (_t(xp), _t(x["w_h"]), _t(x["mask"]), _t(x["h0"]), _t(x["c0"]), td)
    got = (tlt.recurrence_train_plain(*args) if mode == "gates"
           else tlt.recurrence_train_lean_plain(*args))
    _close(fwd, got, tol)
    assert [t.dtype for t in got] == [torch.float32] * 3 + [td] * (len(got) - 3)
    c0_t = _t(c0_rd).to(torch.float32)
    tail = (_t(x["mask"]), _t(x["w_h"]), _t(x["dhn"]), _t(x["dcn"]))
    if mode == "gates":
        res = _t(gates)
        got_b = tlt.recurrence_bwd_plain(_t(x["dout"]), res, _t(cseq), c0_t, *tail)
        assert got_b[0] is res                                # dgates in place
    else:
        got_b = tlt.recurrence_bwd_recompute_plain(
            _t(x["dout"]), _t(x["x"]), _t(h_prev), _t(cseq), c0_t, _t(x["mask"]),
            _t(x["w_x"]), _t(x["b"]), _t(x["w_h"]), _t(x["dhn"]), _t(x["dcn"]))
    _close(bwd, got_b, tol)
    assert got_b[0].dtype == td


# ------------------------------------------------------------- one layer


def _layer_problem(seed, D_in=D):
    rng = np.random.default_rng(seed)
    params = {"w_x": rng.normal(0, 0.3, (D_in, 4 * H)), "w_h": rng.normal(0, 0.3, (H, 4 * H)),
              "b": rng.normal(0, 0.1, (4 * H,))}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rng.normal(0, 1, (T, B, D_in)).astype(np.float32)
    state = tuple(rng.normal(0, 0.3, (B, H)).astype(np.float32) for _ in "ch")
    cot = rng.normal(0, 1, (T, B, H)).astype(np.float32)
    return params, x, state, cot


def _layer_loss(out, c, h, xp, cot):
    return xp.sum(out * cot) + xp.sum(c) * 0.3 + xp.sum(h * h) * 0.7


@pytest.mark.parametrize("rd", list(DTYPES))
@pytest.mark.parametrize("mode", ["gates", "recompute"])
def test_layer_gradients_match_lstm_layer_pallas(mode, rd):
    """``lstm_layer_train`` against ``lstm_layer_pallas``: the output, the
    final state and the gradients of the weights, bias, input and initial
    state, with the compute dtype following the residual dtype."""
    jd, td, tol = DTYPES[rd]
    params, x, state, cot = _layer_problem(5 if mode == "gates" else 6)

    def jloss(p, xx, st):
        out, (c, h) = jpal.lstm_layer_pallas(p, xx, jnp.asarray(LENS), st,
                                             compute_dtype=jd, residual_mode=mode)
        return _layer_loss(out, c, h, jnp, cot), (out, c, h)

    with pltpu.force_tpu_interpret_mode():
        (_, ref_vals), ref_g = jax.jit(jax.value_and_grad(
            jloss, argnums=(0, 1, 2), has_aux=True))(
            jax.tree.map(jnp.asarray, params), jnp.asarray(x),
            tuple(map(jnp.asarray, state)))

    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    ts = tuple(torch.tensor(s, requires_grad=True) for s in state)
    out, (c, h) = tlt.lstm_layer_train(tp, tx, torch.as_tensor(LENS), ts,
                                       compute_dtype=td, residual_mode=mode)
    _layer_loss(out, c, h, torch, torch.as_tensor(cot)).backward()
    assert out.dtype == torch.float32
    _close(ref_vals, (out, c, h), tol)
    _close(ref_g, ({k: tp[k].grad for k in tp}, tx.grad, tuple(s.grad for s in ts)), tol)


def test_layer_backward_runs_once():
    """Gates mode writes dgates over its saved gates residual, so a second
    backward through the same graph raises instead of reading dgates as
    gates."""
    params, x, state, _ = _layer_problem(7)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    out, _ = tlt.lstm_layer_train(tp, torch.tensor(x), torch.as_tensor(LENS),
                                  tuple(map(torch.tensor, state)))
    out.sum().backward(retain_graph=True)
    with pytest.raises(RuntimeError, match="runs once"):
        out.sum().backward()


def test_layer_rejects_an_unknown_residual_mode():
    params, x, state, _ = _layer_problem(8)
    with pytest.raises(ValueError, match="residual_mode"):
        tlt.lstm_layer_train({k: torch.tensor(v) for k, v in params.items()},
                             torch.tensor(x), torch.as_tensor(LENS),
                             tuple(map(torch.tensor, state)), residual_mode="lean")


# ------------------------------------------------------------------ stack

TS = 12                                       # steps of the stack cases
STACK_LENS = np.asarray([12, 7, 0, 10], np.int32)


def _stack_problem(L, seed):
    rng = np.random.default_rng(seed)
    layers = [{"w_x": rng.normal(0, 0.3, (D if l == 0 else H, 4 * H)),
               "w_h": rng.normal(0, 0.3, (H, 4 * H)),
               "b": rng.normal(0, 0.1, (4 * H,))} for l in range(L)]
    layers = jax.tree.map(lambda a: a.astype(np.float32), layers)
    x = rng.normal(0, 1, (TS, B, D)).astype(np.float32)
    states = [tuple(rng.normal(0, 0.2, (B, H)).astype(np.float32) for _ in "ch")
              for _ in range(L)]
    cot = rng.normal(0, 1, (TS, B, H)).astype(np.float32)
    return layers, x, states, cot


def _stack_loss(out, new_states, xp, cot):
    return (xp.sum(out * cot)
            + sum(xp.sum(c) * 0.3 + xp.sum(h) * 0.7 for c, h in new_states))


def _port_stack(layers, x, states, cot, rng_seed=0, **kw):
    """Value leaves and gradients of the port's ``lstm_stack`` (training)."""
    tl = toptim.tree_map(lambda a: torch.tensor(a, requires_grad=True), layers)
    tx = torch.tensor(x, requires_grad=True)
    ts = toptim.tree_map(lambda a: torch.tensor(a, requires_grad=True), states)
    out, ns = tlstm.lstm_stack(tl, tx, torch.as_tensor(STACK_LENS), ts, use_kernels=True,
                               dropout_rng=torch.Generator().manual_seed(rng_seed), **kw)
    _stack_loss(out.float(), ns, torch, torch.as_tensor(cot)).backward()
    return (out.float(), ns), toptim.tree_map(lambda t: t.grad, (tl, tx, ts))


STACK_CASES = {
    "layered_L2": (2, "f32", dict(wavefront=False)),
    "layered_L3": (3, "f32", dict(wavefront=False)),
    "one_layer": (1, "f32", dict(wavefront=True)),
    "remat": (2, "f32", dict(wavefront=True, remat=True)),
    "recompute_bf16": (2, "bf16", dict(wavefront=True, residual_mode="recompute")),
    "chunk5_wavefront": (2, "f32", dict(wavefront=True, time_chunk=5)),
    "chunk4_layered": (2, "f32", dict(wavefront=False, time_chunk=4)),
    "chunkT_layered": (2, "f32", dict(wavefront=False, time_chunk=TS)),
}


@pytest.mark.parametrize("case", list(STACK_CASES))
def test_stack_training_matches_jax(case):
    """``lstm_stack`` training (keeps 1) against JAX ``lstm_stack(use_pallas=
    True)`` with the same options: the output, the final states and every
    gradient (weights, biases, input, initial states).  ``recompute_bf16``
    runs the bf16 low-precision chain; the time chunks (5 does not divide
    12) run the wavefront or the layered route inside each chunk."""
    L, dtype, kw = STACK_CASES[case]
    jd, td, tol = DTYPES[dtype]
    layers, x, states, cot = _stack_problem(L, 20 + L)

    def jloss(ls, xx, st):
        out, ns = jlstm.lstm_stack(ls, xx, jnp.asarray(STACK_LENS), st, compute_dtype=jd,
                                   dropout_rng=jax.random.PRNGKey(0), use_pallas=True,
                                   **kw)
        return _stack_loss(out.astype(jnp.float32), ns, jnp, cot), (out, ns)

    with _interpreter(kw):
        (_, ref_vals), ref_g = jax.jit(jax.value_and_grad(
            jloss, argnums=(0, 1, 2), has_aux=True))(
            jax.tree.map(jnp.asarray, layers), jnp.asarray(x),
            jax.tree.map(jnp.asarray, states))
    vals, grads = _port_stack(layers, x, states, cot, compute_dtype=td, **kw)
    _close(ref_vals, vals, tol)
    _close(ref_g, grads, tol)


@pytest.mark.parametrize("kw", [dict(remat=True), dict(time_chunk=5),
                                dict(time_chunk=5, wavefront=True)],
                         ids=["remat", "chunk5_layered", "chunk5_wavefront"])
def test_recomputation_keeps_the_dropout_masks(kw, monkeypatch):
    """With keeps 0.8 / 0.5, ``remat`` and ``time_chunk`` give bit for bit
    the gradients of the same route run without recomputation (the
    checkpoint replaced by a plain call) under the same generator seed:
    the recomputed forward draws the forward's masks.  Each chunk's seed
    is drawn before its checkpointed call, since the checkpoint does not
    replay an explicit generator."""
    layers, x, states, cot = _stack_problem(3, 31)
    run = functools.partial(_port_stack, layers, x, states, cot, rng_seed=5,
                            input_keep_prob=0.8, output_keep_prob=0.5,
                            compute_dtype=torch.float32, **kw)
    got = run()
    monkeypatch.setattr(tlstm, "checkpoint", lambda fn, *a, use_reentrant: fn(*a))
    ref = run()
    for r, g in zip(toptim.tree_leaves(ref), toptim.tree_leaves(got)):
        assert torch.equal(r, g)
    assert any(bool((t == 0).any()) for t in toptim.tree_leaves(ref[0][0]))  # it dropped


def test_inference_with_time_chunk_equals_whole_sequence():
    """Without a generator the chunked stack runs inference chunk by chunk
    with carried states: the same outputs and states as one pass."""
    layers, x, states, _ = _stack_problem(2, 41)
    tl = toptim.tree_map(torch.tensor, layers)
    args = (tl, torch.tensor(x), torch.as_tensor(STACK_LENS), toptim.tree_map(torch.tensor,
                                                                               states))
    for wavefront in (False, True):
        whole = tlstm.lstm_stack(*args, use_kernels=True, wavefront=wavefront)
        chunked = tlstm.lstm_stack(*args, use_kernels=True, wavefront=wavefront,
                                   time_chunk=5)
        for a, b in zip(toptim.tree_leaves(whole), toptim.tree_leaves(chunked)):
            torch.testing.assert_close(b, a, **F32)


# ------------------------------------------------------------- train step

MB, SB, ST, SD, V, U = 1, 5, 6, 8, 7, 4
SH = 32
STEP_CASES = {
    "layered_bf16": (2, "bf16", dict(wavefront=False)),
    "recompute_bf16": (2, "bf16", dict(wavefront=True, residual_mode="recompute")),
    "one_layer_f32": (1, "f32", dict(wavefront=True)),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_matches_jax(case):
    """One ``train_step`` (keeps 1, scan CTC) with the layered route's
    configurations against JAX ``train_step``: the new parameters, Adam
    moments, recurrent states and the metrics."""
    L, dtype, kw = STEP_CASES[case]
    jd, td, tol = DTYPES[dtype]
    param_atol = 1e-4 if dtype == "f32" else 2e-4
    jcfg = jac.AcousticConfig(num_layers=L, hidden_size=SH, input_dim=SD, num_labels=V,
                              compute_dtype=jd, use_pallas=True, **kw)
    tcfg = tac.AcousticConfig(num_layers=L, hidden_size=SH, input_dim=SD, num_labels=V,
                              compute_dtype=td, use_kernels=True, **kw)
    common = dict(input_keep_prob=1.0, output_keep_prob=1.0, grad_clip=5.0)
    jscfg = jstep.StepConfig(model=jcfg, use_pallas_ctc=False, **common)
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
    _close(ref["params"], got["params"], dict(rtol=0, atol=param_atol))
    _close((ref["opt"]["m"], ref["opt"]["v"], ref["states"]),
           (got["opt"]["m"], got["opt"]["v"], got["states"]), tol)
    for key in ("mean_loss", "mean_error_rate", "grad_norm"):
        np.testing.assert_allclose(float(got_m[key]), float(ref_m[key]), **tol)
