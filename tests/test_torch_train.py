"""The port's train step against the JAX package's, at small sizes.

The slice's configuration on both sides: wavefront kernels for the LSTM
stack (JAX ``use_pallas=True, wavefront=True``, Pallas run in TPU
interpret mode; the port's kernel wrappers take their plain versions on
the CPU), the scan CTC (``use_pallas_ctc=False``), keep probabilities 1.
Inputs, weights and states come from numpy seeds; lengths are ragged
with zero-length rows.

Tolerances, stated per comparison:
* float32: both sides run the same float32 arithmetic in another
  summation order, so values and gradients agree to 1e-5 relative
  (1e-5 absolute near zero).
* bf16 compute: both sides round the same operands to bf16 and sum in
  float32; a rounding flip of one bf16 residual (2^-8 relative) is the
  only divergence, so 2e-3 relative and absolute on values and
  gradients.
* Parameters after one Adam step at lr 1e-3: each weight moves by
  lr·g/(|g| + 3.2e-7), about ±lr, so a gradient that cancels to near
  zero turns an absolute difference d into up to lr·d/3.2e-7.  Hence
  1e-4 (a tenth of lr) absolute in float32 and 2e-4 in bf16; a sign
  flip would move a weight by 2e-3.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rnn_speech_tpu.models import acoustic as jac
from rnn_speech_tpu.ops import lstm_wavefront as jwave
from rnn_speech_tpu.train import optim as joptim
from rnn_speech_tpu.train import step as jstep
from rnn_speech_tpu_torch import params as tparams
from rnn_speech_tpu_torch import stages
from rnn_speech_tpu_torch.models import acoustic as tac
from rnn_speech_tpu_torch.ops import ctc_kernel as tck
from rnn_speech_tpu_torch.ops import lstm_wavefront as twave
from rnn_speech_tpu_torch.train import optim as toptim
from rnn_speech_tpu_torch.train import step as tstep

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-3, atol=2e-3)
DTYPES = {"f32": (jnp.float32, torch.float32, F32, 1e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16, 2e-4)}


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _close_trees(ref, got, tol):
    ref_leaves = [np.asarray(a, np.float32) for a in jax.tree.leaves(ref)]
    got_leaves = [_np(t) for t in toptim.tree_leaves(got)]
    assert len(ref_leaves) == len(got_leaves)
    for r, g in zip(ref_leaves, got_leaves):
        assert r.shape == g.shape
        np.testing.assert_allclose(g, r, **tol)


# ------------------------------------------------------------------ stack


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("L", [2, 3])
def test_stack_wavefront_train_matches_jax(L, dtype):
    """Outputs, final states and every gradient (weights, biases, input,
    initial states) of ``lstm_stack_wavefront_train`` against the JAX
    custom VJP with ``interpret=True``."""
    jd, td, tol, _ = DTYPES[dtype]
    T, B, D, H = 5, 4, 6, 16
    rng = np.random.default_rng(L)
    layers = [{"w_x": rng.normal(0, 0.3, (D if l == 0 else H, 4 * H)),
               "w_h": rng.normal(0, 0.3, (H, 4 * H)),
               "b": rng.normal(0, 0.1, (4 * H,))} for l in range(L)]
    layers = jax.tree.map(lambda a: a.astype(np.float32), layers)
    x = rng.normal(0, 1, (T, B, D)).astype(np.float32)
    states = [tuple(rng.normal(0, 0.2, (B, H)).astype(np.float32) for _ in "ch")
              for _ in range(L)]
    lens = np.asarray([5, 3, 0, 4], np.int32)
    cot = rng.normal(0, 1, (T, B, H)).astype(np.float32)

    def loss(out, new_states, xp, cot):
        return (xp.sum(out * cot)
                + sum(xp.sum(c) * 0.3 + xp.sum(h) * 0.7 for c, h in new_states))

    def jloss(layers, x, states):
        out, ns = jwave.lstm_stack_wavefront_train(
            layers, x, jnp.asarray(lens), states, compute_dtype=jd, interpret=True)
        return loss(out.astype(jnp.float32), ns, jnp, cot), (out, ns)

    with pltpu.force_tpu_interpret_mode():
        (ref_val, (ref_out, ref_ns)), ref_g = jax.jit(jax.value_and_grad(
            jloss, argnums=(0, 1, 2), has_aux=True))(
            jax.tree.map(jnp.asarray, layers), jnp.asarray(x),
            jax.tree.map(jnp.asarray, states))

    tl = toptim.tree_map(lambda a: torch.tensor(a, requires_grad=True), layers)
    tx = torch.tensor(x, requires_grad=True)
    ts = toptim.tree_map(lambda a: torch.tensor(a, requires_grad=True), states)
    out, ns = twave.lstm_stack_wavefront_train(tl, tx, torch.as_tensor(lens), ts,
                                               compute_dtype=td)
    val = loss(out.float(), ns, torch, torch.as_tensor(cot))
    val.backward()
    np.testing.assert_allclose(val.item(), float(ref_val), **tol)
    _close_trees(ref_out, out, tol)
    _close_trees(ref_ns, ns, tol)
    _close_trees(ref_g, toptim.tree_map(lambda t: t.grad, (tl, tx, ts)), tol)
    assert out.dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)


# -------------------------------------------------------------- optimizer


def test_adam_and_clip_match_jax():
    """Three TF-style Adam steps on fixed gradients, with the global-norm
    clip active, inactive and disabled (clip <= 0).  float32 on both
    sides: 1e-6 relative."""
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(0, 1, (3, 4)), "lstm": [{"w": rng.normal(0, 1, (5,))}]}
    params = jax.tree.map(lambda a: a.astype(np.float32), params)
    tol = dict(rtol=1e-6, atol=1e-7)
    jp, jo = jax.tree.map(jnp.asarray, params), joptim.init_adam(params)
    tp = toptim.tree_map(torch.as_tensor, params)
    to = toptim.init_adam(tp)
    lr = 3e-3
    for i, clip in enumerate((1.0, 100.0, 0.0)):
        grads = jax.tree.map(lambda a: (a * (i + 2) - 0.5).astype(np.float32), params)
        jc, jn = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, grads), clip)
        tc, tn = toptim.clip_by_global_norm(toptim.tree_map(torch.as_tensor, grads), clip)
        np.testing.assert_allclose(float(tn), float(jn), **tol)
        _close_trees(jc, tc, tol)
        jp, jo = joptim.adam_update(jp, jc, jo, jnp.asarray(lr, jnp.float32))
        tp, to = toptim.adam_update(tp, tc, to, torch.tensor(lr))
        _close_trees(jp, tp, tol)
        _close_trees((jo["m"], jo["v"]), (to["m"], to["v"]), tol)
        assert int(to["t"]) == int(jo["t"]) == i + 1


# ------------------------------------------------------------ whole step

MB, B, T, D, V, U = 2, 5, 6, 8, 7, 4
H = 32


def _configs(L, dtype):
    jd, td, _, _ = DTYPES[dtype]
    jcfg = jac.AcousticConfig(num_layers=L, hidden_size=H, input_dim=D, num_labels=V,
                              compute_dtype=jd, use_pallas=True, wavefront=True)
    tcfg = tac.AcousticConfig(num_layers=L, hidden_size=H, input_dim=D, num_labels=V,
                              compute_dtype=td, use_kernels=True, wavefront=True)
    common = dict(input_keep_prob=1.0, output_keep_prob=1.0, grad_clip=5.0)
    return (jstep.StepConfig(model=jcfg, use_pallas_ctc=False, **common),
            tstep.StepConfig(model=tcfg, **common))


def _state_and_batch(L, seed=0):
    jcfg = jac.AcousticConfig(num_layers=L, hidden_size=H, input_dim=D, num_labels=V)
    state = jax.tree.map(np.asarray, jstep.init_train_state(
        jax.random.PRNGKey(seed), jcfg, B, 1e-3))
    rng = np.random.default_rng(seed)
    state["states"] = [tuple(rng.normal(0, 0.2, (B, H)).astype(np.float32) for _ in "ch")
                       for _ in range(L)]
    label_lengths = np.asarray([[3, 2, 0, 1, 4], [4, 3, 1, 0, 2]], np.int32)
    labels = rng.integers(0, V - 1, (MB, B, U)).astype(np.int32)
    labels[np.arange(U)[None, None] >= label_lengths[..., None]] = -1
    batch = {
        "features": rng.normal(0, 1, (MB, B, T, D)).astype(np.float32),
        "frame_lengths": np.asarray([[6, 5, 0, 3, 6], [6, 6, 4, 0, 5]], np.int32),
        "labels": labels,
        "label_lengths": label_lengths,
    }
    return state, batch


def _port(state, batch):
    return (tparams.train_state_from_jax(state, device="cpu"),
            {k: torch.as_tensor(v) for k, v in batch.items()})


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("L", [2, 3])
def test_accumulate_grads_matches_jax(L, dtype):
    """Summed gradients, loss and error sums, real-microbatch count and
    the threaded recurrent states over two microbatches."""
    _, _, tol, _ = DTYPES[dtype]
    jcfg, tcfg = _configs(L, dtype)
    state, batch = _state_and_batch(L)
    jb = jax.tree.map(jnp.asarray, batch)
    with pltpu.force_tpu_interpret_mode():
        ref = jax.jit(jstep.accumulate_grads, static_argnums=0)(
            jcfg, jax.tree.map(jnp.asarray, state["params"]),
                                     jax.tree.map(jnp.asarray, state["states"]), jb,
                                     jax.random.PRNGKey(1))
    tst, tb = _port(state, batch)
    got = tstep.accumulate_grads(tcfg, tst["params"], tst["states"], tb,
                                 torch.Generator().manual_seed(1))
    for r, g in zip(ref, got):
        _close_trees(r, g, tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("L", [2, 3])
def test_train_step_matches_jax(L, dtype):
    """The new train state (params, Adam m/v/t, states, step, lr) and the
    metrics of one ``train_step`` (one microbatch; the accumulation over
    two is pinned above)."""
    _, _, tol, param_atol = DTYPES[dtype]
    jcfg, tcfg = _configs(L, dtype)
    state, batch = _state_and_batch(L, seed=1)
    batch = {k: v[:1] for k, v in batch.items()}
    with pltpu.force_tpu_interpret_mode():
        ref, ref_m = jax.jit(jstep.train_step, static_argnums=0)(
            jcfg, jax.tree.map(jnp.asarray, state),
                                      jax.tree.map(jnp.asarray, batch),
                                      jax.random.PRNGKey(2), jnp.asarray(False))
    tst, tb = _port(state, batch)
    got, got_m = tstep.train_step(tcfg, tst, tb, torch.Generator(), False)
    _close_trees(ref["params"], got["params"], dict(rtol=0, atol=param_atol))
    _close_trees((ref["opt"]["m"], ref["opt"]["v"], ref["states"]),
                 (got["opt"]["m"], got["opt"]["v"], got["states"]), tol)
    for key in ("step", "lr"):
        assert float(got[key]) == float(ref[key])
    assert int(got["opt"]["t"]) == int(ref["opt"]["t"]) == 1
    for key in ("mean_loss", "mean_error_rate", "grad_norm"):
        np.testing.assert_allclose(float(got_m[key]), float(ref_m[key]), **tol)


def test_state_reset_coin_zeroes_recurrent_state():
    _, tcfg = _configs(2, "f32")
    state, batch = _state_and_batch(2)
    tst, tb = _port(state, batch)
    kept, _ = tstep.train_step(tcfg, tst, tb, torch.Generator(), False)
    reset, _ = tstep.train_step(tcfg, tst, tb, torch.Generator(), True)
    assert all(bool(s.abs().sum() > 0) for pair in kept["states"] for s in pair)
    assert all(not bool(s.any()) for pair in reset["states"] for s in pair)
    _close_trees(toptim.tree_map(lambda t: t.numpy(), kept["params"]),
                 reset["params"], dict(rtol=0, atol=0))


def test_eval_step_matches_jax():
    """Loss and greedy error rate over a batch, zero state per
    microbatch, inference kernels: float32, 1e-5."""
    jcfg, tcfg = _configs(2, "f32")
    state, batch = _state_and_batch(2, seed=2)
    with pltpu.force_tpu_interpret_mode():
        ref = jstep.eval_step(jcfg, jax.tree.map(jnp.asarray, state),
                              jax.tree.map(jnp.asarray, batch))
    tst, tb = _port(state, batch)
    got = tstep.eval_step(tcfg, tst, tb)
    for key in ref:
        np.testing.assert_allclose(float(got[key]), float(ref[key]), **F32)


def test_eval_step_decodes_at_the_label_width_like_jax():
    """``greedy_metric_max_out`` below the labels' width caps only the
    train metric: ``eval_step`` of both packages decodes at the labels'
    width, so the error rates are equal and the losses agree to 1e-5
    (float32); the capped decode would give another error rate."""
    jcfg, tcfg = _configs(2, "f32")
    jcfg = dataclasses.replace(jcfg, greedy_metric_max_out=1)
    tcfg = dataclasses.replace(tcfg, greedy_metric_max_out=1)
    state, batch = _state_and_batch(2, seed=2)
    with pltpu.force_tpu_interpret_mode():
        ref = jstep.eval_step(jcfg, jax.tree.map(jnp.asarray, state),
                              jax.tree.map(jnp.asarray, batch))
    tst, tb = _port(state, batch)
    got = tstep.eval_step(tcfg, tst, tb)
    assert float(got["mean_error_rate"]) == float(ref["mean_error_rate"])
    np.testing.assert_allclose(float(got["mean_loss"]), float(ref["mean_loss"]), **F32)
    first = _eval_logits(tcfg, tst, tb)
    assert float(tstep._error_rate(tcfg, *first, max_output=1)) != \
        float(tstep._error_rate(tcfg, *first, max_output=U))


def _eval_logits(cfg, state, batch):
    """(logits, frame_lengths, labels, label_lengths) of the first
    microbatch's eval forward."""
    B_ = batch["labels"].shape[1]
    feats, nf = batch["features"][0].transpose(0, 1), batch["frame_lengths"][0]
    with torch.no_grad():
        logits, _ = tac.forward(state["params"], cfg.model, feats, nf,
                                tac.zero_state(cfg.model, B_, device="cpu"))
    return logits, nf, batch["labels"][0], batch["label_lengths"][0]


# ---------------------------------------------------------- memory plan


@pytest.mark.parametrize("budget_gib", [4, 8, 12, 16, 48])
@pytest.mark.parametrize("B", [16, 64, 96, 128])
def test_memory_plan_arithmetic_matches_jax(B, budget_gib):
    """The plan is pure arithmetic: for the same budget both packages
    choose the same (time_chunk, residual_mode) and estimate the same
    residual bytes."""
    jcfg = jac.AcousticConfig(num_layers=3, hidden_size=1024, input_dim=120,
                              num_labels=80, compute_dtype=jnp.bfloat16,
                              use_pallas=True, wavefront=True)
    tcfg = tac.AcousticConfig(num_layers=3, hidden_size=1024, input_dim=120,
                              num_labels=80, compute_dtype=torch.bfloat16,
                              use_kernels=True, wavefront=True)
    budget = budget_gib << 30
    assert tac.training_memory_plan(tcfg, 3510, B, budget) == \
        jac.training_memory_plan(jcfg, 3510, B, budget)
    for mode in ("gates", "recompute"):
        assert tac.training_residual_bytes(tcfg, 3510, B, mode) == \
            jac.training_residual_bytes(jcfg, 3510, B, mode)


def test_default_budget_comes_from_the_card(monkeypatch):
    """On an 80 GB card the flagship train shape (B=64, T=3510) trains
    whole-sequence with gates residuals (8.3 GB), where the JAX package's
    16 GiB-chip budget would not matter; the budget is a fixed share of
    the card's memory.  Wider batches go to whole-sequence recompute
    residuals (B=400: 51.8 GB of gates residuals exceed the 48 GB budget)
    and then to chunked remat (B=512)."""
    class Props:
        total_memory = 80 * 10**9

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: Props)
    cfg = tac.AcousticConfig(num_layers=3, hidden_size=1024, input_dim=120,
                             num_labels=80, compute_dtype=torch.bfloat16,
                             use_kernels=True, wavefront=True)
    assert tac.default_residual_budget() == int(tac.RESIDUAL_SHARE * 80 * 10**9)
    assert tac.training_memory_plan(cfg, 3510, 64) == (0, "gates")
    assert tac.training_residual_bytes(cfg, 3510, 64) < tac.default_residual_budget()
    assert tac.training_memory_plan(cfg, 3510, 400) == (0, "recompute")
    chunk, mode = tac.training_memory_plan(cfg, 3510, 512)
    assert chunk > 0 and mode == "gates"
    with pytest.raises(ValueError):
        tac.default_residual_budget("cpu")


# ------------------------------------------- what later slices bring


def _tiny_step(L=2, **model_kw):
    cfg = tac.AcousticConfig(num_layers=L, hidden_size=16, input_dim=4, num_labels=5,
                             use_kernels=True, wavefront=True)
    cfg = dataclasses.replace(cfg, **model_kw)
    scfg = tstep.StepConfig(model=cfg, input_keep_prob=1.0, output_keep_prob=1.0)
    state = tstep.init_train_state(torch.Generator().manual_seed(0), cfg, 2, 1e-3,
                                   device="cpu")
    batch = {"features": torch.ones((1, 2, 6, 4)),
             "frame_lengths": torch.as_tensor([[6, 3]], dtype=torch.int32),
             "labels": torch.as_tensor([[[1, 2], [3, -1]]], dtype=torch.int32),
             "label_lengths": torch.as_tensor([[2, 1]], dtype=torch.int32)}
    return scfg, state, batch


@pytest.mark.parametrize("change,slice_words", [
    (dict(step=dict(input_keep_prob=0.8)), None),
    (dict(step=dict(output_keep_prob=0.5)), None),
    (dict(model=dict(time_chunk=4)), None),
    (dict(model=dict(remat=True)), None),
    (dict(model=dict(residual_mode="recompute")), None),
    (dict(model=dict(wavefront=False)), None),
    (dict(L=1), None),
    (dict(step=dict(use_pallas_ctc=True)), None),
    (dict(step=dict(spec_augment=True)), "ROADMAP Queue A 3"),
], ids=["input_keep", "output_keep", "time_chunk", "remat", "recompute",
        "layered_kernels", "one_layer_kernels", "pallas_ctc_on_cuda", "spec_augment"])
def test_unported_configurations_raise_naming_their_slice(change, slice_words):
    """Each configuration a later slice brings raises naming that slice
    (``spec_augment``); those that earlier slices brought take a step with
    finite metrics (``slice_words`` None): keeps below 1 and the CTC
    kernels (the dropout slice; their plain versions here, as on any CPU
    tensor), and ``time_chunk``, ``remat``, recompute residuals and the
    layered kernel route with the wavefront off or one layer (the layered
    training slice)."""
    scfg, state, batch = _tiny_step(change.get("L", 2), **change.get("model", {}))
    scfg = dataclasses.replace(scfg, **change.get("step", {}))
    if slice_words is None:
        _, metrics = tstep.train_step(scfg, state, batch, torch.Generator(), False)
        assert all(np.isfinite(float(v)) for v in metrics.values())
        return
    with pytest.raises(NotImplementedError, match=slice_words):
        tstep.train_step(scfg, state, batch, torch.Generator(), False)


def test_pallas_ctc_on_cpu_takes_the_plain_ctc(monkeypatch):
    """On CPU tensors every kernel wrapper takes its plain version, so
    ``use_pallas_ctc`` runs the CTC kernels' plain versions there: the
    same float32 recursion as the scan CTC, whose per-label posterior sums
    (an einsum over a one-hot) add the same terms in the same ascending
    order of states on the CPU, so the step is bit-equal."""
    calls = []
    for name in ("alpha_plain", "beta_post_plain"):
        fn = getattr(tck, name)
        monkeypatch.setattr(tck, name, lambda *a, _fn=fn, _n=name: calls.append(_n) or _fn(*a))
    scfg, state, batch = _tiny_step()
    plain, plain_m = tstep.train_step(scfg, state, batch, torch.Generator(), False)
    assert not calls
    flagged, flagged_m = tstep.train_step(dataclasses.replace(scfg, use_pallas_ctc=True),
                                          state, batch, torch.Generator(), False)
    assert sorted(set(calls)) == ["alpha_plain", "beta_post_plain"]
    _close_trees(toptim.tree_map(lambda t: t.numpy(), plain["params"]),
                 flagged["params"], dict(rtol=0, atol=0))
    for key in plain_m:
        assert float(flagged_m[key]) == float(plain_m[key]), key


def test_training_scan_path_matches_kernel_route():
    """Without kernels the stack trains through the plain time loop under
    autograd (the JAX scan path): same gradients as the kernel route's
    plain versions, float32 1e-5."""
    scfg, state, batch = _tiny_step()
    plain_cfg = dataclasses.replace(scfg, model=dataclasses.replace(
        scfg.model, use_kernels=False))
    ref = tstep.accumulate_grads(plain_cfg, state["params"], state["states"], batch,
                                 torch.Generator())
    got = tstep.accumulate_grads(scfg, state["params"], state["states"], batch,
                                 torch.Generator())
    for r, g in zip(ref, got):
        _close_trees(toptim.tree_map(lambda t: t.detach().numpy(), r), g, F32)


def test_stack_backward_runs_once():
    """The backward writes dgates over its saved gates residual, so a
    second backward through the same graph raises instead of reading
    dgates as gates."""
    g = torch.Generator().manual_seed(0)
    layers = [{"w_x": torch.randn((3, 16), generator=g, requires_grad=True),
               "w_h": torch.randn((4, 16), generator=g), "b": torch.zeros(16)},
              {"w_x": torch.randn((4, 16), generator=g), "w_h": torch.randn((4, 16), generator=g),
               "b": torch.zeros(16)}]
    states = [(torch.zeros((2, 4)), torch.zeros((2, 4))) for _ in range(2)]
    out, _ = twave.lstm_stack_wavefront_train(layers, torch.ones((3, 2, 3)),
                                              torch.as_tensor([3, 1]), states)
    out.sum().backward(retain_graph=True)
    with pytest.raises(RuntimeError, match="runs once"):
        out.sum().backward()


def test_stage_marks_split_the_step_in_order():
    """``stages.record`` collects the step's own marks in the order its
    stages run: the forward, the autograd backward through each Function
    (the input projection's last), the metric, clip + Adam.  Outside a
    record a mark records nothing."""
    class Clock:
        def __init__(self):
            self.t = time.perf_counter()

        def elapsed_time(self, end):
            return 1e3 * (end.t - self.t)

    scfg, state, batch = _tiny_step()
    stages.mark("frontend")
    with stages.record(Clock) as marks:
        tstep.train_step(scfg, state, batch, torch.Generator(), False)
    stages.mark("frontend")
    assert [name for name, _ in marks] == [
        "frontend", "stack_forward", "head_ctc", "ctc_backward",
        "projection_backward", "stack_backward", "weight_grads",
        "projection_backward", "metric", "clip_adam", ""]
    ms = stages.stage_ms(marks)
    assert list(ms) == ["frontend", "stack_forward", "head_ctc", "ctc_backward",
                        "projection_backward", "stack_backward", "weight_grads",
                        "metric", "clip_adam"]
    assert all(v >= 0 for v in ms.values())
    assert sum(ms.values()) == pytest.approx(1e3 * (marks[-1][1].t - marks[0][1].t))
