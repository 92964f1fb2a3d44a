"""Outer training loop: checkpoint cadence, plateau LR decay, epochs.

The port's counterpart of ``rnn_speech_tpu/train/loop.py``, one process on
one device: run ``steps_per_checkpoint`` train steps -> save a checkpoint
-> every ``steps_per_evaluation`` steps run an eval pass -> plateau decay
(track the mean error rate per checkpoint window; clear the history on a
new best; after 7 non-improving windows multiply the LR by
``lr_decay_factor``; stop when the LR drops below 1e-7) -> epoch
bookkeeping on dataset exhaustion with reshuffle-or-reuse controlled by
``dataset_size_ordering`` (True / False / First_run_only).

The recurrent-state reset coin (``rnn_state_reset_ratio``) is drawn on
the host from ``Random(0xC01)`` and applied inside the step.  Dispatch
stays asynchronous: batches reach the card from pinned memory without a
host sync, and a step's metrics are read only after the next step is
queued (``drain_pending``).  On CUDA the step takes the hand-written
kernels (``use_pallas_lstm``) and, as the config says, the CTC kernels
(``use_pallas_ctc``); on the CPU it runs the plain PyTorch path, as the
JAX loop runs its scan path there.  Dropout seed words come from a CPU
``torch.Generator`` seeded 1234 (the bits are made on the device from
them, ``ops/random_bits.py``).

Not ported yet: device meshes and multi-process training (ROADMAP Queue
A 8) and ``--timeline`` tracing (Queue A 9); they raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from collections import deque
from random import Random, randint, shuffle
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from rnn_speech_tpu_torch import resolve_device
from rnn_speech_tpu_torch.train import checkpoint as ckpt
from rnn_speech_tpu_torch.train import metrics as metrics_mod
from rnn_speech_tpu_torch.train import pipeline as pipe_mod
from rnn_speech_tpu_torch.train import step as step_mod

logger = logging.getLogger(__name__)

MIN_LEARNING_RATE = 1e-7
PLATEAU_STRIKES = 7
DROPOUT_SEED = 1234
COIN_SEED = 0xC01
EVAL_WINDOW = 4         # eval batches in flight before the oldest is read


def reset_coin(ratio: float, rng=None) -> bool:
    """randint(1, 1//ratio) == 1 — the reference's exact reset draw.
    Pass a seeded ``random.Random`` to make the sequence deterministic."""
    upper = max(1, int(1 // ratio)) if ratio > 0 else 1 << 30
    draw = rng.randint if rng is not None else randint
    return draw(1, upper) == 1


class PlateauPolicy:
    """Plateau LR decay with clear-on-improvement: a new best clears the
    history and then occupies a slot itself, so decay fires after the 6th
    consecutive non-improving window (history length reaches 7 including
    the best)."""

    def __init__(self, decay_factor: float):
        self.decay_factor = decay_factor
        self.history: List[float] = []

    def update(self, mean_error_rate: float) -> bool:
        """Record a checkpoint-window error rate; True => decay now."""
        if mean_error_rate <= min(self.history, default=float("inf")):
            self.history.clear()
        self.history.append(mean_error_rate)
        if len(self.history) >= PLATEAU_STRIKES:
            self.history.clear()
            return True
        return False


def effective_batch_shape(config) -> Tuple[int, int]:
    """(batch_size, mini_batch_size) after optional microbatch fusion:
    with ``[tpu] fuse_microbatches`` the whole macro batch runs as one
    device batch (mini_batch_size 1); the Adam update is the same summed
    gradient either way."""
    b, mb = config.batch_size, config.mini_batch_size
    if config.tpu.fuse_microbatches and mb > 1:
        return b * mb, 1
    return b, mb


def check_single_process(mesh_shape=(1, 1), timeline: bool = False) -> None:
    """Raise ``NotImplementedError`` for what the port's loop does not run
    yet: a device mesh other than 1x1, multi-process training
    (``RST_MULTIHOST`` or a ``torch.distributed`` group of more than one
    rank) and ``--timeline``."""
    if tuple(mesh_shape) != (1, 1) or os.environ.get("RST_MULTIHOST"):
        raise NotImplementedError(
            "device meshes and multi-process training come with the multi-GPU "
            "slice (ROADMAP Queue A 8); use --mesh_data 1 --mesh_model 1")
    if torch.distributed.is_available() and torch.distributed.is_initialized() \
            and torch.distributed.get_world_size() > 1:
        raise NotImplementedError(
            "multi-process training comes with the multi-GPU slice (ROADMAP Queue A 8)")
    if timeline:
        raise NotImplementedError(
            "--timeline tracing comes with the port's profiling tools (ROADMAP Queue A 9)")


def to_device(array: np.ndarray, dev) -> torch.Tensor:
    """A host array on ``dev``: on CUDA through pinned memory without
    blocking the host, so the work already queued keeps running."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


def build_training(config, char_map, batch_size: int, device=None):
    """(step config, pipeline config) of a training session on ``device``
    (default cuda): the frontend, the model config after the memory plan,
    the keep probabilities and the CTC route."""
    from rnn_speech_tpu_torch.models import acoustic
    from rnn_speech_tpu_torch.ops.frontend import DeviceFrontend

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    tpu = config.tpu
    _, mini_batch_size = effective_batch_shape(config)
    pcfg = pipe_mod.PipelineConfig(
        batch_size=batch_size,
        mini_batch_size=mini_batch_size,
        max_input_seq_length=config.max_input_seq_length,
        max_target_seq_length=config.max_target_seq_length,
        signal_processing=config.signal_processing,
        num_workers=pipe_mod.default_decode_threads() if tpu.prefetch_depth > 0 else 0,
        prefetch_batches=max(tpu.prefetch_depth, 1),
        bucket_count=max(tpu.bucket_count, 1),
    )
    fe = DeviceFrontend(config.signal_processing, sr=pcfg.sample_rate,
                        max_samples=pcfg.max_samples, device=dev)
    model_cfg = acoustic.AcousticConfig(
        num_layers=config.num_layers,
        hidden_size=config.hidden_size,
        input_dim=fe.feature_size,
        num_labels=len(char_map),
        normalization=config.batch_normalization,
        compute_dtype=(torch.bfloat16 if tpu.compute_dtype == "bfloat16"
                       else torch.float32),
        # The hand-written kernels run on the card; the CPU runs the plain
        # path, as the JAX loop runs its scan path there.
        use_kernels=tpu.use_pallas_lstm and on_card,
        remat=tpu.remat,
        time_chunk=max(tpu.time_chunk, 0),
        frame_stack=tpu.frame_stack,
        wavefront=tpu.wavefront,
    )
    if tpu.time_chunk == 0 and on_card:
        # Auto policy: whole-sequence gates residuals when they fit the
        # card's share (``acoustic.RESIDUAL_SHARE``), else recompute
        # residuals, else chunked remat.  -1 forces whole-sequence, > 0
        # that chunk; the CPU keeps whole-sequence residuals.
        chunk, res_mode = acoustic.training_memory_plan(
            model_cfg, config.max_input_seq_length, batch_size, device=dev)
        if chunk or res_mode != "gates":
            logger.info("Training memory plan at B=%d, T=%d: time_chunk=%d, "
                        "residual_mode=%s", batch_size, config.max_input_seq_length,
                        chunk, res_mode)
            model_cfg = dataclasses.replace(model_cfg, time_chunk=chunk,
                                            residual_mode=res_mode)
    scfg = step_mod.StepConfig(
        model=model_cfg,
        grad_clip=config.grad_clip,
        input_keep_prob=config.dropout_input_keep_prob,
        output_keep_prob=config.dropout_output_keep_prob,
        frontend=fe,
        use_pallas_ctc=tpu.use_pallas_ctc and on_card,
        spec_augment=config.spec_augment,
    )
    return scfg, pcfg


def train_acoustic(
    config,
    train_set,
    test_set,
    char_map,
    *,
    max_epoch: Optional[int] = None,
    learn_rate_override: Optional[float] = None,
    tb_name: Optional[str] = None,
    timeline: bool = False,
    max_steps: Optional[int] = None,
    mesh_shape=(1, 1),
    step_hook: Optional[Callable[[int, Dict], None]] = None,
    device=None,
) -> step_mod.TrainState:
    """Full acoustic training session on ``device`` (default cuda).
    Returns the final train state."""
    check_single_process(mesh_shape, timeline)
    dev = resolve_device(device)
    batch_size, _ = effective_batch_shape(config)
    if batch_size != config.batch_size:
        logger.info("Fusing %d microbatches of %d into one %d-wide device batch",
                    config.mini_batch_size, config.batch_size, batch_size)
    scfg, pcfg = build_training(config, char_map, batch_size, dev)
    # Metric cadence ([training] train_metric_every): the greedy decode +
    # edit distance run only on every Nth step; the loss accumulates every
    # step.  N = 1 never runs the second configuration.
    metric_every = max(int(getattr(config, "train_metric_every", 1)), 1)
    scfg_nometric = dataclasses.replace(scfg, train_metric=False)

    state = step_mod.init_train_state(torch.Generator().manual_seed(0), scfg.model,
                                      batch_size, config.learning_rate, dev)
    ckpt_dir = config.checkpoint_dir + "/acoustic/"
    restored = ckpt.restore(ckpt_dir, state["params"])
    if restored is not None:
        params, step0, lr = restored
        state["params"] = params
        state["step"] = torch.tensor(step0, dtype=torch.int32, device=dev)
        state["lr"] = torch.tensor(lr, dtype=torch.float32, device=dev)
    if learn_rate_override is not None:
        state["lr"] = torch.tensor(learn_rate_override, dtype=torch.float32, device=dev)

    put_batch = lambda b: {k: to_device(v, dev) for k, v in b.items()}
    # The coin's two outcomes live on the device, so applying it copies
    # nothing from the host.
    coin_values = {flag: torch.tensor(flag, device=dev) for flag in (False, True)}

    writer = None
    if config.tensorboard_dir:
        writer = metrics_mod.MetricsWriter(config.tensorboard_dir, tb_name)

    policy = PlateauPolicy(config.lr_decay_factor)
    rng = torch.Generator().manual_seed(DROPOUT_SEED)
    coin_rng = Random(COIN_SEED)

    epoch = 0
    ordering = config.dataset_size_ordering
    have_test_set = bool(test_set)
    train_set = pipe_mod.shard_for_host(train_set)
    if test_set:
        test_set = pipe_mod.shard_for_host(test_set)

    def make_train_iter():
        # With audio-width bucketing, sort shuffle windows by duration so
        # each macro batch lands in one bucket.
        data = train_set
        if pcfg.bucket_count > 1:
            window = pcfg.batch_size * pcfg.mini_batch_size * pcfg.bucket_count
            data = pipe_mod.order_by_duration(train_set, window=window)
        return iter(pipe_mod.InputPipeline(data, char_map, pcfg))

    train_iter = make_train_iter()
    total_steps = 0

    def next_batch():
        nonlocal train_iter, epoch
        try:
            return next(train_iter), False
        except StopIteration:
            epoch += 1
            logger.info("End of epoch number : %d", epoch)
            if ordering in ("False", "First_run_only"):
                logger.info("Shuffling the training dataset")
                shuffle(train_set)
            train_iter = make_train_iter()
            try:
                return next(train_iter), True
            except StopIteration:
                raise RuntimeError(
                    "Training pipeline produced no batches: every file in "
                    "the dataset was skipped (unreadable or undecodable "
                    "audio). Check the audio format and decoder logs."
                ) from None

    # Deferred metric read: reading a step's metrics blocks the host until
    # the device finishes it, so a step's metrics are read only after the
    # next step is queued; the window logic drains the tail first.
    global_step0 = int(state["step"])
    pending = None    # (session step number, metrics, dispatch time, with_metric)

    def drain_pending():
        nonlocal pending, window_err, window_steps, window_ran
        if pending is None:
            return
        step_no, m, t_disp, with_metric = pending
        pending = None
        err = float(m["mean_error_rate"])     # waits for that step
        window_ran += 1
        if with_metric:
            # Only metric-bearing steps enter the window mean the plateau
            # policy decays on (metric-free steps report a structural 0).
            window_err += err
            window_steps += 1
        if step_hook is not None:
            step_hook(step_no, m)
        logger.info(
            "Batch %d : loss %.5f - error_rate %.5f - duration %.2f",
            global_step0 + step_no, float(m["mean_loss"]),
            err if with_metric else float("nan"), time.time() - t_disp,
        )

    try:
        while True:
            window_err, window_steps, window_ran = 0.0, 0, 0
            for _ in range(config.steps_per_checkpoint):
                batch, _rolled = next_batch()
                if max_epoch is not None and epoch > max_epoch:
                    break
                t_disp = time.time()
                with_metric = metric_every <= 1 or total_steps % metric_every == 0
                step_cfg = scfg if with_metric else scfg_nometric
                coin = reset_coin(config.rnn_state_reset_ratio, coin_rng)
                state, metrics = step_mod.train_step(
                    step_cfg, state, put_batch(batch), rng, coin_values[coin])
                total_steps += 1
                drain_pending()   # the previous step, while this one runs
                pending = (total_steps, metrics, t_disp, with_metric)
                if max_steps is not None and total_steps >= max_steps:
                    break
            drain_pending()       # the window's tail, before its stats are used
            if window_ran == 0:
                # A window that ran no steps has no mean to log or decay on.
                if max_epoch is not None and epoch > max_epoch:
                    logger.info("Max number of epochs reached, exiting training session")
                    break
                if max_steps is not None and total_steps >= max_steps:
                    break
                continue
            # Mean over the metric-bearing steps actually drained, so a
            # window truncated by max_steps/max_epoch is not biased low.
            have_window_err = window_steps > 0
            if have_window_err:
                window_err /= window_steps

            current_step = int(state["step"])
            ckpt.save(ckpt_dir, state["params"], current_step, float(state["lr"]))
            if writer:
                writer.add_scalar("learning_rate", float(state["lr"]), current_step)
                if have_window_err:
                    writer.add_scalar("train/mean_error_rate", window_err, current_step)
                for li, (c, h) in enumerate(state["states"]):
                    writer.add_histogram(f"rnn/layer{li}_cell",
                                         c.detach().float().cpu().numpy(), current_step)
                    writer.add_histogram(f"rnn/layer{li}_hidden",
                                         h.detach().float().cpu().numpy(), current_step)

            if (have_test_set and config.steps_per_evaluation
                    and current_step % config.steps_per_evaluation == 0):
                eval_metrics = evaluate_dataset(step_mod.eval_step, scfg, state, test_set,
                                                char_map, pcfg, put_batch)
                logger.info("Evaluation at step %d : loss %.5f - error_rate %.5f",
                            current_step, eval_metrics["mean_loss"],
                            eval_metrics["mean_error_rate"])
                if writer:
                    writer.add_scalar("test/mean_loss", eval_metrics["mean_loss"],
                                      current_step)
                    writer.add_scalar("test/mean_error_rate",
                                      eval_metrics["mean_error_rate"], current_step)

            if have_window_err and policy.update(window_err):
                state["lr"] = state["lr"] * policy.decay_factor
                logger.info("Model is not improving, decaying the learning rate")
                if float(state["lr"]) < MIN_LEARNING_RATE:
                    logger.info("Learning rate is too low, exiting")
                    break
                ckpt.save(ckpt_dir, state["params"], current_step, float(state["lr"]))

            if max_epoch is not None and epoch > max_epoch:
                logger.info("Max number of epochs reached, exiting training session")
                break
            if max_steps is not None and total_steps >= max_steps:
                break
    finally:
        if writer:
            writer.close()
    return state


def evaluate_dataset(eval_fn, scfg, state, test_set, char_map, pcfg,
                     put_batch) -> Dict[str, float]:
    """Mean loss/error over one pass of the test pipeline.  Metric reads
    trail dispatch by ``EVAL_WINDOW`` batches, so the device runs batches
    back to back while in-flight memory stays bounded."""
    in_flight = deque()
    drained: List[Tuple[float, float]] = []

    def drain_one():
        m = in_flight.popleft()
        drained.append((float(m["mean_loss"]), float(m["mean_error_rate"])))

    for batch in pipe_mod.InputPipeline(test_set, char_map, pcfg):
        in_flight.append(eval_fn(scfg, state, put_batch(batch)))
        if len(in_flight) > EVAL_WINDOW:
            drain_one()
    while in_flight:
        drain_one()
    if not drained:
        return {"mean_loss": 0.0, "mean_error_rate": 0.0}
    return {
        "mean_loss": sum(m[0] for m in drained) / len(drained),
        "mean_error_rate": sum(m[1] for m in drained) / len(drained),
    }
