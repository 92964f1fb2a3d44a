"""Outer training loop: checkpoint cadence, plateau LR decay, epochs.

The port's counterpart of ``rnn_speech_tpu/train/loop.py``: run
``steps_per_checkpoint`` train steps -> save a checkpoint -> every
``steps_per_evaluation`` steps run an eval pass -> plateau decay (track
the mean error rate per checkpoint window; clear the history on a new
best; after 7 non-improving windows multiply the LR by
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

Multi-GPU (``mesh``, ``parallel/``): one process a GPU.  ``batch_size``
stays the global device batch; each rank's pipeline builds only its
``batch_size // world`` rows of its ``shard_for_host`` slice, width
bucketing off (every rank must run the same collectives step for step),
and the step is ``parallel/sharding.make_sharded_step``'s.  Every rank
draws the same reset coin, so the row-sharded recurrent state resets
coherently; rank 0 alone writes checkpoints (from parameters every rank
gathers) and metrics; the epoch exit is agreed at window boundaries; the
eval pass runs in lockstep (``evaluate_dataset``).

``--timeline`` traces steps 2 and 3 of the session once with
``torch.profiler`` (CPU and, on the card, CUDA activity) into
``tensorboard_dir`` as a Chrome trace, one ``*.pt.trace.json`` a rank,
after one warm-up step: spans ``train`` a step (a profiler step each),
``host/put_batch``, ``host/metrics_drain``, and ``host/next_batch`` (the
input pipeline), ``host/checkpoint`` and ``evaluate`` where the window
holds them.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from collections import deque
from random import Random, randint, shuffle
from typing import Callable, Dict, List, Optional, Tuple

import torch

from rnn_speech_tpu_torch import resolve_device, to_device
from rnn_speech_tpu_torch.parallel import launch, lockstep
from rnn_speech_tpu_torch.parallel import sharding as shard_mod
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
TRACE_STEPS = (2, 4)    # --timeline traces the session's steps [2, 4), after one warm-up


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


def start_trace(trace_dir: str, dev, rank: int = 0):
    """A started ``torch.profiler`` session that warms up over the next
    ``prof.step()`` and then records the TRACE_STEPS window (CPU activity,
    and CUDA activity on the card), written after its last step into
    ``trace_dir`` as ``rank<r>.<timestamp>.pt.trace.json`` (a Chrome
    trace)."""
    from torch.profiler import ProfilerActivity, profile, schedule, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.device(dev).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   schedule=schedule(wait=0, warmup=1,
                                     active=TRACE_STEPS[1] - TRACE_STEPS[0], repeat=1),
                   on_trace_ready=tensorboard_trace_handler(trace_dir, worker_name=f"rank{rank}"))
    prof.start()
    return prof


def build_training(config, char_map, batch_size: int, device=None,
                   bucket_count: Optional[int] = None):
    """(step config, pipeline config) of a training session on ``device``
    (default cuda): the frontend, the model config after the memory plan,
    the keep probabilities and the CTC route.  ``batch_size`` is the rows
    of one device (one rank's share under a mesh); ``bucket_count``
    overrides the config's."""
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
        bucket_count=max(tpu.bucket_count if bucket_count is None else bucket_count, 1),
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
    mesh=None,
    step_hook: Optional[Callable[[int, Dict], None]] = None,
    device=None,
) -> step_mod.TrainState:
    """Full acoustic training session on ``device`` (default cuda; under a
    process group, the rank's device).  ``mesh`` (``parallel/mesh.make_mesh``)
    runs the sharded step; a group of more than one rank needs one.
    Returns the final train state (under a mesh, this rank's shards)."""
    dev = resolve_device(device)
    batch_size, _ = effective_batch_shape(config)
    if batch_size != config.batch_size:
        logger.info("Fusing %d microbatches of %d into one %d-wide device batch",
                    config.mini_batch_size, config.batch_size, batch_size)
    # Multi-rank: batch_size stays the GLOBAL device batch; each rank's
    # pipeline assembles only its 1/world slice of the rows, with width
    # bucketing off, so every rank runs the same collectives step for step.
    n_proc, rank = launch.world_and_rank()
    is_primary = rank == 0
    host_batch_size, bucket_count = batch_size, None
    if n_proc > 1:
        if mesh is None:
            raise ValueError("Multi-process training requires a device mesh "
                             "(--mesh_data 0 spans the ranks)")
        host_batch_size = shard_mod.shard_width(batch_size, mesh)
        if config.tpu.bucket_count > 1:
            logger.info("Multi-process run: disabling width bucketing")
            bucket_count = 1
    # The memory plan and the recurrent state take one rank's rows: the
    # mesh spans every rank, so that is batch_size // (data x model).
    scfg, pcfg = build_training(config, char_map, host_batch_size, dev, bucket_count)
    # Metric cadence ([training] train_metric_every): the greedy decode +
    # edit distance run only on every Nth step; the loss accumulates every
    # step.  N = 1 never runs the second configuration.
    metric_every = max(int(getattr(config, "train_metric_every", 1)), 1)
    scfg_nometric = dataclasses.replace(scfg, train_metric=False)

    state = step_mod.init_train_state(torch.Generator().manual_seed(0), scfg.model,
                                      host_batch_size, config.learning_rate, dev)
    ckpt_dir = config.checkpoint_dir + "/acoustic/"
    restored = ckpt.restore(ckpt_dir, state["params"])
    if restored is not None:
        params, step0, lr = restored
        state["params"] = params
        state["step"] = torch.tensor(step0, dtype=torch.int32, device=dev)
        state["lr"] = torch.tensor(lr, dtype=torch.float32, device=dev)
    if learn_rate_override is not None:
        state["lr"] = torch.tensor(learn_rate_override, dtype=torch.float32, device=dev)

    # Every rank restored the full checkpoint; the sharded step takes its
    # shard of it.
    specs = None
    if mesh is not None:
        specs = shard_mod.param_specs(state["params"], mesh.model_size)
        state, put_batch, train_fn, eval_fn = shard_mod.make_sharded_step(mesh, scfg, state)
    else:
        put_batch = lambda b: {k: to_device(v, dev) for k, v in b.items()}
        train_fn, eval_fn = step_mod.train_step, step_mod.eval_step
    # The coin's two outcomes live on the device, so applying it copies
    # nothing from the host.
    coin_values = {flag: torch.tensor(flag, device=dev) for flag in (False, True)}

    def params_for_save():
        """Full-shape parameters; under the model axis a gather that every
        rank runs, though only rank 0 writes."""
        if mesh is None or mesh.model_size <= 1:
            return state["params"]
        return shard_mod.gather_params(state["params"], specs, mesh)

    # Checkpoints and metrics are written by rank 0 only: every rank holds
    # the same parameters and metrics, and a second writer would race on a
    # shared checkpoint_dir.
    writer = None
    if config.tensorboard_dir and is_primary:
        writer = metrics_mod.MetricsWriter(config.tensorboard_dir, tb_name)

    policy = PlateauPolicy(config.lr_decay_factor)
    rng = torch.Generator().manual_seed(DROPOUT_SEED)
    coin_rng = Random(COIN_SEED)

    epoch = 0
    ordering = config.dataset_size_ordering
    # Each rank feeds only its slice of the corpus.  The eval gate uses the
    # emptiness BEFORE the shard, the same on every rank: the eval pass is a
    # collective, and a rank whose shard is empty must still join it.
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

    def global_epoch() -> int:
        """The epoch every rank agrees on (the least: a rank is through an
        epoch only when every rank is).  A collective, called at window
        boundaries only, so a multi-rank max_epoch exits at window
        granularity."""
        if n_proc <= 1:
            return epoch
        return int(lockstep.all_reduce_values([epoch], "min", integer=True)[0])

    # --timeline: trace a bounded window of steps, once a session, after
    # the first steps (which build kernels and warm the allocator).
    trace_first, trace_last = TRACE_STEPS
    prof = None
    if timeline and not config.tensorboard_dir:
        logger.warning("--timeline needs tensorboard_dir; tracing disabled")
        timeline = False

    try:
        while True:
            window_err, window_steps, window_ran = 0.0, 0, 0
            for _ in range(config.steps_per_checkpoint):
                with torch.profiler.record_function("host/next_batch"):
                    batch, _rolled = next_batch()
                if max_epoch is not None and n_proc == 1 and epoch > max_epoch:
                    break
                if timeline and prof is None and total_steps == trace_first - 1:
                    prof = start_trace(config.tensorboard_dir, dev, rank)
                t_disp = time.time()
                with_metric = metric_every <= 1 or total_steps % metric_every == 0
                step_cfg = scfg if with_metric else scfg_nometric
                coin = reset_coin(config.rnn_state_reset_ratio, coin_rng)
                with torch.profiler.record_function("train"):
                    with torch.profiler.record_function("host/put_batch"):
                        device_batch = put_batch(batch)
                    state, metrics = train_fn(step_cfg, state, device_batch, rng,
                                              coin_values[coin])
                total_steps += 1
                with torch.profiler.record_function("host/metrics_drain"):
                    drain_pending()   # the previous step, while this one runs
                pending = (total_steps, metrics, t_disp, with_metric)
                if prof is not None:
                    if total_steps >= trace_last:
                        float(metrics["mean_loss"])     # the window's last step ends
                    prof.step()                         # the last one writes the trace
                    if total_steps >= trace_last:
                        prof.stop()
                        prof, timeline = None, False    # one window a session
                if max_steps is not None and total_steps >= max_steps:
                    break
            drain_pending()       # the window's tail, before its stats are used
            if window_ran == 0:
                # A window that ran no steps has no mean to log or decay on.
                if max_epoch is not None and global_epoch() > max_epoch:
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
            with torch.profiler.record_function("host/checkpoint"):
                full_params = params_for_save()
                if is_primary:
                    ckpt.save(ckpt_dir, full_params, current_step, float(state["lr"]))
                if writer:
                    writer.add_scalar("learning_rate", float(state["lr"]), current_step)
                    if have_window_err:
                        writer.add_scalar("train/mean_error_rate", window_err, current_step)
                    # Row-sharded states: rank 0's rows (i.i.d. utterance streams).
                    for li, (c, h) in enumerate(state["states"]):
                        writer.add_histogram(f"rnn/layer{li}_cell",
                                             c.detach().float().cpu().numpy(), current_step)
                        writer.add_histogram(f"rnn/layer{li}_hidden",
                                             h.detach().float().cpu().numpy(), current_step)

            if (have_test_set and config.steps_per_evaluation
                    and current_step % config.steps_per_evaluation == 0):
                with torch.profiler.record_function("evaluate"):
                    eval_metrics = evaluate_dataset(eval_fn, scfg, state, test_set,
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
                full_params = params_for_save()
                if is_primary:
                    ckpt.save(ckpt_dir, full_params, current_step, float(state["lr"]))

            if max_epoch is not None and global_epoch() > max_epoch:
                logger.info("Max number of epochs reached, exiting training session")
                break
            if max_steps is not None and total_steps >= max_steps:
                break
    finally:
        if prof is not None:
            prof.stop()
        if writer:
            writer.close()
    return state


def evaluate_dataset(eval_fn, scfg, state, test_set, char_map, pcfg,
                     put_batch) -> Dict[str, float]:
    """Mean loss/error over one pass of the test pipeline.  Metric reads
    trail dispatch by ``EVAL_WINDOW`` batches, so the device runs batches
    back to back while in-flight memory stays bounded.

    Multi-rank: the eval step all-reduces its sums, so dispatch follows the
    lockstep contract of ``parallel/lockstep.py``: one agreed bound, an
    exhausted rank feeding the all-padding batch, and a closing
    all-reduce of the real counts that drops the trailing steps that were
    padding on every rank, so they do not bias the mean low."""
    in_flight = deque()
    drained: List[Tuple[float, float]] = []

    def drain_one():
        m = in_flight.popleft()
        drained.append((float(m["mean_loss"]), float(m["mean_error_rate"])))

    def dispatch(batch):
        in_flight.append(eval_fn(scfg, state, put_batch(batch)))
        if len(in_flight) > EVAL_WINDOW:
            drain_one()

    batches = iter(pipe_mod.InputPipeline(test_set, char_map, pcfg))
    real_steps = None
    if launch.world_and_rank()[0] > 1:
        macro = pcfg.batch_size * pcfg.mini_batch_size
        total = lockstep.pod_dispatch_bound(-(-len(test_set) // macro))
        empty, local_real = None, 0
        for _ in range(total):
            batch = next(batches, None)
            if batch is None:
                if empty is None:
                    empty = pipe_mod.InputPipeline([], char_map, pcfg).empty_batch()
                batch = empty
            else:
                local_real += 1
            dispatch(batch)
        # Ranks feed their real batches first, so step i carried real data
        # somewhere iff i < max(local_real).
        real_steps = int(lockstep.all_reduce_values([local_real], "max", integer=True)[0])
    else:
        for batch in batches:
            dispatch(batch)
    while in_flight:
        drain_one()
    kept = drained if real_steps is None else drained[:real_steps]
    if not kept:
        return {"mean_loss": 0.0, "mean_error_rate": 0.0}
    return {
        "mean_loss": sum(m[0] for m in kept) / len(kept),
        "mean_error_rate": sum(m[1] for m in kept) / len(kept),
    }
