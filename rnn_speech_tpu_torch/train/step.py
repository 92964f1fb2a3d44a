"""The train and eval steps with microbatch gradient accumulation.

Counterpart of ``rnn_speech_tpu/train/step.py``: a loop over the
microbatches of a batch accumulates the summed CTC gradients, the loss and
the greedy error-rate metric while threading the recurrent state; then the
summed gradients are global-norm clipped and applied with TF-style Adam,
and the host's state-reset coin zeroes the recurrent state.

The step runs the JAX package's default configuration: keep
probabilities 0.8 (input) and 0.5 (output) with the dropout of
``ops/lstm.py`` (the fused dropout kernel at the input site, drop mode 2
inside both wavefront kernels between layers, the top site fused with the
output projection), seeded by draws from ``rng``, a CPU
``torch.Generator``; and, with ``use_pallas_ctc``, the CTC kernels
(``ops/ctc_kernel.py``), else the scan CTC (``ops/ctc.py``).  On CPU
tensors every kernel wrapper takes its plain version.  ``spec_augment``
raises ``NotImplementedError``; it never quietly takes another path.  The
multi-device ``axis_name`` form comes with the multi-GPU slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from rnn_speech_tpu_torch import resolve_device, stages
from rnn_speech_tpu_torch.models import acoustic
from rnn_speech_tpu_torch.ops import ctc, ctc_kernel, decode, editdistance
from rnn_speech_tpu_torch.train import optim

Tensor = torch.Tensor
TrainState = Dict[str, Any]   # params / opt / states / step / lr


@dataclass(frozen=True)
class StepConfig:
    model: acoustic.AcousticConfig
    grad_clip: float = 1.0
    input_keep_prob: float = 0.8
    output_keep_prob: float = 0.5
    frontend: Optional[Any] = None        # DeviceFrontend for raw-audio batches
    greedy_metric_max_out: int = 0        # cap decode width for the metric
    use_pallas_ctc: bool = False          # the CTC kernels (ops/ctc_kernel.py)
    spec_augment: bool = False            # time/frequency masking (not ported)
    # Compute the greedy-decode + edit-distance train metric in this step;
    # False reports error-rate 0 with count 0 (the loss still accumulates).
    train_metric: bool = True


def check_supported(cfg: StepConfig) -> None:
    """Raise ``NotImplementedError`` before any work for the step options
    the port does not run yet."""
    if cfg.spec_augment:
        raise NotImplementedError(
            "spec_augment (ops/augment.py) is not ported yet (ROADMAP Queue A 3)")


def init_train_state(generator: torch.Generator, cfg: acoustic.AcousticConfig,
                     batch_size: int, learning_rate: float,
                     device=None) -> TrainState:
    """Random parameters from ``generator``, zero Adam state and recurrent
    state, on ``device`` (default cuda)."""
    dev = resolve_device(device)
    params = acoustic.init_params(generator, cfg, dev)
    return {
        "params": params,
        "opt": optim.init_adam(params),
        "states": acoustic.zero_state(cfg, batch_size, device=dev),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "lr": torch.tensor(learning_rate, dtype=torch.float32, device=dev),
    }


def _featurize_micro(cfg: StepConfig, micro: Dict[str, Tensor]) -> Tuple[Tensor, Tensor]:
    """(features (T, B, D), frame_lengths (B,)) of one microbatch."""
    if "features" in micro:
        # (B, T, D) batch-major from the pipeline -> time-major.
        return micro["features"].transpose(0, 1), micro["frame_lengths"]
    feats, nf = cfg.frontend(micro["audio"], micro["audio_lengths"])
    return feats.transpose(0, 1), nf


def _ctc_loss_fn(cfg: StepConfig):
    return ctc_kernel.ctc_loss if cfg.use_pallas_ctc else ctc.ctc_loss


def _micro_loss(params, cfg: StepConfig, states, feats, frame_lengths, labels,
                label_lengths, rng):
    stages.mark("stack_forward")
    logits, new_states = acoustic.forward(
        params, cfg.model, feats, frame_lengths, states, dropout_rng=rng,
        input_keep_prob=cfg.input_keep_prob, output_keep_prob=cfg.output_keep_prob)
    out_lengths = acoustic.output_lengths(cfg.model, frame_lengths)
    per_example = _ctc_loss_fn(cfg)(logits, out_lengths, labels, label_lengths)
    total = per_example.sum()          # grads of the SUM, like TF's Adam
    # Per-logit-frame normalisation; padded rows (frame_lengths == 0) are
    # left out of the mean.
    denom = torch.clamp(out_lengths.to(torch.float32), min=1.0)
    real = (frame_lengths > 0).to(torch.float32)
    mean_loss = (per_example / denom * real).sum() / torch.clamp(real.sum(), min=1.0)
    return total, (mean_loss, logits, new_states)


def _error_rate(cfg: StepConfig, logits, frame_lengths, labels, label_lengths,
                max_output: int):
    pred, pred_len = decode.greedy_decode(
        logits, acoustic.output_lengths(cfg.model, frame_lengths), max_output=max_output)
    return editdistance.error_rate(pred, pred_len, labels, label_lengths)


def accumulate_grads(cfg: StepConfig, params, states, batch: Dict[str, Tensor],
                     rng: torch.Generator):
    """Loop over the microbatches (leading axis of every ``batch`` entry):
    summed grads, metric SUMS and the threaded recurrent state.

    Returns (states, grad_sum, loss_sum, err_sum, real_micro_count)."""
    check_supported(cfg)
    leaves = optim.tree_map(lambda p: p.detach().requires_grad_(True), params)
    flat = optim.tree_leaves(leaves)
    grad_sum = optim.tree_map(torch.zeros_like, params)
    dev = flat[0].device
    loss_sum = torch.zeros((), device=dev)
    err_sum = torch.zeros((), device=dev)
    cnt = torch.zeros((), device=dev)
    for i in range(batch["labels"].shape[0]):
        micro = {k: v[i] for k, v in batch.items()}
        stages.mark("frontend")
        feats, frame_lengths = _featurize_micro(cfg, micro)
        labels, label_lengths = micro["labels"], micro["label_lengths"]
        total, (mean_loss, logits, new_states) = _micro_loss(
            leaves, cfg, states, feats, frame_lengths, labels, label_lengths, rng)
        grads = iter(torch.autograd.grad(total, flat))
        grad_sum = optim.tree_map(lambda acc, _: acc + next(grads), grad_sum, leaves)
        stages.mark("metric")
        if cfg.train_metric:
            err = _error_rate(cfg, logits.detach(), frame_lengths, labels,
                              label_lengths, cfg.greedy_metric_max_out or labels.shape[1])
        else:
            err = torch.zeros((), device=dev)
        states = [(c.detach(), h.detach()) for c, h in new_states]
        # All-padding microbatches count for neither mean.
        real = ((frame_lengths > 0).sum() > 0).to(torch.float32)
        loss_sum = loss_sum + mean_loss.detach()
        err_sum = err_sum + err
        cnt = cnt + real
    return states, grad_sum, loss_sum, err_sum, cnt


def apply_grads(cfg: StepConfig, state: TrainState, states, grad_sum,
                mean_loss: Tensor, mean_err: Tensor, reset_state,
                grad_norm: Optional[Tensor] = None) -> Tuple[TrainState, Dict[str, Tensor]]:
    """Clip + Adam + the state-reset coin (the host draws it, the device
    applies it).  ``grad_norm`` overrides the locally computed norm."""
    stages.mark("clip_adam")
    params = state["params"]
    if grad_norm is None:
        clipped, grad_norm = optim.clip_by_global_norm(grad_sum, cfg.grad_clip)
    else:
        clipped, grad_norm = optim.clip_with_norm(grad_sum, cfg.grad_clip, grad_norm)
    new_params, new_opt = optim.adam_update(params, clipped, state["opt"], state["lr"])
    reset = torch.as_tensor(reset_state, device=grad_norm.device)
    states = optim.tree_map(lambda s: torch.where(reset, torch.zeros_like(s), s), states)
    new_state = {
        "params": new_params,
        "opt": new_opt,
        "states": states,
        "step": state["step"] + 1,
        "lr": state["lr"],
    }
    metrics = {"mean_loss": mean_loss, "mean_error_rate": mean_err,
               "grad_norm": grad_norm}
    return new_state, metrics


def train_step(cfg: StepConfig, state: TrainState, batch: Dict[str, Tensor],
               rng: torch.Generator, reset_state) -> Tuple[TrainState, Dict[str, Tensor]]:
    """One step over a batch whose entries lead with the microbatch axis
    (MB, B, ...): accumulate, then clip + Adam + reset."""
    states, grad_sum, loss_sum, err_sum, cnt = accumulate_grads(
        cfg, state["params"], state["states"], batch, rng)
    denom = torch.clamp(cnt, min=1.0)
    return apply_grads(cfg, state, states, grad_sum, loss_sum / denom,
                       err_sum / denom, reset_state)


@torch.no_grad()
def eval_step(cfg: StepConfig, state: TrainState,
              batch: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """Loss + greedy error rate over a batch, no dropout, fresh zero state
    per microbatch (the reference always reset state in evaluation).  The
    decode runs at the labels' width, whatever ``greedy_metric_max_out``
    (which caps only the train step's metric), as the JAX package's does."""
    params = state["params"]
    B = batch["labels"].shape[1]
    dev = batch["labels"].device
    loss_sum = torch.zeros((), device=dev)
    err_sum = torch.zeros((), device=dev)
    cnt = torch.zeros((), device=dev)
    for i in range(batch["labels"].shape[0]):
        micro = {k: v[i] for k, v in batch.items()}
        feats, frame_lengths = _featurize_micro(cfg, micro)
        logits, _ = acoustic.forward(params, cfg.model, feats, frame_lengths,
                                     acoustic.zero_state(cfg.model, B, device=dev))
        out_lengths = acoustic.output_lengths(cfg.model, frame_lengths)
        per = _ctc_loss_fn(cfg)(logits, out_lengths, micro["labels"],
                                micro["label_lengths"])
        denom = torch.clamp(out_lengths.to(torch.float32), min=1.0)
        real = (frame_lengths > 0).to(torch.float32)
        loss_sum = loss_sum + (per / denom * real).sum() / torch.clamp(real.sum(), min=1.0)
        err_sum = err_sum + _error_rate(cfg, logits, frame_lengths, micro["labels"],
                                        micro["label_lengths"], micro["labels"].shape[1])
        cnt = cnt + (real.sum() > 0).to(torch.float32)
    denom = torch.clamp(cnt, min=1.0)
    return {"mean_loss": loss_sum / denom, "mean_error_rate": err_sum / denom}


@torch.no_grad()
def forward_step(cfg: StepConfig, params, states, feats_tm: Tensor,
                 frame_lengths: Tensor):
    """Inference forward: logits + updated streaming state (no dropout)."""
    return acoustic.forward(params, cfg.model, feats_tm, frame_lengths, states)
