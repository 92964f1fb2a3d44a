"""Acoustic model: input projection -> stacked LSTM -> output projection.

Counterpart of ``rnn_speech_tpu/models/acoustic.py`` (inference): a
per-timestep input projection, optional batch normalisation over the
batch axis, N stacked LSTM layers, and an output projection to the char
map, with the recurrent state passed in and returned.  Time-major
(T, B, D) throughout.  The projections are matmuls in the compute dtype
with float32 accumulation, plus the bias.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch

from rnn_speech_tpu_torch import resolve_device
from rnn_speech_tpu_torch.ops import lstm

Tensor = torch.Tensor
Params = Dict[str, Any]
States = List[lstm.LayerState]


@dataclass(frozen=True)
class AcousticConfig:
    num_layers: int
    hidden_size: int
    input_dim: int
    num_labels: int
    normalization: bool = False
    compute_dtype: torch.dtype = torch.float32
    # Run the LSTM recurrence through the hand-written CUDA kernels (the
    # JAX package's ``use_pallas``); on CPU tensors the kernel wrappers run
    # their plain versions.
    use_kernels: bool = False
    # Whole-stack diagonal kernel (ops/lstm_wavefront.py); needs
    # use_kernels and >= 2 layers, else the layered path runs.
    wavefront: bool = False
    # Stack N adjacent frames and subsample time by N before the LSTM.
    frame_stack: int = 1


def init_params(generator: torch.Generator, cfg: AcousticConfig,
                device=None) -> Params:
    """Xavier-uniform weights and zero biases from ``generator``, on
    ``device`` (default cuda)."""
    dev = resolve_device(device)
    in_dim = cfg.input_dim * max(cfg.frame_stack, 1)
    return {
        "input": {
            "w": lstm.xavier_uniform(generator, (in_dim, cfg.hidden_size), dev),
            "b": torch.zeros((cfg.hidden_size,), device=dev),
        },
        "lstm": lstm.init_lstm_stack(
            generator, cfg.num_layers, cfg.hidden_size, cfg.hidden_size, dev
        ),
        "output": {
            "w": lstm.xavier_uniform(generator, (cfg.hidden_size, cfg.num_labels), dev),
            "b": torch.zeros((cfg.num_labels,), device=dev),
        },
    }


def config_for_params(params: Params, **kw) -> AcousticConfig:
    """An AcousticConfig whose widths are read off a parameter dict."""
    return AcousticConfig(
        num_layers=len(params["lstm"]),
        hidden_size=params["lstm"][0]["w_h"].shape[0],
        input_dim=params["input"]["w"].shape[0] // max(kw.get("frame_stack", 1), 1),
        num_labels=params["output"]["w"].shape[1],
        **kw,
    )


def zero_state(cfg: AcousticConfig, batch_size: int, device=None) -> States:
    return lstm.zero_state(cfg.num_layers, batch_size, cfg.hidden_size,
                           device=device)


def _batch_norm(x: Tensor, eps: float = 1e-3) -> Tensor:
    """Normalise over the batch axis per (time, feature), no scale/offset.

    Deviation kept from the JAX package: with batch size 1 the reference's
    formula gives identically zero activations, so B == 1 is an identity."""
    if x.shape[1] == 1:
        return x
    mean = x.mean(dim=1, keepdim=True)
    var = x.var(dim=1, keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps)


def stack_frames(x: Tensor, seq_lengths: Tensor, n: int) -> Tuple[Tensor, Tensor]:
    """(T, B, D) -> (ceil(T/n), B, n*D) by concatenating adjacent frames;
    lengths become ceil(len/n); padding sub-frames are zero."""
    T, B, D = x.shape
    T_pad = -(-T // n) * n
    if T_pad != T:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, T_pad - T))
    x = x.reshape(T_pad // n, n, B, D).permute(0, 2, 1, 3).reshape(
        T_pad // n, B, n * D
    )
    lens = torch.as_tensor(seq_lengths, device=x.device)
    return x, -torch.div(-lens, n, rounding_mode="floor")


def _dense(h: Tensor, w: Tensor, b: Tensor, cd) -> Tensor:
    return lstm.dot_f32(h, w, cd) + b


def forward(params: Params, cfg: AcousticConfig, inputs: Tensor,
            seq_lengths: Tensor, states: States) -> Tuple[Tensor, States]:
    """Inference forward -> (logits (T', B, num_labels) float32, new
    states), T' = ceil(T / frame_stack)."""
    if cfg.frame_stack > 1:
        inputs, seq_lengths = stack_frames(inputs, seq_lengths, cfg.frame_stack)
    cd = cfg.compute_dtype
    x = _dense(inputs, params["input"]["w"], params["input"]["b"], cd)
    if cfg.normalization:
        x = _batch_norm(x)
    head = lambda h: _dense(h, params["output"]["w"], params["output"]["b"], cd)
    return lstm.lstm_stack(
        params["lstm"], x, seq_lengths, states,
        compute_dtype=cd, use_kernels=cfg.use_kernels,
        wavefront=cfg.wavefront, head=head,
    )


def output_lengths(cfg: AcousticConfig, frame_lengths: Tensor) -> Tensor:
    """Valid logit count per example of ``forward``'s output."""
    if cfg.frame_stack > 1:
        return -torch.div(-frame_lengths, cfg.frame_stack, rounding_mode="floor")
    return frame_lengths


def param_count(params: Params) -> int:
    from rnn_speech_tpu_torch.params import flatten

    return sum(int(p.numel()) for p in flatten(params).values())
