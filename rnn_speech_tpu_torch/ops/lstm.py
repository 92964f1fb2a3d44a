"""Stacked LSTM recurrence, time-major, in PyTorch (inference).

Counterpart of ``rnn_speech_tpu/ops/lstm.py``.  The cell is the JAX
package's (and the reference's ``BasicLSTMCell``): gate order (i, g, f, o)
with forget-gate bias +1.0; outputs past a row's true length are zero and
its state freezes at the last valid step.  ``torch.nn.LSTM`` is not used:
its gate order is (i, f, g, o) and it has no +1.

The input contribution ``x·W_x + b`` for all steps of a layer is one
large matmul before the recurrence; the recurrence itself is either the
plain loop here (``lstm_layer_scan``, the counterpart of the JAX scan
path) or one of the two hand-written kernels:

* ``use_kernels`` and ``wavefront`` with >= 2 layers: the whole stack as
  one diagonal walk (``ops/lstm_wavefront.py``);
* ``use_kernels`` otherwise: one recurrence kernel per layer
  (``ops/lstm_recurrence.py``).

A kernel wrapper given CPU tensors runs its plain version.  Dropout,
``time_chunk`` and ``remat`` belong to training and come with the
training slice.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from rnn_speech_tpu_torch.ops.lstm_recurrence import lstm_recurrence

Tensor = torch.Tensor
Params = Dict[str, Tensor]
LayerState = Tuple[Tensor, Tensor]  # (c, h), each (B, H)


def dot_f32(x: Tensor, w: Tensor, compute_dtype) -> Tensor:
    """x·W with both operands rounded to ``compute_dtype`` and float32
    accumulation and output (JAX's ``preferred_element_type=f32``).

    On a CUDA device a bf16 product goes to cuBLAS's bf16 GEMM with a
    float32 output; elsewhere the rounded operands are multiplied in
    float32, whose products of bf16 values are exact."""
    xc, wc = x.to(compute_dtype), w.to(compute_dtype)
    if x.is_cuda and compute_dtype == torch.bfloat16:
        lead = xc.shape[:-1]
        y = torch.mm(xc.reshape(-1, xc.shape[-1]), wc, out_dtype=torch.float32)
        return y.reshape(*lead, wc.shape[-1])
    return torch.matmul(xc.to(torch.float32), wc.to(torch.float32))


def length_mask(T: int, seq_lengths: Tensor, device) -> Tensor:
    """(T, 1, B) float32 {0, 1}: step t is valid for row b iff t < len[b]."""
    lens = torch.as_tensor(seq_lengths, device=device)
    t = torch.arange(T, device=device)[:, None]
    return (t < lens[None, :]).to(torch.float32)[:, None, :]


def xavier_uniform(generator: torch.Generator, shape, device=None) -> Tensor:
    fan_in, fan_out = shape[-2], shape[-1]
    limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return ((u * 2.0 - 1.0) * limit).to(device)


def init_lstm_stack(generator: torch.Generator, num_layers: int,
                    input_size: int, hidden_size: int,
                    device=None) -> List[Params]:
    """Layer l maps (input_size if l == 0 else H) -> H; zero biases."""
    layers = []
    for l in range(num_layers):
        in_dim = input_size if l == 0 else hidden_size
        layers.append({
            "w_x": xavier_uniform(generator, (in_dim, 4 * hidden_size), device),
            "w_h": xavier_uniform(generator, (hidden_size, 4 * hidden_size), device),
            "b": torch.zeros((4 * hidden_size,), device=device),
        })
    return layers


def zero_state(num_layers: int, batch_size: int, hidden_size: int,
               device=None) -> List[LayerState]:
    return [
        (torch.zeros((batch_size, hidden_size), device=device),
         torch.zeros((batch_size, hidden_size), device=device))
        for _ in range(num_layers)
    ]


def cell_step(c: Tensor, h: Tensor, x_proj_t: Tensor, mask_t: Tensor,
              w_h: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """One timestep of one layer -> (c, h, y); ``mask_t`` is (B,) bool."""
    gates = x_proj_t + torch.matmul(
        h.to(w_h.dtype).to(torch.float32), w_h.to(torch.float32)
    )
    i, g, f, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    m = mask_t[:, None]
    y = torch.where(m, h_new, torch.zeros((), device=h.device))
    return torch.where(m, c_new, c), torch.where(m, h_new, h), y


def lstm_layer_scan(params: Params, x: Tensor, seq_lengths: Tensor,
                    state: LayerState,
                    compute_dtype=torch.float32) -> Tuple[Tensor, LayerState]:
    """One layer over the full sequence as a plain time loop (the JAX scan
    path).  Returns (outputs (T, B, H), (c, h))."""
    T = x.shape[0]
    cd = compute_dtype
    x_proj = dot_f32(x, params["w_x"], cd) + params["b"].to(torch.float32)
    mask = length_mask(T, seq_lengths, x.device)[:, 0].to(torch.bool)
    w_h = params["w_h"].to(cd)
    c, h = state
    c, h = c.to(torch.float32), h.to(torch.float32)
    ys = []
    for t in range(T):
        c, h, y = cell_step(c, h, x_proj[t], mask[t], w_h)
        ys.append(y)
    out = torch.stack(ys) if ys else x_proj.new_zeros((0,) + h.shape)
    return out, (c, h)


def lstm_layer(params: Params, x: Tensor, seq_lengths: Tensor,
               state: LayerState,
               compute_dtype=torch.float32) -> Tuple[Tensor, LayerState]:
    """One layer through the recurrence kernel (the inference primal of
    ``lstm_pallas.lstm_layer_pallas``).  Returns (out, (c, h))."""
    T = x.shape[0]
    cd = compute_dtype
    x_proj = dot_f32(x, params["w_x"], cd) + params["b"].to(torch.float32)
    mask = length_mask(T, seq_lengths, x.device)
    c0, h0 = state
    out, hn, cn = lstm_recurrence(
        x_proj, params["w_h"].to(cd).contiguous(), mask,
        h0.to(torch.float32).contiguous(), c0.to(torch.float32).contiguous(),
    )
    return out, (cn, hn)


def lstm_stack(
    layers: Sequence[Params],
    x: Tensor,                     # (T, B, D)
    seq_lengths: Tensor,           # (B,)
    states: Sequence[LayerState],
    *,
    compute_dtype=torch.float32,
    use_kernels: bool = False,
    wavefront: bool = False,
    head=None,
) -> Tuple[Tensor, List[LayerState]]:
    """Run the full stack (inference).  Returns (outputs (T, B, H), or
    ``head(outputs)`` when given, and the new per-layer (c, h) states)."""
    if wavefront and use_kernels and len(layers) >= 2:
        from rnn_speech_tpu_torch.ops.lstm_wavefront import (
            lstm_stack_wavefront_apply,
        )

        out, new_states = lstm_stack_wavefront_apply(
            layers, x, seq_lengths, states, compute_dtype=compute_dtype
        )
    else:
        layer_fn = lstm_layer if use_kernels else lstm_layer_scan
        out = x
        new_states: List[LayerState] = []
        for params, state in zip(layers, states):
            out, state = layer_fn(params, out, seq_lengths, state,
                                  compute_dtype=compute_dtype)
            new_states.append(state)
    return (head(out) if head is not None else out), new_states
