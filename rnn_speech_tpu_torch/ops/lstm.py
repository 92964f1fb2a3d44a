"""Stacked LSTM recurrence, time-major, in PyTorch.

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

A kernel wrapper given CPU tensors runs its plain version.

Training (``dropout_rng`` given, a CPU ``torch.Generator``) runs the
differentiable wavefront stack (``lstm_stack_wavefront_train``: training
forward and reverse-diagonal kernels) when ``use_kernels`` and
``wavefront`` with >= 2 layers, and the plain time loop under autograd
(the JAX scan path) without kernels.  Dropout follows the JAX package's
sites (``ops/dropout.py``; one seed draw per site): on the wavefront
route the input site is the fused dropout, each inter-layer output +
input pair is one Bernoulli(ko·ki) drawn inside both wavefront kernels
(drop mode 2), and the top site goes to ``head_fused`` when given; the
layered route drops [output, input] before each layer above the first and
the output after the top.  What later slices bring raises
``NotImplementedError`` naming the slice: ``time_chunk``, ``remat``,
recompute residuals and the layered kernel-training route.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rnn_speech_tpu_torch.ops import random_bits
from rnn_speech_tpu_torch.ops.dropout import dropout_site
from rnn_speech_tpu_torch.ops.lstm_recurrence import lstm_recurrence

Tensor = torch.Tensor
Params = Dict[str, Tensor]
LayerState = Tuple[Tensor, Tensor]  # (c, h), each (B, H)


def dot_f32(x: Tensor, w: Tensor, compute_dtype) -> Tensor:
    """x·W with both operands rounded to ``compute_dtype`` and float32
    accumulation and output (JAX's ``preferred_element_type=f32``).

    On a CUDA device a bf16 product goes to cuBLAS's bf16 GEMM with a
    float32 output, which autograd cannot differentiate; elsewhere, and
    where a gradient is needed, the rounded operands are multiplied in
    float32, whose products of bf16 values are exact."""
    xc, wc = x.to(compute_dtype), w.to(compute_dtype)
    needs_grad = torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)
    if x.is_cuda and compute_dtype == torch.bfloat16 and not needs_grad:
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


OFF_PATH_SLICE = "the off-path training slice (ROADMAP Queue B 11-12)"


def check_training_supported(*, time_chunk: int = 0, T: int = 0,
                             remat: bool = False, residual_mode: str = "gates"):
    """Raise ``NotImplementedError`` naming the slice that brings each
    training variant this slice leaves out."""
    if time_chunk and T > time_chunk:
        raise NotImplementedError(f"time_chunk training comes with {OFF_PATH_SLICE}")
    if remat:
        raise NotImplementedError(f"remat comes with {OFF_PATH_SLICE}")
    if residual_mode != "gates":
        raise NotImplementedError(
            f"residual_mode={residual_mode!r} (recompute kernels, B12) comes with "
            f"{OFF_PATH_SLICE}")


def lstm_stack(
    layers: Sequence[Params],
    x: Tensor,                     # (T, B, D)
    seq_lengths: Tensor,           # (B,)
    states: Sequence[LayerState],
    *,
    compute_dtype=torch.float32,
    dropout_rng: Optional[torch.Generator] = None,
    input_keep_prob: float = 1.0,
    output_keep_prob: float = 1.0,
    use_kernels: bool = False,
    remat: bool = False,
    time_chunk: int = 0,
    residual_mode: str = "gates",
    wavefront: bool = False,
    head=None,
    head_fused=None,
) -> Tuple[Tensor, List[LayerState]]:
    """Run the full stack.  Returns (outputs (T, B, H), or ``head(outputs)``
    when given, and the new per-layer (c, h) states).

    Pass ``dropout_rng`` to train (the result is differentiable); without
    it the stack runs inference and the training options are ignored, as
    in the JAX package.  ``head_fused(seed, out)`` applies the top
    dropout site and the head as one op on the wavefront training route
    (``models/acoustic.py``'s ``_DroppedDense``)."""
    wave = wavefront and use_kernels and len(layers) >= 2
    rng = dropout_rng
    if rng is not None:
        check_training_supported(time_chunk=time_chunk, T=x.shape[0], remat=remat,
                                 residual_mode=residual_mode)
        if use_kernels and not wave:
            raise NotImplementedError(
                "kernel training without the wavefront (wavefront off or one "
                f"layer: the layered train kernels, B11) comes with {OFF_PATH_SLICE}")
    if wave:
        from rnn_speech_tpu_torch.ops import lstm_wavefront

        x = dropout_site(rng, x, [input_keep_prob])
        if rng is None:
            out, new_states = lstm_wavefront.lstm_stack_wavefront_apply(
                layers, x, seq_lengths, states, compute_dtype=compute_dtype
            )
        else:
            # Each boundary's output + input pair is one Bernoulli(ko·ki),
            # drawn inside both wavefront kernels from one seed.
            kp = 1.0
            for p in (output_keep_prob, input_keep_prob):
                if p < 1.0:
                    kp *= float(p)
            drop = {}
            if kp < 1.0:
                drop = dict(drop_seed=random_bits.seed_words(rng), drop_keep=kp,
                            drop_scale=1.0 / kp)
            out, new_states = lstm_wavefront.lstm_stack_wavefront_train(
                layers, x, seq_lengths, states, compute_dtype=compute_dtype, **drop
            )
            if head_fused is not None and output_keep_prob < 1.0:
                return head_fused(random_bits.seed_words(rng), out), new_states
    else:
        layer_fn = lstm_layer if use_kernels else lstm_layer_scan
        out = x
        new_states: List[LayerState] = []
        for idx, (params, state) in enumerate(zip(layers, states)):
            # Layer idx-1's output site and layer idx's input site, fused.
            keeps = ([output_keep_prob] if idx > 0 else []) + [input_keep_prob]
            out = dropout_site(rng, out, keeps)
            out, state = layer_fn(params, out, seq_lengths, state,
                                  compute_dtype=compute_dtype)
            new_states.append(state)
    out = dropout_site(rng, out, [output_keep_prob])
    return (head(out) if head is not None else out), new_states
