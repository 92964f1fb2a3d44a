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

* ``use_kernels`` and ``wavefront`` with >= 2 layers, gates residuals and
  no ``remat``: the whole stack as one diagonal walk
  (``ops/lstm_wavefront.py``);
* ``use_kernels`` otherwise: one recurrence kernel per layer
  (``ops/lstm_recurrence.py``; in training ``ops/lstm_layer_train.py``).

A kernel wrapper given CPU tensors runs its plain version.

Training (``dropout_rng`` given, a CPU ``torch.Generator``) runs the
differentiable wavefront stack (``lstm_stack_wavefront_train``: training
forward and reverse-diagonal kernels) when ``use_kernels`` and
``wavefront`` with >= 2 layers, gates residuals and no ``remat``; else,
with ``use_kernels``, the layered route: one differentiable layer at a
time (``ops/lstm_layer_train.py``, gates or recompute residuals); and
without kernels the plain time loop under autograd (the JAX scan path).
Dropout follows the JAX package's sites (``ops/dropout.py``; one seed
draw per site): on the wavefront route the input site is the fused
dropout, each inter-layer output + input pair is one Bernoulli(ko·ki)
drawn inside both wavefront kernels (drop mode 2; with
``RST_WAVEFRONT_SEED_DROP=0`` a materialized bf16 mask stream, drop mode
1, see ``_boundary_dropout``), and the top site goes to ``head_fused``
when given; the layered route drops [output, input] before each layer
above the first and the output after the top.

``remat`` runs each layer of the layered route under
``torch.utils.checkpoint``; ``time_chunk`` runs the stack in checkpointed
chunks of that many steps with carried state (``_lstm_stack_chunked``).
Recompute residuals in a low-precision compute dtype keep the activations
between layers in that dtype (the JAX package's low-precision chain).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from rnn_speech_tpu_torch.ops import dropout, random_bits
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
    it the stack runs inference: the keep probabilities, ``remat`` and the
    residual mode's storage are then moot, as in the JAX package.
    ``head_fused(seed, out)`` applies the top dropout site and the head as
    one op on the wavefront training route (``models/acoustic.py``'s
    ``_DroppedDense``)."""
    kw = dict(compute_dtype=compute_dtype, input_keep_prob=input_keep_prob,
              output_keep_prob=output_keep_prob, use_kernels=use_kernels,
              residual_mode=residual_mode, wavefront=wavefront)
    if time_chunk and x.shape[0] > time_chunk:
        out, new_states = _lstm_stack_chunked(layers, x, seq_lengths, states,
                                              dropout_rng, time_chunk, kw)
        return (head(out) if head is not None else out), new_states
    wave = (wavefront and use_kernels and len(layers) >= 2
            and residual_mode == "gates" and not remat)
    rng = dropout_rng
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
                drop = _boundary_dropout(random_bits.seed_words(rng), kp, x, len(layers),
                                         layers[0]["w_h"].shape[0])
            out, new_states = lstm_wavefront.lstm_stack_wavefront_train(
                layers, x, seq_lengths, states, compute_dtype=compute_dtype, **drop
            )
            if head_fused is not None and output_keep_prob < 1.0:
                return head_fused(random_bits.seed_words(rng), out), new_states
    else:
        out, new_states = _lstm_stack_layered(layers, x, seq_lengths, states, rng,
                                              remat, kw)
    out = dropout_site(rng, out, [output_keep_prob])
    return (head(out) if head is not None else out), new_states


def _boundary_dropout(seed, kp: float, x: Tensor, L: int, H: int) -> dict:
    """The wavefront's inter-layer dropout arguments from the site's seed
    words: drop mode 2 (both kernels draw the bits) unless
    ``RST_WAVEFRONT_SEED_DROP=0``, which materializes the (L-1, T, B, H)
    bf16 masks for drop mode 1 from the mask kernel
    (``dropout.boundary_masks``).

    ``RST_PALLAS_MASKGEN=0`` draws those masks from torch's own generator
    seeded with the seed words instead: the JAX package's A/B line
    (``jax.random.bernoulli``, no kernel), kept as it kept it.  Its bits
    differ between the CPU's and the card's generators and match no plain
    version, and no measurement of the port covers it: ``chip_smoke.py``
    does not drive it."""
    if os.environ.get("RST_WAVEFRONT_SEED_DROP", "1") != "0":
        return dict(drop_seed=seed, drop_keep=kp, drop_scale=1.0 / kp)
    shape = (L - 1, x.shape[0], x.shape[1], H)
    if os.environ.get("RST_PALLAS_MASKGEN", "1") == "0":
        g = torch.Generator(device=x.device).manual_seed((seed[0] << 32) | seed[1])
        masks = (torch.rand(shape, generator=g, device=x.device) < kp).to(torch.bfloat16)
        return dict(drop_masks=masks, drop_scale=1.0 / kp)
    masks, scale = dropout.boundary_masks(seed, shape, kp, x.device)
    return dict(drop_masks=masks, drop_scale=scale)


def _lstm_stack_layered(layers, x, seq_lengths, states, rng, remat, kw):
    """The layered route up to the top dropout site: [output, input] sites
    fused before each layer above the first, the input site before it."""
    cd = kw["compute_dtype"]
    if not kw["use_kernels"]:
        layer_fn = lambda p, o, s: lstm_layer_scan(p, o, seq_lengths, s, compute_dtype=cd)
    elif rng is None:
        layer_fn = lambda p, o, s: lstm_layer(p, o, seq_lengths, s, compute_dtype=cd)
    else:
        from rnn_speech_tpu_torch.ops.lstm_layer_train import lstm_layer_train

        layer_fn = lambda p, o, s: lstm_layer_train(
            p, o, seq_lengths, s, compute_dtype=cd, residual_mode=kw["residual_mode"])
    if remat and rng is not None:
        inner = layer_fn
        layer_fn = lambda p, o, s: checkpoint(inner, p, o, s, use_reentrant=False)
    # Recompute residuals in a low-precision compute dtype keep the
    # activations between layers in that dtype: the layer products round
    # to it anyway and its saved inputs are low-precision by design.
    low_precision_chain = (kw["use_kernels"] and kw["residual_mode"] == "recompute"
                           and cd != torch.float32)
    out = x.to(cd) if low_precision_chain else x
    new_states: List[LayerState] = []
    for idx, (params, state) in enumerate(zip(layers, states)):
        # Layer idx-1's output site and layer idx's input site, fused.
        keeps = ([kw["output_keep_prob"]] if idx > 0 else []) + [kw["input_keep_prob"]]
        out = dropout_site(rng, out, keeps)
        out, state = layer_fn(params, out, state)
        if low_precision_chain:
            out = out.to(cd)
        new_states.append(state)
    return out, new_states


def _chunk_seed(rng: torch.Generator) -> int:
    """A 64-bit seed for one chunk's own generator, drawn from ``rng``."""
    w0, w1 = random_bits.seed_words(rng)
    return (w0 << 32) | w1


def _run_chunk(layers, x_c, lens_c, states, seed, kw):
    """One chunk of the stack (no head).  Its dropout sites draw from a
    generator made here from ``seed``, so the backward's recomputation of
    a checkpointed chunk draws the forward's seed words again."""
    rng = None if seed is None else torch.Generator().manual_seed(seed)
    return lstm_stack(layers, x_c, lens_c, states, dropout_rng=rng, **kw)


def _lstm_stack_chunked(layers, x, seq_lengths, states, rng, time_chunk, kw):
    """The stack over chunks of ``time_chunk`` steps with carried states
    (``_lstm_stack_chunked``): x padded to whole chunks, each row's length
    clipped per chunk, each chunk checkpointed when training.  Returns
    (out (T, B, H), states)."""
    T = x.shape[0]
    C = time_chunk
    n_chunks = -(-T // C)
    xc = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, n_chunks * C - T))
    lens = torch.as_tensor(seq_lengths, device=x.device)
    states = list(states)
    outs = []
    for i in range(n_chunks):
        # Rows ending before or inside this chunk freeze via clipped lengths.
        lens_c = torch.clamp(lens - i * C, 0, C)
        x_c = xc[i * C:(i + 1) * C]
        if rng is None:
            out, states = _run_chunk(layers, x_c, lens_c, states, None, kw)
        else:
            # The seed is drawn here, outside the checkpoint: the
            # recomputation must not draw from ``rng`` again.
            out, states = checkpoint(_run_chunk, layers, x_c, lens_c, states,
                                     _chunk_seed(rng), kw, use_reentrant=False)
        outs.append(out)
    return torch.cat(outs)[:T], list(states)
