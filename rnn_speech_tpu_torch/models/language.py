"""Character-level language model: one-hot characters in, the next
character's distribution out, with carried state.

Counterpart of ``rnn_speech_tpu/models/language.py``: the acoustic model's
body (input projection -> stacked LSTM -> output projection) with
``input_dim == num_labels``, trained by next-character cross-entropy with
length masking (``next_char_loss``), stepped one character at a time for
shallow fusion in the beam search (``stepper``), and sampled for
``--generate_text`` (``sample_next``, ``generate``).

The JAX LM runs the scan path: its ``as_acoustic()`` leaves ``use_pallas``
at False and the compute dtype at float32, so no Pallas kernel lies on
it.  Its counterpart here is ``AcousticConfig(use_kernels=False)`` in
float32, whose recurrence is the plain time loop of ``ops/lstm.py``
(``lstm_layer_scan``): the counterpart of an XLA path, not a plain
version standing in for a kernel.  Dropout, when training, goes through
the dropout sites of ``ops/dropout.py`` (the dropout kernel on the card).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from rnn_speech_tpu_torch.models import acoustic

Tensor = torch.Tensor


@dataclass(frozen=True)
class LanguageConfig:
    num_layers: int
    hidden_size: int
    num_labels: int
    compute_dtype: torch.dtype = torch.float32

    def as_acoustic(self) -> acoustic.AcousticConfig:
        return acoustic.AcousticConfig(
            num_layers=self.num_layers,
            hidden_size=self.hidden_size,
            input_dim=self.num_labels,     # one-hot characters
            num_labels=self.num_labels,
            normalization=False,
            compute_dtype=self.compute_dtype,
        )


def init_params(generator: torch.Generator, cfg: LanguageConfig, device=None):
    """Xavier-uniform weights and zero biases from ``generator``, on
    ``device`` (default cuda)."""
    return acoustic.init_params(generator, cfg.as_acoustic(), device)


def zero_state(cfg: LanguageConfig, batch_size: int, device=None):
    return acoustic.zero_state(cfg.as_acoustic(), batch_size, device=device)


def one_hot(ids: Tensor, num_labels: int) -> Tensor:
    """float32 one-hot rows of ``ids`` (ids are in range)."""
    return F.one_hot(ids.long(), num_labels).to(torch.float32)


def forward(params, cfg: LanguageConfig, one_hot_inputs: Tensor,
            seq_lengths: Tensor, states, *,
            dropout_rng: Optional[torch.Generator] = None,
            input_keep_prob: float = 1.0,
            output_keep_prob: float = 1.0) -> Tuple[Tensor, list]:
    """(T, B, num_labels) one-hot inputs -> (logits (T, B, num_labels),
    new states)."""
    return acoustic.forward(
        params, cfg.as_acoustic(), one_hot_inputs, seq_lengths, states,
        dropout_rng=dropout_rng, input_keep_prob=input_keep_prob,
        output_keep_prob=output_keep_prob,
    )


def stepper(params, cfg: LanguageConfig):
    """(init, advance): the single-character stepping interface of the
    beam search's shallow fusion.  State leaves are (N, H), log-prob
    outputs (N, num_labels).  ``init(n)`` conditions on a zero input
    vector (the no-context prior: the char map has no BOS symbol);
    ``advance(state, chars)`` consumes one character id per row.  Both run
    on the device of ``params``."""
    dev = params["output"]["w"].device

    def run(states, x):
        n = x.shape[1]
        ones = torch.ones((n,), dtype=torch.int32, device=dev)
        logits, states = forward(params, cfg, x, ones, states)
        return states, torch.log_softmax(logits[0], dim=-1)

    def init(n: int):
        x = torch.zeros((1, n, cfg.num_labels), dtype=torch.float32, device=dev)
        return run(zero_state(cfg, n, device=dev), x)

    def advance(states, chars: Tensor):
        return run(states, one_hot(chars, cfg.num_labels)[None])

    return init, advance


def next_char_loss(params, cfg: LanguageConfig, char_ids: Tensor,
                   seq_lengths: Tensor, states, *,
                   dropout_rng: Optional[torch.Generator] = None,
                   input_keep_prob: float = 1.0,
                   output_keep_prob: float = 1.0) -> Tensor:
    """Mean masked cross-entropy of predicting char[t+1] from chars[<=t];
    ``char_ids`` (T, B) padded with -1, ``seq_lengths`` (B,)."""
    T, B = char_ids.shape
    safe = torch.clamp(char_ids, min=0)
    logits, _ = forward(
        params, cfg, one_hot(safe, cfg.num_labels), seq_lengths, states,
        dropout_rng=dropout_rng, input_keep_prob=input_keep_prob,
        output_keep_prob=output_keep_prob,
    )
    # The target at step t is the char at t+1; the last valid step has none.
    targets = torch.cat([safe[1:], torch.zeros_like(safe[:1])], dim=0).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets[:, :, None])[..., 0]
    lens = torch.as_tensor(seq_lengths, device=char_ids.device)
    t = torch.arange(T, device=char_ids.device)[:, None]
    mask = (t < (lens - 1)[None, :]).to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def sample_next(params, cfg: LanguageConfig, char_id: Tensor, states, *,
                generator: Optional[torch.Generator] = None,
                temperature: float = 0.0):
    """One autoregressive step: (B,) char ids -> (next ids (B,), states).
    Temperature 0 (or no generator) takes the argmax, the lowest index
    among equal logits; else samples from softmax(logits / temperature)
    with ``generator`` (a generator of the params' device)."""
    dev = params["output"]["w"].device
    logits, states = forward(params, cfg, one_hot(char_id, cfg.num_labels)[None],
                             torch.ones_like(char_id), states)
    logits = logits[0]
    if temperature <= 0.0 or generator is None:
        return torch.argmax(logits, dim=-1).to(torch.int32), states
    probs = torch.softmax(logits / temperature, dim=-1)
    ids = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return ids.to(device=dev, dtype=torch.int32), states


def generate(params, cfg: LanguageConfig, seed_ids: Sequence[int], num_steps: int, *,
             generator: Optional[torch.Generator] = None,
             temperature: float = 0.0) -> List[int]:
    """``num_steps`` characters continuing ``seed_ids`` (a batch of 1)."""
    dev = params["output"]["w"].device
    states = zero_state(cfg, 1, device=dev)
    ids = None
    for s in seed_ids:
        ids, states = sample_next(
            params, cfg, torch.tensor([s], dtype=torch.int32, device=dev), states,
            generator=generator, temperature=temperature)
    out = []
    for _ in range(num_steps):
        out.append(int(ids[0]))
        ids, states = sample_next(params, cfg, ids, states, generator=generator,
                                  temperature=temperature)
    return out
