"""Greedy CTC decoding on the device (batched, time-major).

Counterpart of ``greedy_decode``, ``greedy_stream_decode`` and
``_left_compact`` in ``rnn_speech_tpu/ops/decode.py``: argmax, collapse
repeats, strip blanks, and left-compact the kept symbols into a (B, U)
array padded with -1.  The JAX package compacts by a co-sort because a
scatter serialises on the TPU; here a cumsum gives each kept symbol its
output slot and one scatter writes it.  Beam search comes with the
port's decoding slice.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _left_compact(chars: torch.Tensor, keep: torch.Tensor,
                  U: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Left-compact kept symbols along the leading time axis.

    ``chars``/``keep`` are (T, B); returns (out (B, U) padded with -1,
    lengths (B,) int32, capped at U)."""
    T, B = chars.shape
    keep = keep.to(torch.bool)
    pos = torch.cumsum(keep.to(torch.int64), dim=0) - 1          # slot per t
    # Dropped entries, and kept ones past U, go to a spill column U.
    slot = torch.where(keep & (pos < U), pos, torch.full_like(pos, U))
    out = torch.full((B, U + 1), -1, dtype=torch.int32, device=chars.device)
    out.scatter_(1, slot.t(), chars.t().to(torch.int32))
    lengths = keep.sum(dim=0).clamp(max=U).to(torch.int32)
    return out[:, :U].contiguous(), lengths


def greedy_decode(
    logits: torch.Tensor,          # (T, B, V)
    logit_lengths: torch.Tensor,   # (B,)
    blank_id: int = -1,
    max_output: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best-path decode -> (labels (B, U) padded with -1, lengths (B,));
    U = max_output or T."""
    T, B, V = logits.shape
    if blank_id < 0:
        blank_id = V + blank_id
    U = max_output or T
    best = torch.argmax(logits, dim=-1).to(torch.int32)           # (T, B)
    prev = torch.cat(
        [torch.full((1, B), -1, dtype=torch.int32, device=logits.device),
         best[:-1]], dim=0
    )
    lens = torch.as_tensor(logit_lengths, device=logits.device)
    valid = torch.arange(T, device=logits.device)[:, None] < lens[None, :]
    keep = valid & (best != blank_id) & (best != prev)
    return _left_compact(best, keep, U)


def greedy_stream_decode(
    logits: torch.Tensor,          # (T, B, V)
    logit_lengths: torch.Tensor,   # (B,)
    prev: torch.Tensor,            # (B,) last valid frame's raw argmax
    blank_id: int = -1,
    max_output: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Chunk-carried greedy decode: the repeat collapse sees the previous
    chunk's final frame through ``prev`` (start at -1), so feeding chunks
    and concatenating reproduces the whole-clip ``greedy_decode`` text.
    Returns (labels (B, U), lengths (B,), new_prev (B,))."""
    T, B, V = logits.shape
    if blank_id < 0:
        blank_id = V + blank_id
    U = max_output or T
    dev = logits.device
    prev = torch.as_tensor(prev, device=dev).to(torch.int32)
    best = torch.argmax(logits, dim=-1).to(torch.int32)
    prev_shift = torch.cat([prev[None, :], best[:-1]], dim=0)
    lens = torch.as_tensor(logit_lengths, device=dev).to(torch.int64)
    valid = torch.arange(T, device=dev)[:, None] < lens[None, :]
    keep = valid & (best != blank_id) & (best != prev_shift)
    out, lengths = _left_compact(best, keep, U)
    last = (lens - 1).clamp(min=0)
    last_best = best.gather(0, last[None, :])[0]
    new_prev = torch.where(lens > 0, last_best, prev)
    return out, lengths, new_prev
