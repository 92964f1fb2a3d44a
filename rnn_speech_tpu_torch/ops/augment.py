"""SpecAugment: time and frequency masking of the training features
(Park et al., arXiv:1904.08779).

Counterpart of ``rnn_speech_tpu/ops/augment.py``, split in two so the
masks can be held against the JAX package's bit for bit:

  * ``draw_masks`` makes the random draws from an explicit
    ``torch.Generator``: each example's frequency-mask widths and the
    uniforms that place them, and the uniforms that size and place its
    time masks (the four draws the JAX function makes from its four keys);
  * ``apply_masks`` turns given draws into the masked features.

Frequency masks zero a band of mel channels; for fbank-120 the same band
is zeroed across the static/Δ/ΔΔ groups (the three views of one mel
channel).  Time masks zero a span of frames whose width is drawn relative
to each utterance's true length.  Plain PyTorch, as the JAX one is plain
``jnp``; eval paths never call it.
"""

from __future__ import annotations

from typing import Dict

import torch

Tensor = torch.Tensor


def draw_masks(generator: torch.Generator, batch: int, channels: int, *,
               n_freq_masks: int = 2, freq_mask_width: int = 8,
               n_time_masks: int = 2, device=None) -> Dict[str, Tensor]:
    """The draws of one call for ``batch`` examples of ``channels`` mel
    channels, on the generator's device, moved to ``device``:
    ``f_width`` (B, n_freq_masks) int32 in [0, min(width, C)], and the
    float32 uniforms in [0, 1) ``u_fs`` (B, n_freq_masks) (band starts),
    ``u_w`` and ``u_s`` (B, n_time_masks) (time widths and starts)."""
    hi = min(freq_mask_width, channels) + 1
    f_width = torch.randint(0, hi, (batch, n_freq_masks), generator=generator,
                            device=generator.device, dtype=torch.int32)
    u_fs = torch.rand((batch, n_freq_masks), generator=generator,
                      device=generator.device)
    u_w = torch.rand((batch, n_time_masks), generator=generator,
                     device=generator.device)
    u_s = torch.rand((batch, n_time_masks), generator=generator,
                     device=generator.device)
    out = {"f_width": f_width, "u_fs": u_fs, "u_w": u_w, "u_s": u_s}
    if device is not None:
        out = {k: v.to(device) for k, v in out.items()}
    return out


def apply_masks(feats: Tensor, frame_lengths: Tensor, draws: Dict[str, Tensor],
                *, time_mask_ratio: float = 0.05, groups: int = 1) -> Tensor:
    """``feats`` (T, B, D) time-major with the bands and spans that
    ``draws`` place zeroed; ``frame_lengths`` (B,) true frame counts."""
    T, B, D = feats.shape
    channels = D // groups
    f_width = draws["f_width"].to(torch.int32)
    # Start in [0, C - f]: every band keeps its full width.
    f_start = (draws["u_fs"] * (channels - f_width + 1).to(torch.float32)).to(torch.int32)
    ch_idx = torch.arange(channels, device=feats.device)[None, :, None]
    f_masked = ((ch_idx >= f_start[:, None, :])
                & (ch_idx < (f_start + f_width)[:, None, :])).any(dim=-1)   # (B, C)
    f_masked = f_masked.repeat(1, groups)                                 # (B, D)

    lengths = frame_lengths.to(torch.int32)
    max_w = torch.clamp((lengths.to(torch.float32) * time_mask_ratio).to(torch.int32),
                        min=1)                                            # (B,)
    # Width in [0, max_w] inclusive; start in [0, length - width].
    t_width = (draws["u_w"] * (max_w[:, None] + 1).to(torch.float32)).to(torch.int32)
    span = torch.clamp(lengths[:, None] - t_width + 1, min=1)
    t_start = (draws["u_s"] * span.to(torch.float32)).to(torch.int32)
    t_idx = torch.arange(T, device=feats.device)[None, :, None]
    t_masked = ((t_idx >= t_start[:, None, :])
                & (t_idx < (t_start + t_width)[:, None, :])).any(dim=-1)  # (B, T)

    keep = ~(f_masked[None, :, :] | t_masked.T[:, :, None])              # (T, B, D)
    return torch.where(keep, feats, torch.zeros((), dtype=feats.dtype, device=feats.device))


def spec_augment(feats: Tensor, frame_lengths: Tensor, generator: torch.Generator,
                 *, n_freq_masks: int = 2, freq_mask_width: int = 8,
                 n_time_masks: int = 2, time_mask_ratio: float = 0.05,
                 groups: int = 1) -> Tensor:
    """``feats`` (T, B, D) with random time/frequency bands zeroed per
    example: draws from ``generator``, applied."""
    T, B, D = feats.shape
    draws = draw_masks(generator, B, D // groups, n_freq_masks=n_freq_masks,
                       freq_mask_width=freq_mask_width, n_time_masks=n_time_masks,
                       device=feats.device)
    return apply_masks(feats, frame_lengths, draws, time_mask_ratio=time_mask_ratio,
                       groups=groups)


def groups_for_feature_dim(feature_dim: int) -> int:
    """Channel groups for a feature layout: the fbank static/Δ/ΔΔ triple
    shares one mel-channel axis; anything else masks as one flat group."""
    from rnn_speech_tpu_torch.frontend import FBANK_DIM

    return 3 if feature_dim == FBANK_DIM else 1
