"""Batched on-device audio frontend in PyTorch (fbank-120 and MFCC-20).

Counterpart of ``rnn_speech_tpu/ops/frontend_jax.py``:

    raw f32[B, S], lengths i32[B]  ->  features f32[B, T, D], frames i32[B]

* The windowed rFFT is a matmul against a precomputed DFT basis, summed
  over the K shifted (rows, step) views of the signal so the framed
  (B, T, frame_len) tensor is never built; power, mel projection and
  ``10*log10`` with the float64-eps floor follow
  (``frontend_kernel.fbank_banks_plain``).  With ``use_kernel`` the fbank
  path runs these stages as one CUDA kernel (``fbank_banks``).
* Masked mean normalisation over each row's valid frames, then
  Savitzky-Golay deltas with scipy's 'interp' edge handling and the
  short-clip line fit.
* Per-row frame counts follow the JAX package's formulas exactly.

Precision: the JAX package runs these float32 matmuls at
``Precision.HIGHEST``.  PyTorch's float32 matmul on a CUDA device is full
float32 as long as ``torch.backends.cuda.matmul.allow_tf32`` stays False
(its default; TF32 keeps about three decimal digits), so this module
never enables it and ``chip_smoke.py`` asserts it is off.  No
convolution runs here, so cuDNN's own TF32 switch does not apply.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from rnn_speech_tpu_torch import frontend as host
from rnn_speech_tpu_torch.ops import frontend_kernel

FRAME_STRIDE = host.FRAME_STRIDE
FRAME_SIZE = host.FRAME_SIZE


def _windowed_dft_basis(frame_length: int, n_fft: int,
                        window: np.ndarray) -> np.ndarray:
    """Real-DFT basis with the analysis window folded in: (frame_length,
    2*bins), columns [cos | -sin]; rows past n_fft are zero (rfft's
    truncation)."""
    bins = n_fft // 2 + 1
    rows = min(frame_length, n_fft)
    n = np.arange(rows)[:, None]
    k = np.arange(bins)[None, :]
    angle = -2.0 * np.pi * n * k / n_fft
    basis = np.concatenate([np.cos(angle), np.sin(angle)], axis=1)
    basis = basis * window[:rows, None]
    if rows < frame_length:
        basis = np.concatenate(
            [basis, np.zeros((frame_length - rows, 2 * bins))], axis=0
        )
    return basis.astype(np.float32)


def _savgol_delta(x: torch.Tensor, n_valid: torch.Tensor,
                  width: int = 9) -> torch.Tensor:
    """Savitzky-Golay delta (polyorder=1, deriv=1, mode='interp').

    x: (B, T, D); n_valid: (B,) frames.  Interior frames use the linear
    regression kernel k/sum(k^2); the first and last half-windows take the
    edge window's slope; padding frames are edge-replicated; rows shorter
    than the window use the head fit everywhere.
    """
    half = width // 2
    k = np.arange(-half, half + 1, dtype=np.float32)
    denom = float((k ** 2).sum())
    B, T, D = x.shape
    dev = x.device

    t_idx = torch.arange(T, device=dev)[None, :]                 # (1, T)
    last = (n_valid.to(torch.int64) - 1)[:, None]                # (B, 1)
    last_frame = torch.where(
        (t_idx == last)[:, :, None], x, torch.zeros((), device=dev)
    ).sum(dim=1, keepdim=True)                                   # (B, 1, D)
    xg = torch.where((t_idx <= last)[:, :, None], x, last_frame)

    xpad = torch.cat(
        [xg[:, :1].expand(B, half, D), xg, xg[:, -1:].expand(B, half, D)],
        dim=1,
    )
    acc = torch.zeros_like(xg)
    for j, w in enumerate(k / denom):
        acc = acc + float(w) * xpad[:, j : j + T]
    interior = acc

    w_head = torch.as_tensor(k / denom, device=dev)
    head_slope = torch.einsum("w,bwd->bd", w_head, xg[:, :width, :])

    t_f = t_idx.to(torch.float32)
    n_f = n_valid[:, None].to(torch.float32)
    in_tail = (t_f >= n_f - width) & (t_f <= n_f - 1)
    w_tail = torch.where(in_tail, (t_f - (n_f - 1 - half)) / denom,
                         torch.zeros((), device=dev))
    tail_slope = torch.einsum("bt,btd->bd", w_tail, xg)

    out = interior
    out = torch.where(t_idx[:, :, None] < half, head_slope[:, None, :], out)
    out = torch.where(t_idx[:, :, None] > last[:, :, None] - half,
                      tail_slope[:, None, :], out)
    short = (n_valid < width)[:, None, None]
    return torch.where(short, head_slope[:, None, :], out)


class DeviceFrontend:
    """Featurizer for a fixed (feature_type, sr) on one device; every shape
    follows the width of the signal buffer it is given.  ``use_kernel``
    (the JAX ``use_pallas``, fbank only, off by default) takes the
    spectrogram stages from the fused kernel (``ops/frontend_kernel.py``)."""

    def __init__(self, feature_type: str, sr: int = 22050,
                 max_samples: int = 22050 * 10, device=None, use_kernel: bool = False):
        from rnn_speech_tpu_torch import resolve_device

        self.device = resolve_device(device)
        self.feature_type = feature_type
        self.use_kernel = bool(use_kernel) and feature_type == "fbank"
        self.sr = sr
        self.max_samples = max_samples
        self.frame_step = int(round(FRAME_STRIDE * sr))
        as_t = lambda a: torch.as_tensor(
            np.asarray(a, np.float32), device=self.device
        )
        if feature_type == "fbank":
            self.frame_length = int(round(FRAME_SIZE * sr))
            self.n_fft = host.FBANK_NFFT
            self.feature_size = host.FBANK_DIM
            window = np.hamming(self.frame_length)
            self._basis = as_t(
                _windowed_dft_basis(self.frame_length, self.n_fft, window)
            )
            self._mel = as_t(host.fbank_mel_matrix(sr).T)
            if self.use_kernel:
                self._kernel_tables = frontend_kernel.kernel_tables(
                    self._basis, self._mel, self.n_fft)
        elif feature_type == "mfcc":
            self.n_fft = int(round(sr * FRAME_SIZE))
            self.frame_length = self.n_fft
            self.feature_size = host.MFCC_DIM
            # Centered STFT over a reflect-padded signal.
            self._center_slack = 2 * (self.n_fft // 2) - self.n_fft
            window = np.hanning(self.n_fft + 1)[:-1]
            self._basis = as_t(
                _windowed_dft_basis(self.n_fft, self.n_fft, window)
            )
            self._mel = as_t(host.librosa_mel_matrix(sr, self.n_fft).T)
            n_mels = self._mel.shape[1]
            nmat = np.arange(n_mels)[:, None]
            kmat = np.arange(host.MFCC_DIM)[None, :]
            dct = np.cos(np.pi * (2 * nmat + 1) * kmat / (2 * n_mels)) * 2.0
            dct *= np.where(kmat == 0, np.sqrt(1.0 / (4 * n_mels)),
                            np.sqrt(1.0 / (2 * n_mels)))
            self._dct = as_t(dct)
        else:
            raise ValueError(f"Unknown feature type {feature_type!r}")
        self.max_frames = self._frames_for_width(max_samples)

    # ------------------------------------------------------------ frame counts

    def _frames_for_width(self, n_samples: int) -> int:
        """Frame count for a signal buffer of width n_samples."""
        if self.feature_type == "fbank":
            return int(np.ceil(abs(n_samples - self.frame_length) / self.frame_step))
        return 1 + (n_samples + self._center_slack) // self.frame_step

    def num_frames_for(self, n_samples: torch.Tensor,
                       limit: Optional[int] = None) -> torch.Tensor:
        """Per-example valid frame count; zero-length rows get 0 frames."""
        n_samples = n_samples.to(torch.int32)
        if self.feature_type == "fbank":
            nf = torch.ceil(
                (n_samples - self.frame_length).abs().to(torch.float32)
                / self.frame_step
            ).to(torch.int32)
        else:
            nf = 1 + torch.div(n_samples + self._center_slack,
                               self.frame_step, rounding_mode="floor")
        nf = torch.where(n_samples <= 0, torch.zeros_like(nf), nf)
        return nf.clamp(0, self.max_frames if limit is None else limit).to(
            torch.int32
        )

    # ------------------------------------------------------------------ call

    def __call__(self, signals: torch.Tensor,
                 lengths: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """signals f32[B, n], lengths i32[B] -> (feats (B, T, D), frames)."""
        signals = torch.as_tensor(signals, dtype=torch.float32,
                                  device=self.device)
        lengths = torch.as_tensor(lengths, device=self.device).to(torch.int64)
        if self.feature_type == "fbank":
            return self._fbank(signals, lengths)
        return self._mfcc(signals, lengths)

    def _frame(self, padded: torch.Tensor, n_frames: int) -> torch.Tensor:
        """Overlapping frames (B, n_frames, frame_length) from K shifted
        views of the (rows, step) reshape: frames[t, l] = padded[t*step+l]."""
        B = padded.shape[0]
        step, length = self.frame_step, self.frame_length
        K = -(-length // step)
        rows = n_frames + K
        need = rows * step
        if padded.shape[1] < need:
            padded = torch.nn.functional.pad(padded, (0, need - padded.shape[1]))
        view = padded[:, :need].reshape(B, rows, step)
        pieces = [view[:, k : k + n_frames, :] for k in range(K)]
        return torch.cat(pieces, dim=-1)[:, :, :length]

    def _fbank(self, signals, lengths):
        n_samples = signals.shape[1]
        n_frames = self._frames_for_width(n_samples)
        s_idx = torch.arange(n_samples, device=self.device)[None, :]
        signals = torch.where(s_idx < lengths[:, None], signals,
                              torch.zeros((), device=self.device))
        pre = torch.cat(
            [signals[:, :1], signals[:, 1:] - 0.97 * signals[:, :-1]], dim=1
        )

        # Framing, windowed DFT, power, mel and log: the fused kernel, or
        # K matmuls over shifted views of the signal.
        args = (pre, self._basis, self._mel, self.frame_step, n_frames, self.n_fft)
        if self.use_kernel:
            banks = frontend_kernel.fbank_banks(*args, tables=self._kernel_tables)
        else:
            banks = frontend_kernel.fbank_banks_plain(*args)     # (B, T, nfilt)

        nf = self.num_frames_for(lengths, limit=n_frames)
        t_idx = torch.arange(n_frames, device=self.device)[None, :]
        valid = (t_idx < nf[:, None])[:, :, None]                # (B, T, 1)
        zero = torch.zeros((), device=self.device)
        mean = torch.where(valid, banks, zero).sum(dim=1, keepdim=True) / (
            nf.clamp(min=1)[:, None, None].to(banks.dtype)
        )
        banks = banks - (mean + 1e-8)

        d1 = _savgol_delta(banks, nf)
        d2 = _savgol_delta(d1, nf)
        feats = torch.cat([banks, d1, d2], dim=-1)
        feats = torch.where(valid, feats, zero)
        return feats.to(torch.float32), nf

    def _mfcc(self, signals, lengths):
        B, n_samples = signals.shape
        n_frames = self._frames_for_width(n_samples)
        dev = self.device
        s_idx = torch.arange(n_samples, device=dev)[None, :]
        zero = torch.zeros((), device=dev)
        signals = torch.where(s_idx < lengths[:, None], signals, zero)

        # Reflect-pad by n_fft//2 (librosa center=True); the right-hand
        # reflection mirrors around each clip's true end.
        pad = self.n_fft // 2
        left = signals[:, 1 : pad + 1].flip(1)
        starts = (lengths - 1 - pad).clamp(0, n_samples - pad)
        ar = torch.arange(pad, device=dev)[None, :]
        tail = torch.gather(signals, 1, starts[:, None] + ar).flip(1)
        # Clips no longer than the pad are constant-padded (zeros) on both
        # sides, as the host reference does when reflection is undefined.
        short = (lengths <= pad)[:, None]
        left = torch.where(short, zero, left)
        tail = torch.where(short, zero, tail)
        base = torch.cat(
            [left, signals, torch.zeros((B, pad), device=dev)], dim=1
        )
        gathered = base.scatter(1, (pad + lengths)[:, None] + ar, tail)

        frames = self._frame(gathered, n_frames)
        spec = torch.matmul(frames, self._basis)
        bins = self.n_fft // 2 + 1
        power = spec[..., :bins] ** 2 + spec[..., bins:] ** 2

        mel = torch.matmul(power, self._mel)
        db = 10.0 * torch.log10(mel.clamp(min=1e-10))

        nf = self.num_frames_for(lengths, limit=n_frames)
        t_idx = torch.arange(n_frames, device=dev)[None, :]
        valid = (t_idx < nf[:, None])[:, :, None]
        peak = torch.where(valid, db, torch.full((), -float("inf"), device=dev))
        peak = peak.amax(dim=(1, 2), keepdim=True)
        db = torch.maximum(db, peak - 80.0)

        coefs = torch.matmul(db, self._dct)
        coefs = torch.where(valid, coefs, zero)
        return coefs.to(torch.float32), nf
