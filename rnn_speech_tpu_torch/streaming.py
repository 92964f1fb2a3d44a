"""Streaming fbank featurization with whole-clip parity (host numpy/scipy).

The port's own copy of ``rnn_speech_tpu/streaming.py``, on the port's
``frontend.py`` constants and mel matrix.  ``StreamingFbank`` carries
across ``feed()`` calls exactly the state the whole-clip DSP
(``frontend.extract_fbank``) threads through time:

  * the previous raw sample (pre-emphasis ``x[n] - 0.97 x[n-1]``),
  * the un-framed emphasized-sample tail (frames always start at global
    multiples of the 10 ms step, never at chunk boundaries),
  * the Savitzky-Golay state for the deltas: interior outputs are the
    exact savgol correlation, the first/last half-window outputs scipy's
    ``mode="interp"`` edge fits, reproduced by buffering those windows,
  * a running per-filter mean for the normalization term.

So the delta channels equal the whole-clip featurization exactly for
every frame, and the static log-mel channels equal it up to the
per-filter normalization: the whole clip subtracts the clip mean, the
stream subtracts the running mean over frames 0..i for frame i, a
function of the frame's own index only, never of how the stream was
chunked.  Any chunking therefore yields bit-identical features.
Emission trails by 8 frames (two chained 9-wide savgol half-windows);
``flush()`` drains the tail with the whole-clip edge semantics.  MFCC has
no streaming form (its centered STFT is defined on the whole clip).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
from scipy.signal import savgol_coeffs, savgol_filter

from rnn_speech_tpu_torch import frontend

_HALF = (frontend.DELTA_WIDTH - 1) // 2      # 4 frames per savgol stage


class StreamingSavgol:
    """Streaming Savitzky-Golay derivative matching ``scipy.signal.
    savgol_filter(x, width, 1, deriv=1, mode="interp")`` output-for-output.

    ``push(x)`` accepts one input row and returns the output rows that
    became final (0, 1, or — when the head edge resolves — half+1 rows);
    ``flush()`` returns the remaining tail rows."""

    def __init__(self, width: int = frontend.DELTA_WIDTH):
        self.width = width
        self.half = (width - 1) // 2
        # Interior output = correlation of the centered window with these
        # coefficients (savgol_filter computes correlation, not conv).
        self.coeffs = savgol_coeffs(width, 1, deriv=1, use="dot")
        self.buf: List[np.ndarray] = []
        self.head_emitted = False

    def _edge(self, rows: np.ndarray) -> np.ndarray:
        """scipy's interp-mode outputs for one full window of rows."""
        return savgol_filter(
            rows, self.width, 1, deriv=1, axis=0, mode="interp"
        )

    def push(self, row: np.ndarray) -> List[np.ndarray]:
        self.buf.append(np.asarray(row, np.float64))
        out: List[np.ndarray] = []
        if not self.head_emitted:
            if len(self.buf) == self.width:
                # First full window: the head half-window edge fits plus
                # the first interior output, all from these `width` rows.
                window = np.stack(self.buf)
                edge = self._edge(window)
                out.extend(edge[: self.half + 1])
                self.head_emitted = True
            return out
        # Steady state: one interior output per push once the window slides.
        window = np.stack(self.buf[-self.width:])
        out.append(self.coeffs @ window)
        if len(self.buf) > self.width:
            self.buf.pop(0)
        return out

    def flush(self) -> List[np.ndarray]:
        if not self.buf:
            return []
        window = np.stack(self.buf)
        if not self.head_emitted:
            # Short stream (< width rows): whole-clip pads to the window
            # with edge rows (frontend.extract_fbank's short-clip branch).
            n = len(self.buf)
            padded = np.concatenate(
                [window, np.repeat(window[-1:], self.width - n, axis=0)]
            )
            return list(self._edge(padded)[:n])
        return list(self._edge(window)[-self.half:])


class StreamingFbank:
    """Chunked fbank-120 featurization with carried DSP state."""

    def __init__(self, sr: int, mean_norm: bool = True):
        self.sr = sr
        self.mean_norm = mean_norm
        self.frame_length = int(round(frontend.FRAME_SIZE * sr))
        self.frame_step = int(round(frontend.FRAME_STRIDE * sr))
        self.window = np.hamming(self.frame_length)
        self.weights = frontend.fbank_mel_matrix(sr)
        self.prev_raw: Optional[float] = None
        self.tail = np.zeros((0,), np.float64)   # emphasized, un-framed
        self.d1 = StreamingSavgol()
        self.d2 = StreamingSavgol()
        self.static: List[np.ndarray] = []       # un-normed, await deltas
        self.norm_means: List[np.ndarray] = []   # per-frame mean snapshot
        self.d1_rows: List[np.ndarray] = []
        self.d2_rows: List[np.ndarray] = []
        self.mean_sum = np.zeros((frontend.FBANK_NFILT,), np.float64)
        self.mean_count = 0
        self.total_samples = 0
        self.frames_done = 0

    @property
    def feature_size(self) -> int:
        return frontend.FBANK_DIM

    def _bank_rows(self, frames: np.ndarray) -> np.ndarray:
        """(n, frame_length) emphasized frames -> (n, nfilt) un-normalized
        log-mel rows, one vectorized pass (the exact math of
        ``frontend.extract_fbank``)."""
        mag = np.abs(np.fft.rfft(frames * self.window, frontend.FBANK_NFFT,
                                 axis=-1))
        power = (mag ** 2) / frontend.FBANK_NFFT
        banks = power @ self.weights.T
        banks = np.where(banks == 0.0, np.finfo(float).eps, banks)
        return 10.0 * np.log10(banks)

    def _advance(self, frames: np.ndarray) -> None:
        # FFT/mel vectorized over the batch of frames; only the savgol
        # state threading is inherently sequential.
        for row in self._bank_rows(frames):
            self.mean_sum += row
            self.mean_count += 1
            self.static.append(row)
            # Snapshot the running mean at the frame's OWN index: frame
            # i is normalized by the mean over frames 0..i regardless of
            # when savgol lookahead lets it emit.  Normalizing with the
            # emission-time mean instead would make the static channels
            # depend on the chunking (bigger feeds advance more frames
            # before emission), breaking decode chunk-size invariance
            # (tests/test_torch_streaming.py).
            if self.mean_norm:
                self.norm_means.append(
                    self.mean_sum / self.mean_count + 1e-8
                )
            else:
                self.norm_means.append(np.zeros_like(self.mean_sum))
            for d1_row in self.d1.push(row):
                self.d1_rows.append(d1_row)
                self.d2_rows.extend(self.d2.push(d1_row))

    def _emit(self) -> np.ndarray:
        n = min(len(self.static), len(self.d1_rows), len(self.d2_rows))
        if n == 0:
            return np.zeros((0, frontend.FBANK_DIM), np.float32)
        rows = [
            np.concatenate([
                self.static[i] - self.norm_means[i],
                self.d1_rows[i], self.d2_rows[i],
            ])
            for i in range(n)
        ]
        del self.static[:n], self.norm_means[:n]
        del self.d1_rows[:n], self.d2_rows[:n]
        return np.stack(rows).astype(np.float32)

    def feed(self, sig: np.ndarray) -> np.ndarray:
        """Consume one mono chunk; returns the feature rows that became
        final, ``(n, 120)`` float32 (possibly empty)."""
        sig = np.asarray(sig, dtype=np.float64)
        if sig.size == 0:
            return self._emit()
        if self.prev_raw is None:
            emphasized = np.append(sig[0:1], sig[1:] - 0.97 * sig[:-1])
        else:
            emphasized = sig - 0.97 * np.append(self.prev_raw, sig[:-1])
        self.prev_raw = float(sig[-1])
        self.total_samples += len(sig)
        buf = np.concatenate([self.tail, emphasized])

        # Eagerly advance only frames strictly inside the data so far: the
        # whole-clip formula ceil((L - flen)/step) emits one frame FEWER
        # than the complete-frame count when (L - flen) divides the step
        # exactly, so a frame ending exactly at the current stream end must
        # wait for flush() (where the total length resolves the count).
        n_frames = max(
            0,
            (len(buf) - self.frame_length - 1) // self.frame_step + 1,
        )
        if n_frames:
            idx = (
                np.arange(self.frame_length)[None, :]
                + np.arange(n_frames)[:, None] * self.frame_step
            )
            self._advance(buf[idx])
            self.frames_done += n_frames
        self.tail = buf[n_frames * self.frame_step:]
        return self._emit()

    def expected_frames(self) -> int:
        """The whole-clip frame count for everything fed so far — the
        reference's ceil(|L - frame_length| / frame_step) (including its
        short-clip abs() quirk, frontend.extract_fbank:124)."""
        if self.total_samples == 0:
            return 0
        return int(np.ceil(
            abs(self.total_samples - self.frame_length) / self.frame_step
        ))

    def flush(self) -> np.ndarray:
        """Drain to exactly the whole-clip featurization length: remaining
        frames (zero-padded past the stream end, the ceil-framing
        semantics) plus the savgol tail edge fits.  The featurizer resets
        and can be fed a new stream afterward."""
        extra = self.expected_frames() - self.frames_done
        if extra > 0:
            pad_len = extra * self.frame_step + self.frame_length
            padded = np.concatenate([
                self.tail,
                np.zeros(max(0, pad_len - len(self.tail))),
            ])[:pad_len]
            idx = (
                np.arange(self.frame_length)[None, :]
                + np.arange(extra)[:, None] * self.frame_step
            )
            self._advance(padded[idx])
        for d1_row in self.d1.flush():
            self.d1_rows.append(d1_row)
            self.d2_rows.extend(self.d2.push(d1_row))
        self.d2_rows.extend(self.d2.flush())
        out = self._emit()
        self.__init__(self.sr, self.mean_norm)
        return out
