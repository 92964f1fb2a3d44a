"""Host audio frontend (numpy): constants, filterbanks and features.

The port's own copy of ``rnn_speech_tpu/frontend.py``: frame timing, the
fbank/MFCC dimensions, the reference fbank path's HTK mel triangles on
integer FFT bins, the librosa-style Slaney mel filterbank of the MFCC
path, and the host feature extractors behind ``AudioProcessor`` (the input
pipeline's ``on_device_frontend=False`` mode; ``ops/frontend.py`` is the
device path).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

FRAME_STRIDE = 0.01   # seconds
FRAME_SIZE = 0.025    # seconds

MFCC_DIM = 20
FBANK_NFFT = 512
FBANK_NFILT = 40
FBANK_DIM = 3 * FBANK_NFILT
DELTA_WIDTH = 9


def hz_to_mel_htk(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz, dtype=np.float64) / 700.0)


def mel_to_hz_htk(mel):
    return 700.0 * (10.0 ** (np.asarray(mel, dtype=np.float64) / 2595.0) - 1.0)


def hz_to_mel_slaney(hz):
    hz = np.asarray(hz, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mel = (hz - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        hz >= min_log_hz,
        min_log_mel + np.log(np.maximum(hz, 1e-10) / min_log_hz) / logstep,
        mel,
    )


def mel_to_hz_slaney(mel):
    mel = np.asarray(mel, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    hz = f_min + f_sp * mel
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        mel >= min_log_mel, min_log_hz * np.exp(logstep * (mel - min_log_mel)), hz
    )


def fbank_mel_matrix(sr: int, nfft: int = FBANK_NFFT,
                     nfilt: int = FBANK_NFILT) -> np.ndarray:
    """The fbank path's filterbank: HTK mel, integer FFT bins.

    Returns (nfilt, nfft//2 + 1): point-slope triangles on floored bins.
    """
    high_mel = hz_to_mel_htk(float(sr) / 2.0)
    mel_points = np.linspace(0.0, high_mel, nfilt + 2)
    hz_points = mel_to_hz_htk(mel_points)
    bins = np.floor((nfft + 1) * hz_points / sr)

    n_bins = nfft // 2 + 1
    weights = np.zeros((nfilt, n_bins), dtype=np.float64)
    for m in range(1, nfilt + 1):
        left, center, right = int(bins[m - 1]), int(bins[m]), int(bins[m + 1])
        for k in range(left, center):
            weights[m - 1, k] = (k - bins[m - 1]) / (bins[m] - bins[m - 1])
        for k in range(center, right):
            weights[m - 1, k] = (bins[m + 1] - k) / (bins[m + 1] - bins[m])
    return weights


def librosa_mel_matrix(sr: int, nfft: int, n_mels: int = 128) -> np.ndarray:
    """Slaney-style area-normalized mel filterbank (librosa semantics)."""
    fmax = sr / 2.0
    mels = np.linspace(hz_to_mel_slaney(0.0), hz_to_mel_slaney(fmax), n_mels + 2)
    mel_f = mel_to_hz_slaney(mels)
    fft_freqs = np.linspace(0.0, sr / 2.0, 1 + nfft // 2)

    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    return weights * enorm[:, None]


# --------------------------------------------------------------------- deltas

def delta(data: np.ndarray, width: int = DELTA_WIDTH, order: int = 1, axis: int = -1) -> np.ndarray:
    """Savitzky-Golay delta features (librosa.feature.delta semantics)."""
    from scipy.signal import savgol_filter   # only the host feature path needs it

    return savgol_filter(
        data, width, polyorder=order, deriv=order, axis=axis, mode="interp"
    )


# ---------------------------------------------------------------------- fbank

def extract_fbank(sig: np.ndarray, sr: int) -> Tuple[np.ndarray, int]:
    """120-dim log-mel filterbank + Δ + ΔΔ. Returns (features[T,120], T)."""
    sig = np.asarray(sig, dtype=np.float64)
    emphasized = np.append(sig[0:1], sig[1:] - 0.97 * sig[:-1])

    frame_length = int(round(FRAME_SIZE * sr))
    frame_step = int(round(FRAME_STRIDE * sr))
    signal_length = len(emphasized)
    num_frames = int(np.ceil(abs(signal_length - frame_length) / frame_step))
    if num_frames <= 0:    # exactly one window of signal: no frames to emit
        return np.zeros((0, FBANK_DIM), np.float32), 0

    pad_len = num_frames * frame_step + frame_length
    padded = np.concatenate([emphasized, np.zeros(pad_len - signal_length)])

    idx = (
        np.arange(frame_length)[None, :]
        + np.arange(num_frames)[:, None] * frame_step
    )
    frames = padded[idx] * np.hamming(frame_length)

    mag = np.abs(np.fft.rfft(frames, FBANK_NFFT))
    power = (mag ** 2) / FBANK_NFFT

    weights = fbank_mel_matrix(sr)
    banks = power @ weights.T                      # (frames, nfilt)
    banks = np.where(banks == 0.0, np.finfo(float).eps, banks)
    banks = 10.0 * np.log10(banks)                 # power dB
    banks -= banks.mean(axis=0) + 1e-8             # per-filter mean-norm over time

    banks = banks.T                                # (nfilt, frames)
    # Clips under DELTA_WIDTH frames (~0.1 s) can't fit the Savitzky-Golay
    # window; edge-pad the time axis for the delta fit and trim after, so
    # short clips featurize instead of raising from savgol_filter.
    if num_frames < DELTA_WIDTH:
        padded_banks = np.pad(
            banks, ((0, 0), (0, DELTA_WIDTH - num_frames)), mode="edge"
        )
        d1 = delta(padded_banks)[:, :num_frames]
        d2 = delta(delta(padded_banks))[:, :num_frames]
    else:
        d1 = delta(banks)
        d2 = delta(d1)
    feats = np.vstack([banks, d1, d2]).T           # (frames, 120)
    assert feats.shape[1] == FBANK_DIM
    return feats.astype(np.float32), len(feats)


# ----------------------------------------------------------------------- mfcc

def extract_mfcc(sig: np.ndarray, sr: int) -> Tuple[np.ndarray, int]:
    """20-dim MFCCs (librosa-style pipeline). Returns (features[T,20], T)."""
    sig = np.asarray(sig, dtype=np.float64)
    n_fft = int(round(sr * FRAME_SIZE))
    hop = int(round(sr * FRAME_STRIDE))

    # Centered STFT with reflect padding, hann window.
    pad = n_fft // 2
    padded = np.pad(sig, pad, mode="reflect") if len(sig) > pad else np.pad(
        sig, pad, mode="constant"
    )
    num_frames = 1 + (len(padded) - n_fft) // hop
    if num_frames <= 0:    # empty/near-empty signal: no frames to featurize
        return np.zeros((0, MFCC_DIM), np.float32), 0
    idx = np.arange(n_fft)[None, :] + np.arange(num_frames)[:, None] * hop
    window = np.hanning(n_fft + 1)[:-1]
    frames = padded[idx] * window
    power = np.abs(np.fft.rfft(frames, n_fft)) ** 2  # (frames, bins)

    mel = power @ librosa_mel_matrix(sr, n_fft).T    # (frames, 128)

    # power_to_db with ref=1.0, amin=1e-10, top_db=80.
    db = 10.0 * np.log10(np.maximum(mel, 1e-10))
    db = np.maximum(db, db.max() - 80.0)

    # Ortho DCT-II over the mel axis; keep the first 20 coefficients.
    from scipy.fft import dct

    coefs = dct(db, type=2, axis=1, norm="ortho")[:, :MFCC_DIM]
    return coefs.astype(np.float32), len(coefs)


# ------------------------------------------------------------ AudioProcessor

class AudioProcessor:
    """Host feature extractor with max-length truncation.

    Same surface as the reference class (process_audio_file/process_signal,
    feature_size, get_mfcc_length_from_duration) so the CLI and pipeline
    layers can treat host and device frontends interchangeably.
    """

    def __init__(self, max_input_seq_length: int, feature_type: str = "mfcc"):
        self.max_input_seq_length = max_input_seq_length
        self.feature_type = feature_type
        if feature_type == "mfcc":
            self._extract = extract_mfcc
            self.feature_size = MFCC_DIM
        elif feature_type == "fbank":
            self._extract = extract_fbank
            self.feature_size = FBANK_DIM
        else:
            raise ValueError(
                f"{feature_type} is not a valid extraction function, "
                "only fbank and mfcc are accepted."
            )

    @staticmethod
    def get_mfcc_length_from_duration(duration: float) -> int:
        """Estimated frame count for a duration (true size may be +1..+3)."""
        return int(duration // FRAME_STRIDE) - 1

    def process_audio_file(self, file_name: str) -> Tuple[np.ndarray, int]:
        from rnn_speech_tpu_torch import audio_io

        sig, sr = audio_io.load(file_name)
        return self.process_signal(sig, sr)

    def process_signal(self, sig: np.ndarray, sr: int) -> Tuple[np.ndarray, int]:
        """Returns (features truncated to max_input_seq_length, ORIGINAL
        frame count).  The pre-truncation length is the reference's
        documented contract (audioprocessor.py:59 "original length before
        padding") — callers use length > max to detect/skip too-long clips
        and must clamp it before using it as a frame count."""
        feats, length = self._extract(sig, sr)
        if length > self.max_input_seq_length:
            feats = feats[: self.max_input_seq_length]
        return feats, length
