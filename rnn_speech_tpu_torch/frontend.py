"""Host constants and filterbank matrices of the audio frontend (numpy).

The port's own copy of what ``ops/frontend.py`` needs from the JAX
package's host frontend: frame timing, the fbank/MFCC dimensions, the
reference fbank path's HTK mel triangles on integer FFT bins, and the
librosa-style Slaney mel filterbank used by the MFCC path.
"""

from __future__ import annotations

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
