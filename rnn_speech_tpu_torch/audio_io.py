"""Audio container IO for the serving path: WAV and NIST SPHERE (numpy).

The port's own copy of the readers in ``rnn_speech_tpu/audio_io.py``:
WAV and uncompressed SPHERE parsed in pure Python, ``to_mono``, and the
polyphase Kaiser-windowed sinc ``resample`` (tap-for-tap the JAX
package's, so a clip decodes to the same waveform in both packages).

FLAC and Ogg need the native decoder of the JAX package's runtime; they
come with the port's runtime slice and raise a clear error until then.
"""

from __future__ import annotations

import wave
from typing import Optional, Tuple

import numpy as np

DEFAULT_SAMPLE_RATE = 22050


class AudioFormatError(Exception):
    """Raised when a container cannot be parsed."""


# ------------------------------------------------------------------------ WAV

def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Decode a PCM WAV file -> (float32 [-1, 1] of shape (n, ch), rate)."""
    try:
        with wave.open(path, "rb") as wf:
            n_channels = wf.getnchannels()
            sampwidth = wf.getsampwidth()
            rate = wf.getframerate()
            n_frames = wf.getnframes()
            raw = wf.readframes(n_frames)
    except (wave.Error, EOFError) as exc:
        raise AudioFormatError(f"Bad WAV file {path}: {exc}") from exc

    if sampwidth == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sampwidth == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif sampwidth == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sampwidth == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        ints = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
        data = ints.astype(np.float32) / float(1 << 23)
    else:
        raise AudioFormatError(f"Unsupported WAV sample width {sampwidth} in {path}")

    return data.reshape(-1, n_channels), rate


def write_wav(path: str, data: np.ndarray, rate: int) -> None:
    """Write float [-1, 1] or int16 samples as a 16-bit PCM WAV."""
    arr = np.asarray(data)
    if arr.ndim == 1:
        arr = arr[:, None]
    if arr.dtype != np.int16:
        arr = np.clip(arr, -1.0, 1.0)
        arr = (arr * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as wf:
        wf.setnchannels(arr.shape[1])
        wf.setsampwidth(2)
        wf.setframerate(rate)
        wf.writeframes(arr.astype("<i2").tobytes())


# --------------------------------------------------------------------- SPHERE

def _parse_sphere_header(fh) -> dict:
    """NIST SPHERE: 1024-byte (usually) ASCII header of `key type value`."""
    head = fh.read(8)
    if not head.startswith(b"NIST_1A"):
        raise AudioFormatError("Not a NIST SPHERE file")
    size_line = fh.read(8)
    try:
        header_size = int(size_line.strip())
    except ValueError as exc:
        raise AudioFormatError("Bad SPHERE header size") from exc
    body = fh.read(header_size - 16).decode("ascii", errors="replace")
    fields = {}
    for line in body.split("\n"):
        parts = line.strip().split(" ", 2)
        if len(parts) != 3 or parts[0] in ("end_head",):
            continue
        key, typ, val = parts
        if typ.startswith("-i"):
            fields[key] = int(val)
        elif typ.startswith("-r"):
            fields[key] = float(val)
        else:
            fields[key] = val
    fields["_header_size"] = header_size
    return fields


def read_sphere(path: str) -> Tuple[np.ndarray, int]:
    """Decode an uncompressed PCM SPHERE file -> (float32 (n, ch), rate)."""
    with open(path, "rb") as fh:
        hdr = _parse_sphere_header(fh)
        coding = str(hdr.get("sample_coding", "pcm"))
        if "ulaw" in coding:
            raise AudioFormatError(f"ulaw SPHERE not supported natively: {path}")
        if "embedded" in coding or "shorten" in coding:
            raise AudioFormatError(f"Compressed SPHERE not supported natively: {path}")
        n_bytes = int(hdr.get("sample_n_bytes", 2))
        channels = int(hdr.get("channel_count", 1))
        rate = int(hdr.get("sample_rate", 16000))
        count = int(hdr.get("sample_count", 0))
        fh.seek(hdr["_header_size"])
        raw = fh.read(count * n_bytes * channels if count else -1)

    byte_format = str(hdr.get("sample_byte_format", "01"))
    if n_bytes == 2:
        dtype = ">i2" if byte_format == "10" else "<i2"
        data = np.frombuffer(raw, dtype=dtype).astype(np.float32) / 32768.0
    elif n_bytes == 1:
        data = np.frombuffer(raw, dtype=np.int8).astype(np.float32) / 128.0
    else:
        raise AudioFormatError(f"Unsupported SPHERE sample width {n_bytes}")
    usable = (len(data) // channels) * channels
    return data[:usable].reshape(-1, channels), rate


# ------------------------------------------------------------------- dispatch

def decode_audio(path: str) -> Tuple[np.ndarray, int]:
    """Decode a supported container -> (float32 (n, ch), rate)."""
    with open(path, "rb") as fh:
        magic = fh.read(4)
    if magic == b"RIFF":
        return read_wav(path)
    if magic == b"NIST":
        return read_sphere(path)
    if magic in (b"fLaC", b"OggS"):
        raise AudioFormatError(
            f"{path}: FLAC/Ogg decoding needs the native decoder, which the "
            "port brings with its runtime slice (native loader and FLAC "
            "decode); convert the clip to WAV for now"
        )
    raise AudioFormatError(f"Unrecognized audio container: {path}")


def to_mono(data: np.ndarray) -> np.ndarray:
    """(n, ch) -> (n,) by channel averaging (librosa.to_mono semantics)."""
    if data.ndim == 1:
        return data
    if data.shape[1] == 1:
        return data[:, 0]
    return data.mean(axis=1)


def _polyphase_table(orig_sr: int, target_sr: int):
    """Kaiser-windowed sinc polyphase taps: 16 zero crossings per side,
    beta 5.0 (the JAX package's native loader constants)."""
    from math import ceil, gcd

    from scipy.special import i0

    g = gcd(int(orig_sr), int(target_sr))
    up, down = target_sr // g, orig_sr // g
    cutoff = min(1.0, target_sr / orig_sr)
    k_zeros, beta = 16, 5.0
    half = int(ceil(k_zeros / cutoff))
    p = np.arange(up, dtype=np.float64)[:, None]
    k = np.arange(2 * half, dtype=np.float64)[None, :]
    dn = (k - half + 1) - p / up
    u = dn / half
    t = dn * cutoff
    sinc = np.sinc(t)                      # sin(pi t)/(pi t), sinc(0)=1
    win = i0(beta * np.sqrt(np.clip(1.0 - u * u, 0.0, None))) / i0(beta)
    taps = np.where(np.abs(u) <= 1.0, cutoff * sinc * win, 0.0)
    return up, down, half, taps.astype(np.float32)


def resample(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase Kaiser-windowed sinc resampling, produced in bounded
    chunks so the window gather stays O(chunk x filter width)."""
    if orig_sr == target_sr or len(x) == 0:
        return np.asarray(x, np.float32)
    up, down, half, taps = _polyphase_table(int(orig_sr), int(target_sr))
    n_in = len(x)
    n_out = -(-n_in * int(target_sr) // int(orig_sr))   # ceil
    width = 2 * half
    pad = width
    xp = np.zeros(n_in + 2 * pad, np.float32)
    xp[pad : pad + n_in] = x
    taps64 = taps.astype(np.float64)
    out = np.empty(n_out, np.float32)
    CHUNK = 1 << 16
    offsets = np.arange(width)[None, :] + pad
    for lo in range(0, n_out, CHUNK):
        i = np.arange(lo, min(lo + CHUNK, n_out), dtype=np.int64)
        num = i * down
        start = num // up - half + 1
        phase = (num % up).astype(np.int64)
        idx = start[:, None] + offsets
        out[lo : lo + len(i)] = np.einsum(
            "ow,ow->o", taps64[phase], xp[idx].astype(np.float64)
        )
    return out


def load(
    path: str, sr: Optional[int] = DEFAULT_SAMPLE_RATE, mono: bool = True
) -> Tuple[np.ndarray, int]:
    """librosa.load analogue: decode, downmix, resample (``sr=None`` keeps
    the native rate)."""
    data, native_sr = decode_audio(path)
    out = to_mono(data) if mono else data
    if sr is not None and sr != native_sr:
        out = resample(out, native_sr, sr)
        native_sr = sr
    return np.ascontiguousarray(out, dtype=np.float32), native_sr
