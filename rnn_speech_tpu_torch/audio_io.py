"""Audio container IO: WAV, NIST SPHERE and FLAC (numpy), header probes.

The port's own copy of ``rnn_speech_tpu/audio_io.py``: WAV and
uncompressed SPHERE parsed in pure Python, FLAC through the native C++
decoder ``runtime/audiodec.py`` (built at first use, no fallback: the
pure-Python ``runtime/flac_py.py`` is only the tests' plain version),
duration probes that read only container headers, ``to_mono``, and the
polyphase Kaiser-windowed sinc ``resample`` (tap-for-tap the JAX
package's, so a clip decodes to the same waveform in both packages).
Ogg is probed and refused, as in the JAX package.
"""

from __future__ import annotations

import os
import struct
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


def _probe_wav_duration(path: str) -> float:
    with wave.open(path, "rb") as wf:
        rate = wf.getframerate()
        if rate <= 0:
            raise AudioFormatError(f"Zero sample rate in {path}")
        return wf.getnframes() / float(rate)


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


def sphere_segment_to_wav(sph_file: str, wav_file: str, start: float, end: float) -> None:
    """Cut [start, end] seconds from a SPHERE file into a 16-bit WAV."""
    data, rate = read_sphere(sph_file)
    lo = max(0, int(round(start * rate)))
    hi = min(len(data), int(round(end * rate)))
    write_wav(wav_file, data[lo:hi], rate)


def _probe_sphere_duration(path: str) -> float:
    with open(path, "rb") as fh:
        hdr = _parse_sphere_header(fh)
    rate = int(hdr.get("sample_rate", 0))
    count = int(hdr.get("sample_count", 0))
    if rate <= 0:
        raise AudioFormatError(f"Zero sample rate in {path}")
    return count / float(rate)


# ----------------------------------------------------------------------- FLAC

def _probe_flac_duration(path: str) -> float:
    """Duration from the STREAMINFO metadata block (first block, mandatory)."""
    with open(path, "rb") as fh:
        if fh.read(4) != b"fLaC":
            raise AudioFormatError(f"Not a FLAC file: {path}")
        header = fh.read(4)
        if len(header) < 4:
            raise AudioFormatError(f"Truncated FLAC file: {path}")
        block_type = header[0] & 0x7F
        length = int.from_bytes(header[1:4], "big")
        if block_type != 0 or length < 34:
            raise AudioFormatError(f"Missing STREAMINFO in {path}")
        info = fh.read(34)
    # 16+16 blocksizes, 24+24 framesizes, then 20 bits rate, 3 bits ch,
    # 5 bits bps, 36 bits total samples.
    packed = int.from_bytes(info[10:18], "big")
    sample_rate = packed >> 44
    total_samples = packed & ((1 << 36) - 1)
    if sample_rate == 0:
        raise AudioFormatError(f"Zero sample rate in {path}")
    return total_samples / float(sample_rate)


def read_flac(path: str) -> Tuple[np.ndarray, int]:
    """Decode FLAC -> (float32 (n, ch) in [-1, 1], rate) with the native
    C++ decoder.  A corrupt or truncated stream raises ``ValueError``; a
    library that cannot be built raises ``RuntimeError``."""
    from rnn_speech_tpu_torch.runtime import audiodec

    return audiodec.decode_flac(path)


# ----------------------------------------------------------------------- OGG

def _probe_ogg_duration(path: str) -> float:
    """Duration from the last Ogg page's granule position (Vorbis rate)."""
    with open(path, "rb") as fh:
        head = fh.read(512)
        if not head.startswith(b"OggS"):
            raise AudioFormatError(f"Not an Ogg file: {path}")
        idx = head.find(b"\x01vorbis")
        if idx < 0 or len(head) < idx + 16:
            raise AudioFormatError(f"No Vorbis header in {path}")
        rate = struct.unpack_from("<I", head, idx + 12)[0]
        fh.seek(0, os.SEEK_END)
        size = fh.tell()
        fh.seek(max(0, size - 65536))
        tail = fh.read()
    pos = tail.rfind(b"OggS")
    if pos < 0 or len(tail) < pos + 14:
        raise AudioFormatError(f"No final Ogg page in {path}")
    granule = struct.unpack_from("<q", tail, pos + 6)[0]
    if rate <= 0:
        raise AudioFormatError(f"Zero sample rate in {path}")
    return granule / float(rate)


# ------------------------------------------------------------------- dispatch

def probe_duration(path: str) -> float:
    """Duration in seconds from container headers only (no frame decode).
    Ogg raises: probing stays no wider than ``decode_audio``, so an Ogg
    corpus fails at the scan, not on every clip at load time."""
    with open(path, "rb") as fh:
        magic = fh.read(4)
    if magic == b"RIFF":
        return _probe_wav_duration(path)
    if magic == b"fLaC":
        return _probe_flac_duration(path)
    if magic == b"NIST":
        return _probe_sphere_duration(path)
    if magic == b"OggS":
        raise AudioFormatError(
            f"Ogg container probed but decoding is not supported: {path}"
        )
    raise AudioFormatError(f"Unrecognized audio container: {path}")


def decode_audio(path: str) -> Tuple[np.ndarray, int]:
    """Decode a supported container -> (float32 (n, ch), rate).  Ogg
    raises ``AudioFormatError``, as in the JAX package."""
    with open(path, "rb") as fh:
        magic = fh.read(4)
    if magic == b"RIFF":
        return read_wav(path)
    if magic == b"fLaC":
        return read_flac(path)
    if magic == b"NIST":
        return read_sphere(path)
    if magic == b"OggS":
        raise AudioFormatError(f"Ogg/Vorbis decoding is not supported: {path}")
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
