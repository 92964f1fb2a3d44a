"""Minimal FLAC encoder: the port's copy of ``rnn_speech_tpu/runtime/flac_enc.py``.

Produces spec-valid FLAC streams (correct CRC-8/CRC-16, STREAMINFO, UTF-8
frame numbers) using VERBATIM or FIXED(order<=2)+Rice subframes, so
corpora in LibriSpeech's container can be rendered where no FLAC tool is
installed (tests, ``chip_smoke.py``).  Not a production encoder: no LPC
search, no stereo decorrelation.
"""

from __future__ import annotations

from typing import List

import numpy as np


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.buf = 0
        self.nbits = 0

    def write(self, value: int, n: int) -> None:
        value &= (1 << n) - 1
        self.buf = (self.buf << n) | value
        self.nbits += n
        while self.nbits >= 8:
            self.out.append((self.buf >> (self.nbits - 8)) & 0xFF)
            self.nbits -= 8
        self.buf &= (1 << self.nbits) - 1

    def write_signed(self, value: int, n: int) -> None:
        self.write(value & ((1 << n) - 1), n)

    def write_unary(self, q: int) -> None:
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)

    def align(self) -> None:
        if self.nbits:
            self.write(0, 8 - self.nbits)

    def bytes(self) -> bytes:
        assert self.nbits == 0
        return bytes(self.out)


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def _crc16_bitwise(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
    return crc


# CRC-16 (polynomial 0x8005, MSB first) a byte at a time: the table holds
# the bitwise CRC of each byte value in the top byte.
_CRC16_TABLE = [_crc16_bitwise(bytes([i])) for i in range(256)]


def _crc16(data: bytes) -> int:
    crc = 0
    table = _CRC16_TABLE
    for b in data:
        crc = ((crc << 8) & 0xFFFF) ^ table[(crc >> 8) ^ b]
    return crc


def _zigzag(r: int) -> int:
    return (r << 1) if r >= 0 else ((-r << 1) - 1)


def _write_residual(bw: _BitWriter, residual: List[int]) -> None:
    # Single partition, best 4-bit Rice parameter (or escape to raw).
    # The cost of each parameter summed in numpy (the same integers as a
    # Python sum over the residual).
    zz = np.asarray([_zigzag(r) for r in residual], dtype=np.int64)
    best_param, best_cost = 0, None
    for param in range(15):
        cost = int((zz >> param).sum()) + len(residual) * (1 + param)
        if best_cost is None or cost < best_cost:
            best_param, best_cost = param, cost
    bw.write(0, 2)   # method: 4-bit Rice
    bw.write(0, 4)   # partition order 0
    bw.write(best_param, 4)
    for r in residual:
        u = _zigzag(r)
        bw.write_unary(u >> best_param)
        if best_param:
            bw.write(u & ((1 << best_param) - 1), best_param)


def encode_flac(
    path: str,
    pcm: np.ndarray,
    sample_rate: int,
    bits_per_sample: int = 16,
    blocksize: int = 4096,
    subframe: str = "fixed2",
) -> None:
    """Write int PCM (n,) or (n, ch) to ``path`` as a FLAC file."""
    arr = np.asarray(pcm)
    if arr.ndim == 1:
        arr = arr[:, None]
    arr = arr.astype(np.int64)
    n, channels = arr.shape

    header = bytearray(b"fLaC")
    info = _BitWriter()
    info.write(blocksize, 16)
    info.write(blocksize, 16)
    info.write(0, 24)
    info.write(0, 24)
    info.write(sample_rate, 20)
    info.write(channels - 1, 3)
    info.write(bits_per_sample - 1, 5)
    info.write(n >> 32, 4)
    info.write(n & 0xFFFFFFFF, 32)
    for _ in range(16):
        info.write(0, 8)
    body = info.bytes()
    header += bytes([0x80]) + len(body).to_bytes(3, "big") + body

    stream = bytearray(header)
    frame_idx = 0
    for start in range(0, n, blocksize):
        block = arr[start : start + blocksize]
        bs = len(block)

        bw = _BitWriter()
        bw.write(0x3FFE, 14)
        bw.write(0, 1)          # reserved
        bw.write(0, 1)          # fixed blocksize strategy (frame number coded)
        bw.write(7, 4)          # blocksize: 16-bit value at end of header
        bw.write(0, 4)          # sample rate: from STREAMINFO
        bw.write(channels - 1, 4)
        bw.write({8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}[bits_per_sample], 3)
        bw.write(0, 1)          # reserved
        # UTF-8 coded frame number (support up to 2 bytes for tests).
        if frame_idx < 0x80:
            bw.write(frame_idx, 8)
        else:
            bw.write(0xC0 | (frame_idx >> 6), 8)
            bw.write(0x80 | (frame_idx & 0x3F), 8)
        bw.write(bs - 1, 16)
        head_no_crc = bw  # CRC-8 over everything so far
        bw.align()
        partial = bytes(head_no_crc.out)
        bw.write(_crc8(partial), 8)

        for c in range(channels):
            samples = [int(v) for v in block[:, c]]
            if subframe == "verbatim" or bs <= 2:
                bw.write(0, 1)
                bw.write(1, 6)   # VERBATIM
                bw.write(0, 1)
                for v in samples:
                    bw.write_signed(v, bits_per_sample)
            elif subframe == "constant":
                bw.write(0, 1)
                bw.write(0, 6)
                bw.write(0, 1)
                bw.write_signed(samples[0], bits_per_sample)
            else:  # fixed order-2 predictor + Rice residual
                order = 2
                bw.write(0, 1)
                bw.write(8 + order, 6)
                bw.write(0, 1)
                for v in samples[:order]:
                    bw.write_signed(v, bits_per_sample)
                residual = [
                    samples[i] - 2 * samples[i - 1] + samples[i - 2]
                    for i in range(order, bs)
                ]
                _write_residual(bw, residual)

        bw.align()
        frame_bytes = bytes(bw.out)
        bw.write(_crc16(frame_bytes), 16)
        stream += bw.bytes()
        frame_idx += 1

    with open(path, "wb") as fh:
        fh.write(stream)
