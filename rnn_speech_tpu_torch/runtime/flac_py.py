"""Pure-Python FLAC decoder: the port's copy of ``rnn_speech_tpu/runtime/flac_py.py``.

CONSTANT / VERBATIM / FIXED / LPC subframes, Rice and Rice2 residuals
with escapes, stereo decorrelation, wasted bits.  The plain version that
the tests and ``chip_smoke.py`` hold the native decoder
(``runtime/audiodec.py``) against; nothing on the main path calls it.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


class _BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0          # byte position
        self.buf = 0
        self.nbits = 0

    def read(self, n: int) -> int:
        while self.nbits < n:
            if self.pos >= len(self.data):
                raise EOFError("FLAC bitstream exhausted")
            self.buf = (self.buf << 8) | self.data[self.pos]
            self.pos += 1
            self.nbits += 8
        val = (self.buf >> (self.nbits - n)) & ((1 << n) - 1)
        self.nbits -= n
        # Keep only the unread bits: an ever-growing buffer makes every
        # shift cost the length of the stream read so far.
        self.buf &= (1 << self.nbits) - 1
        return val

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        if n and (v >> (n - 1)):
            v -= 1 << n
        return v

    def read_unary(self) -> int:
        count = 0
        while self.read(1) == 0:
            count += 1
        return count

    def align(self) -> None:
        self.nbits -= self.nbits % 8

    def skip_bytes(self, n: int) -> None:
        self.align()
        while n > 0 and self.nbits >= 8:
            self.nbits -= 8
            n -= 1
        self.pos += n
        if self.pos > len(self.data):
            raise EOFError("FLAC bitstream exhausted")

    def at_end(self) -> bool:
        return self.pos >= len(self.data) and self.nbits < 14


_FIXED_COEFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}


def _decode_residual(br: _BitReader, order: int, blocksize: int, out: List[int]) -> None:
    method = br.read(2)
    if method > 1:
        raise ValueError("Reserved residual method")
    param_bits, escape = (4, 0xF) if method == 0 else (5, 0x1F)
    partition_order = br.read(4)
    partitions = 1 << partition_order
    if blocksize % partitions != 0:
        raise ValueError("Bad partition order")
    idx = order
    for p in range(partitions):
        count = (blocksize >> partition_order) - (order if p == 0 else 0)
        param = br.read(param_bits)
        if param == escape:
            raw = br.read(5)
            for _ in range(count):
                out[idx] = br.read_signed(raw) if raw else 0
                idx += 1
        else:
            for _ in range(count):
                q = br.read_unary()
                r = br.read(param) if param else 0
                u = (q << param) | r
                out[idx] = (u >> 1) ^ -(u & 1)
                idx += 1


def _decode_subframe(br: _BitReader, blocksize: int, bps: int) -> List[int]:
    if br.read(1) != 0:
        raise ValueError("Bad subframe padding bit")
    type_code = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = br.read_unary() + 1
        bps -= wasted

    out = [0] * blocksize
    if type_code == 0:  # CONSTANT
        v = br.read_signed(bps)
        out = [v] * blocksize
    elif type_code == 1:  # VERBATIM
        out = [br.read_signed(bps) for _ in range(blocksize)]
    elif 8 <= type_code <= 12:  # FIXED
        order = type_code - 8
        for i in range(order):
            out[i] = br.read_signed(bps)
        _decode_residual(br, order, blocksize, out)
        coefs = _FIXED_COEFS[order]
        for i in range(order, blocksize):
            out[i] += sum(c * out[i - 1 - j] for j, c in enumerate(coefs))
    elif type_code >= 32:  # LPC
        order = (type_code & 31) + 1
        for i in range(order):
            out[i] = br.read_signed(bps)
        precision = br.read(4) + 1
        if precision == 16:
            raise ValueError("Invalid LPC precision")
        shift = br.read_signed(5)
        shift = max(shift, 0)
        coefs = [br.read_signed(precision) for _ in range(order)]
        _decode_residual(br, order, blocksize, out)
        for i in range(order, blocksize):
            acc = sum(c * out[i - 1 - j] for j, c in enumerate(coefs))
            out[i] += acc >> shift
    else:
        raise ValueError(f"Reserved subframe type {type_code}")

    if wasted:
        out = [v << wasted for v in out]
    return out


def _skip_coded_number(br: _BitReader) -> None:
    first = br.read(8)
    extra = 0
    mask = 0x80
    while first & mask:
        extra += 1
        mask >>= 1
    if extra == 1 or extra > 7:
        raise ValueError("Bad coded number")
    for _ in range(max(extra - 1, 0)):
        if (br.read(8) & 0xC0) != 0x80:
            raise ValueError("Bad coded number continuation")


_BLOCKSIZE_TABLE = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608}
_SAMPLESIZE_TABLE = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}


def decode_flac(path: str) -> Tuple[np.ndarray, int]:
    """Decode a FLAC file -> (float32 (n, ch) in [-1, 1], sample_rate)."""
    with open(path, "rb") as fh:
        data = fh.read()
    br = _BitReader(data)
    if br.read(32) != 0x664C6143:  # "fLaC"
        raise ValueError(f"Not a FLAC file: {path}")

    sample_rate = channels = bits_per_sample = 0
    total_samples = 0
    last = False
    while not last:
        head = br.read(8)
        length = br.read(24)
        last = bool(head & 0x80)
        if (head & 0x7F) == 0:  # STREAMINFO
            br.read(16), br.read(16), br.read(24), br.read(24)
            sample_rate = br.read(20)
            channels = br.read(3) + 1
            bits_per_sample = br.read(5) + 1
            total_samples = (br.read(4) << 32) | br.read(32)
            br.skip_bytes(16)
            if length > 34:
                br.skip_bytes(length - 34)
        else:
            br.skip_bytes(length)

    if not sample_rate or not channels:
        raise ValueError(f"Missing STREAMINFO in {path}")

    pcm: List[List[int]] = []
    n_decoded = 0
    while not br.at_end():
        br.align()
        try:
            sync = br.read(14)
        except EOFError:
            break
        if sync != 0x3FFE:
            raise ValueError("Lost FLAC frame sync")
        br.read(1)  # reserved
        br.read(1)  # blocking strategy
        bs_code = br.read(4)
        sr_code = br.read(4)
        ch_code = br.read(4)
        ss_code = br.read(3)
        br.read(1)  # reserved
        _skip_coded_number(br)

        if bs_code in _BLOCKSIZE_TABLE:
            blocksize = _BLOCKSIZE_TABLE[bs_code]
        elif bs_code == 6:
            blocksize = br.read(8) + 1
        elif bs_code == 7:
            blocksize = br.read(16) + 1
        elif bs_code >= 8:
            blocksize = 256 << (bs_code - 8)
        else:
            raise ValueError("Reserved blocksize code")
        if sr_code == 12:
            br.read(8)
        elif sr_code in (13, 14):
            br.read(16)
        bps = _SAMPLESIZE_TABLE.get(ss_code, bits_per_sample)
        br.read(8)  # CRC-8

        frame_channels = ch_code + 1 if ch_code < 8 else 2
        if frame_channels != channels:
            raise ValueError("Channel count changed mid-stream")

        subframes = []
        for c in range(frame_channels):
            ch_bps = bps
            if (ch_code == 8 and c == 1) or (ch_code == 9 and c == 0) or (
                ch_code == 10 and c == 1
            ):
                ch_bps += 1
            subframes.append(_decode_subframe(br, blocksize, ch_bps))
        br.align()
        br.read(16)  # CRC-16

        if ch_code == 8:  # left/side
            subframes[1] = [l - s for l, s in zip(subframes[0], subframes[1])]
        elif ch_code == 9:  # right/side
            subframes[0] = [s + r for s, r in zip(subframes[0], subframes[1])]
        elif ch_code == 10:  # mid/side
            left, right = [], []
            for m, s in zip(subframes[0], subframes[1]):
                mid = (m << 1) | (s & 1)
                left.append((mid + s) >> 1)
                right.append((mid - s) >> 1)
            subframes = [left, right]

        pcm.append(subframes)
        n_decoded += blocksize
        if total_samples and n_decoded >= total_samples:
            break

    out = np.zeros((n_decoded, channels), dtype=np.int64)
    row = 0
    for subframes in pcm:
        n = len(subframes[0])
        for c in range(channels):
            out[row : row + n, c] = subframes[c]
        row += n
    if total_samples and row > total_samples:
        out = out[: int(total_samples)]
    scale = float(1 << (bits_per_sample - 1))
    return (out.astype(np.float32) / scale), sample_rate
