"""Dependency-free TensorBoard event-file writer.

The port's own copy of ``rnn_speech_tpu/train/tbevents.py``: real
``.tfevents`` files (TFRecord-framed Event protos with CRC32C checksums),
so scalars and histograms from training are viewable in stock
TensorBoard without TensorFlow.  The tiny protobuf subset needed (Event,
Summary, HistogramProto) is encoded by hand.
"""

from __future__ import annotations

import os
import struct
import time
from typing import Optional, Sequence

import numpy as np

# ------------------------------------------------------------------ crc32c

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE:
        return _CRC_TABLE
    poly = 0x82F63B78
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    _CRC_TABLE = table
    return table


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for byte in data:
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# --------------------------------------------------------------- protobuf

def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _f_double(field: int, value: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", value)


def _f_float(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", value)


def _f_varint(field: int, value: int) -> bytes:
    if value < 0:
        value += 1 << 64
    return _key(field, 0) + _varint(value)


def _f_bytes(field: int, value: bytes) -> bytes:
    return _key(field, 2) + _varint(len(value)) + value


def _f_packed_doubles(field: int, values: Sequence[float]) -> bytes:
    payload = b"".join(struct.pack("<d", v) for v in values)
    return _f_bytes(field, payload)


def _summary_value_scalar(tag: str, value: float) -> bytes:
    body = _f_bytes(1, tag.encode()) + _f_float(2, value)
    return _f_bytes(1, body)  # Summary.value (repeated, field 1)


def _histogram_proto(values: np.ndarray, bins: int) -> bytes:
    values = np.asarray(values, np.float64).ravel()
    if values.size == 0:
        values = np.zeros((1,))
    counts, edges = np.histogram(values, bins=bins)
    body = (
        _f_double(1, float(values.min()))
        + _f_double(2, float(values.max()))
        + _f_double(3, float(values.size))
        + _f_double(4, float(values.sum()))
        + _f_double(5, float(np.square(values).sum()))
        + _f_packed_doubles(6, edges[1:])
        + _f_packed_doubles(7, counts.astype(np.float64))
    )
    return body


def _summary_value_histo(tag: str, values: np.ndarray, bins: int) -> bytes:
    body = _f_bytes(1, tag.encode()) + _f_bytes(5, _histogram_proto(values, bins))
    return _f_bytes(1, body)


def _event(step: int, summary_values: bytes = b"",
           file_version: Optional[str] = None,
           wall_time: Optional[float] = None) -> bytes:
    body = _f_double(1, time.time() if wall_time is None else wall_time)
    body += _f_varint(2, int(step))
    if file_version is not None:
        body += _f_bytes(3, file_version.encode())
    if summary_values:
        body += _f_bytes(5, summary_values)  # Event.summary
    return body


# ----------------------------------------------------------------- writer

class TBEventWriter:
    """Minimal tf.summary.FileWriter: scalars + histograms."""

    def __init__(self, log_dir: str, filename_suffix: str = ""):
        os.makedirs(log_dir, exist_ok=True)
        name = "events.out.tfevents.{:.0f}.{}{}".format(
            time.time(), os.uname().nodename, filename_suffix
        )
        self._path = os.path.join(log_dir, name)
        self._fh = open(self._path, "wb")
        self._write_record(_event(0, file_version="brain.Event:2"))

    @property
    def path(self) -> str:
        return self._path

    def _write_record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._fh.write(header)
        self._fh.write(struct.pack("<I", _masked_crc(header)))
        self._fh.write(payload)
        self._fh.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write_record(_event(step, _summary_value_scalar(tag, value)))

    def add_histogram(self, tag: str, values, step: int, bins: int = 30) -> None:
        self._write_record(
            _event(step, _summary_value_histo(tag, np.asarray(values), bins))
        )

    def flush(self) -> None:
        self._fh.flush()

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.flush()
            self._fh.close()
