"""Metrics: scalar + histogram writer and the WER/CER utilities.

The port's own copy of ``rnn_speech_tpu/train/metrics.py``.  Metrics land
in two sinks per run directory: ``.tfevents`` protobuf records for stock
TensorBoard (``train/tbevents.py``, no TensorFlow dependency) and an
append-only grep-able ``events.jsonl``.  Histogram entries store summary
statistics + fixed-width bucket counts.  ``calculate_wer`` and
``calculate_cer`` are word- and char-level Levenshtein distances.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np


class MetricsWriter:
    """Append-only scalar/histogram event writer, one JSON object per line."""

    def __init__(self, base_dir: str, run_name: Optional[str] = None):
        from rnn_speech_tpu_torch.train.tbevents import TBEventWriter

        if run_name is None:
            run_name = time.strftime("%Y-%m-%d--%H-%M-%S")
        self.dir = os.path.join(base_dir, run_name)
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, "events.jsonl")
        self._fh = open(self.path, "a")
        self._tb = TBEventWriter(self.dir)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write({"kind": "scalar", "tag": tag, "value": float(value),
                     "step": int(step)})
        self._tb.add_scalar(tag, float(value), int(step))

    def add_histogram(self, tag: str, values, step: int, bins: int = 30) -> None:
        arr = np.asarray(values).ravel().astype(np.float64)
        counts, edges = np.histogram(arr, bins=bins)
        self._write({
            "kind": "histogram", "tag": tag, "step": int(step),
            "min": float(arr.min()) if arr.size else 0.0,
            "max": float(arr.max()) if arr.size else 0.0,
            "mean": float(arr.mean()) if arr.size else 0.0,
            "std": float(arr.std()) if arr.size else 0.0,
            "counts": counts.tolist(),
            "edges": [float(e) for e in edges],
        })
        self._tb.add_histogram(tag, arr, int(step), bins=bins)

    def _write(self, obj: dict) -> None:
        obj["wall_time"] = time.time()
        self._fh.write(json.dumps(obj) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()
        self._tb.close()


# ------------------------------------------------------------------ WER/CER

def calculate_wer(first_string: str, second_string: str) -> int:
    """Word-level Levenshtein distance (reference formula, vectorized rows)."""
    return _levenshtein(first_string.split(), second_string.split())


def calculate_cer(first_string: str, second_string: str) -> int:
    """Char-level Levenshtein distance, spaces stripped first."""
    return _levenshtein(
        list(first_string.replace(" ", "")), list(second_string.replace(" ", ""))
    )


def _levenshtein(r, h) -> int:
    prev = np.arange(len(h) + 1, dtype=np.int64)
    for i in range(1, len(r) + 1):
        cur = np.empty_like(prev)
        cur[0] = i
        sub = prev[:-1] + (np.asarray([x != r[i - 1] for x in h])
                           if h else np.zeros(0, dtype=np.int64))
        for j in range(1, len(h) + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, sub[j - 1])
        prev = cur
    return int(prev[len(h)])
