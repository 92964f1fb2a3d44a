"""The port's WER/CER, TensorBoard event writer and metrics writer against
the JAX package's: equal distances on generated strings, byte-equal event
files with the clock patched in both, equal ``events.jsonl`` lines apart
from their wall time."""

import json
import os
import time

import numpy as np
from hypothesis import given, settings
from hypothesis import strategies as st

from rnn_speech_tpu.train import metrics as jmetrics
from rnn_speech_tpu.train import tbevents as jtb
from rnn_speech_tpu_torch.train import metrics as tmetrics
from rnn_speech_tpu_torch.train import tbevents as ttb

TEXT = st.text(alphabet="abc d'", max_size=24)


@settings(max_examples=200, deadline=None)
@given(TEXT, TEXT)
def test_wer_cer_equal_to_jax(a, b):
    assert tmetrics.calculate_wer(a, b) == jmetrics.calculate_wer(a, b)
    assert tmetrics.calculate_cer(a, b) == jmetrics.calculate_cer(a, b)
    assert tmetrics._levenshtein(list(a), list(b)) == jmetrics._levenshtein(list(a), list(b))


def test_crc32c_equal_to_jax():
    rng = np.random.default_rng(0)
    for n in (0, 1, 9, 1000):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert ttb.crc32c(data) == jtb.crc32c(data)
    assert ttb.crc32c(b"123456789") == 0xE3069283      # the CRC-32C check value


def _write_events(writer_cls, log_dir):
    w = writer_cls(str(log_dir))
    w.add_scalar("learning_rate", 3e-4, 0)
    w.add_scalar("train/mean_error_rate", 0.731, 7)
    w.add_histogram("rnn/layer0_cell", np.linspace(-2, 3, 101), 7)
    w.add_histogram("rnn/layer1_hidden", np.zeros((0,)), 7, bins=5)
    w.add_scalar("test/mean_loss", -1.5, 2 ** 40)
    w.close()
    return w.path


def test_event_files_byte_equal_with_the_clock_patched(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    got = _write_events(ttb.TBEventWriter, tmp_path / "port")
    ref = _write_events(jtb.TBEventWriter, tmp_path / "jax")
    assert os.path.basename(got) == os.path.basename(ref)
    assert open(got, "rb").read() == open(ref, "rb").read()


def _metrics_lines(module, base):
    w = module.MetricsWriter(str(base), "run")
    w.add_scalar("loss", 1.5, 10)
    w.add_histogram("weights", np.arange(100.0).reshape(10, 10), 10)
    w.add_scalar("loss", float("inf"), 11)
    w.close()
    lines = [json.loads(line) for line in open(w.path)]
    tb_files = [f for f in os.listdir(w.dir) if f.startswith("events.out.tfevents")]
    return lines, tb_files


def test_metrics_writer_lines_equal_apart_from_wall_time(tmp_path):
    got, got_tb = _metrics_lines(tmetrics, tmp_path / "port")
    ref, ref_tb = _metrics_lines(jmetrics, tmp_path / "jax")
    assert len(got) == len(ref) == 3 and len(got_tb) == len(ref_tb) == 1
    for g, r in zip(got, ref):
        assert isinstance(g.pop("wall_time"), float)
        r.pop("wall_time")
        assert g == r
