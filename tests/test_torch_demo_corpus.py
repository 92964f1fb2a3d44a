"""The port's corpus tool against ``tools/make_demo_corpus.py`` on the CPU:
for seeds 0 and 7 the renders, the sentence draws and the trees both
``main``s write (FLAC bytes and transcripts) are byte-identical
(tolerance: none), the parallel FLAC encode of ``synth.write_corpus``
included."""

import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import make_demo_corpus as jtool  # noqa: E402

from rnn_speech_tpu_torch import synth  # noqa: E402
from rnn_speech_tpu_torch.tools import make_demo_corpus as ttool  # noqa: E402

SEEDS = [0, 7]


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_sentences_and_letters_renders_byte_identical(seed):
    texts = ttool.sample_sentences(5, np.random.default_rng(seed))
    assert texts == jtool.sample_sentences(5, np.random.default_rng(seed))
    assert ttool.DEFAULT_TEXTS == jtool.DEFAULT_TEXTS and ttool.WORDS == jtool.WORDS
    for text in texts + ["A", " ", ""]:
        for sr in (16000, 22050):
            a = ttool.render_letters(text, sr, np.random.default_rng(seed))
            b = jtool.render_letters(text, sr, np.random.default_rng(seed))
            assert a.dtype == b.dtype == np.int16 and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed", SEEDS)
def test_noisy_syllables_renders_byte_identical(seed):
    texts = ttool.sample_sentences(3, np.random.default_rng(seed))
    for text in texts + ["A"]:
        for noise in (0.0, 900.0, 4800.0):
            a = ttool.render_syllables(text, 22050, np.random.default_rng(seed), noise)
            b = jtool.render_syllables(text, 22050, np.random.default_rng(seed), noise)
            assert a.dtype == b.dtype == np.int16 and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("mode,extra", [
    ("letters", []),
    ("syllables", ["--noise_std", "1200"]),
    ("tones", ["--seconds", "0.6"]),
])
def test_main_writes_the_same_tree(tmp_path, monkeypatch, capsys, seed, mode, extra):
    args = ["--mode", mode, "--clips", "4", "--seed", str(seed)] + extra
    assert ttool.main(["--out", str(tmp_path / "port")] + args) == 0
    monkeypatch.setattr(sys, "argv", ["make_demo_corpus.py", "--out",
                                      str(tmp_path / "jax")] + args)
    assert jtool.main() == 0
    port, ref = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert sorted(port) == sorted(ref) and len(port) == 5     # 4 clips + transcripts
    for name in ref:
        assert port[name] == ref[name], name
    assert "render" in capsys.readouterr().out


def test_tones_mode_refuses_clips_the_reader_drops(tmp_path):
    with pytest.raises(SystemExit):
        ttool.main(["--out", str(tmp_path), "--mode", "tones", "--seconds", "0.3"])


@pytest.mark.parametrize("seed", SEEDS)
def test_parallel_write_corpus_byte_identical(tmp_path, monkeypatch, seed):
    """From ``2 * ENCODE_CLIPS_PER_WORKER`` clips a process pool encodes:
    here forced at 6 clips (3 workers); the tree equals the JAX tool's
    sequential one."""
    rng = np.random.default_rng(seed)
    texts = synth.sample_sentences(6, rng)
    sigs = [ttool.render_syllables(t, 16000, rng)[:8000] for t in texts]
    monkeypatch.setattr(synth, "ENCODE_CLIPS_PER_WORKER", 2)
    synth.write_corpus(str(tmp_path / "port"), texts, sigs, 16000)
    jtool.write_corpus(str(tmp_path / "jax"), texts, sigs, 16000)
    port, ref = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert sorted(port) == sorted(ref) and len(port) == 7
    for name in ref:
        assert port[name] == ref[name], name
