"""The port's streaming featurizer (``streaming.py``) and ``--record``
engine (``cli.StreamingTranscriber``) on the CPU, against the JAX
package's.

``StreamingFbank`` is numpy/scipy in both packages: fed the same signal in
chunks of 22050, 4096 and 1000 samples, its rows equal JAX's bit for bit.
The transcriber runs a tiny checkpoint (a 1x48 acoustic model from the
JAX package's initial weights, its output projection scaled so the logits
are peaked, and a 1x16 char LM) on a rendered clip: its text is the same
whether the clip arrives whole or in 0.25 s or 0.11 s pieces, greedy and
beam-4 with the LM at weight 0.5, and equals the JAX transcriber's text on
the same checkpoint.  ``--record`` without ``pyaudio`` logs and returns 1.
"""

import jax
import numpy as np
import pytest

from rnn_speech_tpu import cli as jcli
from rnn_speech_tpu import config as jconfig
from rnn_speech_tpu import streaming as jstreaming
from rnn_speech_tpu.models import acoustic as jac
from rnn_speech_tpu.models import language as jlang
from rnn_speech_tpu.train import checkpoint as jckpt
from rnn_speech_tpu_torch import cli, config as tconfig, streaming, synth
from rnn_speech_tpu_torch.charmap import get_char_map

SR = 22050
LM_WEIGHT = 0.5

INI = """[acoustic_network_params]
num_layers : 1
hidden_size : 48
dropout_input_keep_prob : 1.0
dropout_output_keep_prob : 1.0
batch_size : 1
mini_batch_size : 1
learning_rate : 0.003
lr_decay_factor : 0.33
grad_clip : 5
signal_processing : fbank
language : english
rnn_state_reset_ratio : 1.0

[lm_network_params]
num_layers : 1
hidden_size : 16

[general]
use_config_file_if_checkpoint_exists : True
steps_per_checkpoint : 2
steps_per_evaluation : 1000
checkpoint_dir : {ckpt}

[training]
training_dataset_dirs :
max_input_seq_length : 300
max_target_seq_length : 40
batch_normalization : False
dataset_size_ordering : False

[logging]
log_level : WARNING

[tpu]
compute_dtype : float32
use_pallas_lstm : False
prefetch_depth : 0
"""


def _signal(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * seconds)) / SR
    return (0.4 * np.sin(2 * np.pi * 340 * t) + 0.2 * np.sin(2 * np.pi * 870 * t + 1.0)
            + 0.02 * rng.normal(size=t.size)).astype(np.float32)


def _chunked(sf, sig, chunk):
    parts = [sf.feed(sig[i:i + chunk]) for i in range(0, len(sig), chunk)]
    parts.append(sf.flush())
    return np.concatenate([p for p in parts if p.size], axis=0)


@pytest.mark.parametrize("chunk", [22050, 4096, 1000])
def test_streaming_fbank_equals_jax_bit_for_bit(chunk):
    sig = _signal(2.3, 0)
    got = _chunked(streaming.StreamingFbank(SR), sig, chunk)
    want = _chunked(jstreaming.StreamingFbank(SR), sig, chunk)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_streaming_fbank_resets_after_flush():
    sf = streaming.StreamingFbank(SR)
    sig = _signal(0.8, 5)
    sf.feed(sig)
    first = sf.flush()
    sf.feed(sig)
    assert first.tobytes() == sf.flush().tobytes()


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("stream")
    ckpt = tmp / "ckpt"
    cfg = jac.AcousticConfig(num_layers=1, hidden_size=48, input_dim=120, num_labels=80)
    params = jac.init_params(jax.random.PRNGKey(7), cfg)
    params["output"]["w"] = params["output"]["w"] * 8.0
    jckpt.save(str(ckpt / "acoustic"), jax.tree.map(np.asarray, params), 1, 3e-3)
    lcfg = jlang.LanguageConfig(num_layers=1, hidden_size=16, num_labels=80)
    jckpt.save(str(ckpt / "language"),
               jax.tree.map(np.asarray, jlang.init_params(jax.random.PRNGKey(2), lcfg)), 1, 1e-3)
    ini = tmp / "stream.ini"
    ini.write_text(INI.format(ckpt=ckpt))
    text = synth.sample_sentences(1, np.random.default_rng(4))[0]
    sig = (synth.render_syllables_clean(text, SR, np.random.default_rng(5))
           / 32768.0).astype(np.float32)
    return str(ini), sig


def _port_text(ini, sig, width, piece):
    config = tconfig.HyperParamStore(tconfig.load_config(ini)).config
    cm = get_char_map("english")
    lm = cli.load_lm_stepper(config, cm, LM_WEIGHT if width > 1 else 0.0, "cpu")
    tr = cli.StreamingTranscriber(config, cm, chunk_seconds=0.5, beam_width=width, lm=lm,
                                  lm_weight=LM_WEIGHT if width > 1 else 0.0, device="cpu")
    if piece is None:
        return tr.feed(sig) + tr.finish()
    chunk = int(SR * piece)
    return "".join([tr.feed(sig[i:i + chunk]) for i in range(0, len(sig), chunk)]
                   + [tr.finish()])


@pytest.mark.parametrize("width", [1, 4])
def test_transcriber_is_chunk_size_invariant_and_equals_jax(tiny, width):
    ini, sig = tiny
    texts = {piece: _port_text(ini, sig, width, piece) for piece in (None, 0.25, 0.11)}
    assert texts[None].strip() != ""
    assert texts[0.25] == texts[None] and texts[0.11] == texts[None], texts

    config = jconfig.HyperParamStore(jconfig.load_config(ini)).config
    cm = get_char_map("english")
    w = LM_WEIGHT if width > 1 else 0.0
    tr = jcli.StreamingTranscriber(config, cm, chunk_seconds=0.5, beam_width=width,
                                   lm=jcli._load_lm_stepper(config, cm, w), lm_weight=w)
    chunk = int(SR * 0.25)
    want = "".join([tr.feed(sig[i:i + chunk]) for i in range(0, len(sig), chunk)]
                   + [tr.finish()])
    assert texts[None] == want


def test_transcriber_with_the_lm_runs_the_fused_beam(tiny, monkeypatch):
    """The beam transcriber advances the LM (its stepper runs every
    frame); greedy never calls it."""
    ini, sig = tiny
    from rnn_speech_tpu_torch.models import language

    calls = []
    stepper = language.stepper

    def counting(params, cfg):
        init, advance = stepper(params, cfg)
        return init, lambda s, c: (calls.append(1), advance(s, c))[1]

    monkeypatch.setattr(language, "stepper", counting)
    _port_text(ini, sig[: SR // 2], 4, 0.25)
    assert len(calls) > 0


def test_record_without_pyaudio_returns_1(tiny, monkeypatch, caplog):
    import builtins

    ini, _ = tiny
    real_import = builtins.__import__

    def no_pyaudio(name, *args, **kw):
        if name == "pyaudio":
            raise ImportError("No module named 'pyaudio'")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pyaudio)
    assert cli.main(["--record", "--config", ini, "--device", "cpu"]) == 1
    assert "pyaudio" in caplog.text
