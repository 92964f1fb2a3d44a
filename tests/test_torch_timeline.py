"""``--timeline`` of the port's training loop on the CPU: one window of
the session's steps 2 and 3 traced by ``torch.profiler`` into
``tensorboard_dir`` as a Chrome trace (``rank0.*.pt.trace.json``), with a
``train`` span and a profiler step for each traced step and the host spans
``host/put_batch`` and ``host/metrics_drain`` inside the window, as the
JAX loop traces steps 2-3 with ``jax.profiler``; without
``tensorboard_dir`` the loop warns and trains untraced, as the JAX loop
does."""

import glob
import json
import logging
import os

import numpy as np
import pytest

from rnn_speech_tpu_torch import cli, synth
from rnn_speech_tpu_torch import corpus as tcorpus
from rnn_speech_tpu_torch.charmap import get_char_map
from rnn_speech_tpu_torch.config import load_config
from rnn_speech_tpu_torch.train import loop

CONFIG = """
[acoustic_network_params]
num_layers : 2
hidden_size : 16
dropout_input_keep_prob : 0.9
dropout_output_keep_prob : 0.8
batch_size : 2
mini_batch_size : 1
learning_rate : 0.003
lr_decay_factor : 0.33
grad_clip : 5
signal_processing : fbank
language : english
rnn_state_reset_ratio : 0.5
[general]
use_config_file_if_checkpoint_exists : True
steps_per_checkpoint : 3
steps_per_evaluation : 3
checkpoint_dir : {root}/ckpt
[training]
training_dataset_dirs : {root}/corpus/demo
test_dataset_dirs : {root}/corpus/demo
max_input_seq_length : 100
max_target_seq_length : 40
{tb}
[logging]
log_level : WARNING
[tpu]
compute_dtype : float32
prefetch_depth : 0
"""
SPANS = ("train", "host/put_batch", "host/metrics_drain")


@pytest.fixture(scope="module")
def corpus_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("timeline")
    rng = np.random.default_rng(6)
    texts = synth.sample_sentences(4, rng)
    sigs = [np.clip(synth.render_syllables_clean(t, 16000, rng)[:9000]
                    + rng.normal(0, 300, 9000), -32000, 32000).astype(np.int16)
            for t in texts]
    synth.write_corpus(str(root / "corpus"), texts, sigs, 16000)
    return root


def _config(root, tag, with_tb):
    work = root / tag
    os.makedirs(work / "tb")           # the config reads only an existing directory
    tb = f"tensorboard_dir : {work}/tb" if with_tb else ""
    path = work / "c.ini"
    path.write_text(CONFIG.format(root=work, tb=tb).replace(
        f"{work}/corpus", f"{root}/corpus"))
    return work, str(path)


def _train(ini, steps):
    config = load_config(ini)
    data = sorted(tcorpus.DataProcessor(config.training_dataset_dirs).get_dataset())
    seen = []
    state = loop.train_acoustic(config, data, data, get_char_map("english"),
                                max_steps=steps, timeline=True, device="cpu",
                                step_hook=lambda n, m: seen.append(n))
    return state, seen


def test_timeline_traces_steps_two_and_three(corpus_root):
    work, ini = _config(corpus_root, "traced", True)
    state, seen = _train(ini, 5)
    assert seen == [1, 2, 3, 4, 5] and int(state["step"]) == 5
    traces = glob.glob(str(work / "tb" / "rank0.*.pt.trace.json"))
    assert len(traces) == 1
    events = json.load(open(traces[0]))["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("ph") == "X"]
    assert names.count("train") == 2
    assert sorted(n for n in names if n.startswith("ProfilerStep#")) == \
        ["ProfilerStep#1", "ProfilerStep#2"]        # after one warm-up step
    for span in SPANS[1:]:
        assert names.count(span) >= 2, span
    # The window holds two steps' work: their CTC losses, their optimiser.
    train = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("name") == "train")
    puts = [e["ts"] for e in events if e.get("name") == "host/put_batch"]
    assert all(any(a <= t <= b for a, b in train) for t in puts)


def test_timeline_without_tensorboard_dir_warns_and_trains(corpus_root, caplog):
    work, ini = _config(corpus_root, "untraced", False)
    with caplog.at_level(logging.WARNING, logger="rnn_speech_tpu_torch.train.loop"):
        state, seen = _train(ini, 4)
    assert "--timeline needs tensorboard_dir; tracing disabled" in caplog.text
    assert seen == [1, 2, 3, 4] and int(state["step"]) == 4
    assert not glob.glob(str(work / "**" / "*.pt.trace.json"), recursive=True)


def test_cli_timeline_flag_reaches_the_loop(corpus_root, monkeypatch):
    """The CLI passes ``--timeline`` to the loop; ``--evaluate --timeline``
    evaluates as without it (the JAX CLI ignores it there)."""
    work, ini = _config(corpus_root, "cli", True)
    seen = {}
    real = loop.train_acoustic

    def spy(*args, **kw):
        seen.update(kw)
        return real(*args, **kw)

    monkeypatch.setattr(loop, "train_acoustic", spy)
    assert cli.main(["--train_acoustic", "--timeline", "--config", ini, "--device", "cpu",
                     "--max_steps", "4"]) == 0
    assert seen["timeline"] is True and seen["mesh"] is None
    assert len(glob.glob(str(work / "tb" / "rank0.*.pt.trace.json"))) == 1
    assert cli.main(["--evaluate", "--timeline", "--config", ini, "--device", "cpu",
                     "--beam_width", "1"]) == 0
