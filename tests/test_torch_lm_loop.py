"""The port's LM training loop (``train/lm_loop.py``) on the CPU, against
the JAX package's (the counterpart of ``tests/test_lm_loop.py``).

``split_texts`` and ``TextBatcher``'s batches equal JAX's (same
``random.Random`` seeds).  From one checkpoint of the JAX package's
initial weights, at keep probability 1, the first 5 step losses of the
two loops agree to 1e-4 relative (the same float32 step in another
summation order, compounding over 5 Adam steps).  The loop checkpoints on
its cadence, resumes at the saved step, decays the learning rate on the
plateau policy's verdict (fed the held-out NLL at the eval cadence, the
train-window loss without one) and writes the ``lm/*`` scalars.
"""

import json
import os

import jax
import numpy as np
import pytest

from rnn_speech_tpu.charmap import CharMap as JCharMap
from rnn_speech_tpu.config import Config as JConfig, LmConfig as JLmConfig
from rnn_speech_tpu.models import language as jlang
from rnn_speech_tpu.train import checkpoint as jckpt
from rnn_speech_tpu.train import lm_loop as jloop
from rnn_speech_tpu_torch.charmap import CharMap
from rnn_speech_tpu_torch.config import Config, LmConfig
from rnn_speech_tpu_torch.train import checkpoint as ckpt
from rnn_speech_tpu_torch.train import lm_loop

TEXTS = [
    "the quick brown fox jumps over the lazy dog",
    "a stitch in time saves nine",
    "all that glitters is not gold",
    "actions speak louder than words",
    "practice makes perfect every day",
    "the early bird catches the worm",
    "better late than never they say",
    "every cloud has a silver lining",
    "birds of a feather flock together",
    "the pen is mightier than the sword",
]
LOSS_TOL = 1e-4


def _kw(tmp_path, **kw):
    d = dict(num_layers=1, hidden_size=16, batch_size=4, learning_rate=0.01,
             lr_decay_factor=0.33, grad_clip=5.0, steps_per_checkpoint=3,
             steps_per_evaluation=3, checkpoint_dir=str(tmp_path / "ckpt"),
             max_target_seq_length=64)
    d.update(kw)
    return d


def make_config(tmp_path, lm=None, **kw):
    return Config(lm=lm or LmConfig(batch_size=2), **_kw(tmp_path, **kw))


def _scalars(tb):
    lines = []
    for dirpath, _, names in os.walk(str(tb)):
        for name in names:
            if name.endswith(".jsonl"):
                lines.extend(json.loads(l) for l in open(os.path.join(dirpath, name)))
    return lines


def test_split_and_batches_equal_jax():
    for texts in (TEXTS, ["a b c", "d e f"], ["only one"]):
        assert lm_loop.split_texts(texts) == jloop.split_texts(texts)
    for seed, shuffle, B in ((7, True, 3), (0, False, 2), (1, True, 4)):
        ours = lm_loop.TextBatcher(TEXTS, CharMap(), 64, B, seed=seed, shuffle=shuffle)
        theirs = jloop.TextBatcher(TEXTS, JCharMap(), 64, B, seed=seed, shuffle=shuffle)
        for _ in range(2):                                    # two epochs
            a, b = list(ours.epoch()), list(theirs.epoch())
            assert len(a) == len(b)
            for (ca, la), (cb, lb) in zip(a, b):
                np.testing.assert_array_equal(ca, cb)
                np.testing.assert_array_equal(la, lb)


def test_first_losses_match_jax(tmp_path):
    """Both loops start from one checkpoint (the JAX package's initial
    weights, step 0) at keep 1 and take 5 steps on the same batches."""
    lm = dict(batch_size=2, dropout_keep_prob=1.0)
    losses = {}
    for name, cfg_cls, lm_cls, mod in (("jax", JConfig, JLmConfig, jloop),
                                      ("torch", Config, LmConfig, lm_loop)):
        config = cfg_cls(lm=lm_cls(**lm), **_kw(tmp_path / name, steps_per_checkpoint=5))
        jcfg = jlang.LanguageConfig(1, 16, len(JCharMap()))
        init = jlang.init_params(jax.random.PRNGKey(0), jcfg)
        jckpt.save(config.checkpoint_dir + "/language/", init, 0, 0.01)
        got = []
        kw = {"device": "cpu"} if name == "torch" else {}
        mod.train_language(config, TEXTS, CharMap() if name == "torch" else JCharMap(),
                           max_steps=5, step_hook=lambda s, m: got.append(m["mean_loss"]), **kw)
        losses[name] = got
    assert len(losses["torch"]) == 5
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=LOSS_TOL, atol=0)


def test_trains_checkpoints_and_resumes(tmp_path):
    config = make_config(tmp_path)
    hooked = []
    _, step = lm_loop.train_language(config, TEXTS, CharMap(), max_steps=6, device="cpu",
                                     step_hook=lambda s, m: hooked.append((s, m["mean_loss"])))
    assert step == 6
    assert [s for s, _ in hooked] == list(range(1, 7))
    assert all(np.isfinite(l) for _, l in hooked)
    lm_dir = str(tmp_path / "ckpt") + "/language/"
    assert os.path.basename(ckpt.latest_path(lm_dir)) == "acousticmodel-6.npz"
    _, step2 = lm_loop.train_language(config, TEXTS, CharMap(), max_steps=2, device="cpu")
    assert step2 == 8


def test_loss_decreases(tmp_path):
    hooked = []
    lm_loop.train_language(make_config(tmp_path), TEXTS * 3, CharMap(), max_steps=30,
                           device="cpu", step_hook=lambda s, m: hooked.append(m["mean_loss"]))
    assert np.mean(hooked[-5:]) < np.mean(hooked[:5])


def test_writes_eval_metrics(tmp_path):
    tb = tmp_path / "tb"
    tb.mkdir()
    lm_loop.train_language(make_config(tmp_path, tensorboard_dir=str(tb)), TEXTS, CharMap(),
                           max_steps=6, device="cpu")
    lines = _scalars(tb)
    tags = {line["tag"] for line in lines}
    assert {"lm/train_mean_loss", "lm/test_perplexity", "lm/test_mean_loss",
            "lm/learning_rate"} <= tags
    assert all(l["value"] >= 1.0 for l in lines if l["tag"] == "lm/test_perplexity")
    assert any("tfevents" in n for _, _, names in os.walk(str(tb)) for n in names)


def test_plateau_decays_lr(tmp_path, monkeypatch):
    class DecayOnSecond:
        def __init__(self, factor):
            self.decay_factor = factor
            self.calls = 0

        def update(self, _):
            self.calls += 1
            return self.calls == 2

    monkeypatch.setattr(lm_loop, "PlateauPolicy", DecayOnSecond)
    config = make_config(tmp_path, steps_per_checkpoint=2, steps_per_evaluation=2)
    lm_loop.train_language(config, TEXTS, CharMap(), max_steps=6, device="cpu")
    _, _, lr = ckpt.restore_flat(str(tmp_path / "ckpt") + "/language/")
    np.testing.assert_allclose(lr, 0.01 * 0.33, rtol=1e-5)


def test_decay_signal_is_heldout_nll(tmp_path, monkeypatch):
    fed = []

    class Recorder:
        def __init__(self, factor):
            self.decay_factor = factor

        def update(self, value):
            fed.append(float(value))
            return False

    monkeypatch.setattr(lm_loop, "PlateauPolicy", Recorder)
    tb = tmp_path / "tb"
    tb.mkdir()
    config = make_config(tmp_path, steps_per_checkpoint=2, steps_per_evaluation=4,
                         tensorboard_dir=str(tb))
    lm_loop.train_language(config, TEXTS, CharMap(), max_steps=8, device="cpu")
    lines = _scalars(tb)
    evals = [l["value"] for l in lines if l["tag"] == "lm/test_mean_loss"]
    trains = [l["value"] for l in lines if l["tag"] == "lm/train_mean_loss"]
    assert len(trains) == 4 and len(evals) == 2
    np.testing.assert_allclose(fed, evals, rtol=1e-6)


def test_decay_uses_train_loss_without_eval(tmp_path, monkeypatch):
    fed = []

    class Recorder:
        def __init__(self, factor):
            self.decay_factor = factor

        def update(self, value):
            fed.append(float(value))
            return False

    monkeypatch.setattr(lm_loop, "PlateauPolicy", Recorder)
    config = make_config(tmp_path, steps_per_checkpoint=2, steps_per_evaluation=0)
    hooked = []
    lm_loop.train_language(config, TEXTS, CharMap(), max_steps=6, device="cpu",
                           step_hook=lambda s, m: hooked.append(m["mean_loss"]))
    assert len(fed) == 3
    np.testing.assert_allclose(fed, [np.mean(hooked[i:i + 2]) for i in range(0, 6, 2)],
                               rtol=1e-6)
