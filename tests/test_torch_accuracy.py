"""Held-out generalization of the port's training on the CPU: the toy of
``tests/test_accuracy.py`` on ``rnn_speech_tpu_torch/tools/
accuracy_benchmark.py`` (60 letters-corpus clips, 1x96, B=8, up to 6
rounds of 120 steps, lr 4e-3): the held-out WER must fall and reach the
same 35% target on sentences the model never saw.  The letters corpus and
its split are byte-identical to the JAX tool's (tolerance: none)."""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import accuracy_benchmark as jab  # noqa: E402

from rnn_speech_tpu_torch.tools import accuracy_benchmark as ab  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The toy sessions run many small ops: on a host shared with other
    test workers, a thread a core (torch's default) spins more than it
    works (an 8-core host ran this file ~10x slower beside three busy
    workers).  Two threads a worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            with open(os.path.join(dirpath, name), "rb") as fh:
                out[os.path.relpath(os.path.join(dirpath, name), root)] = fh.read()
    return out


def test_letters_corpus_and_split_equal_the_jax_tools(tmp_path):
    train, test = ab.build_corpus(str(tmp_path / "port"), 20, 3)
    j_train, j_test = jab.build_corpus(str(tmp_path / "jax"), 20, 3)
    strip = lambda items: [(os.path.basename(p), label, dur) for p, label, dur in items]
    assert strip(train) == strip(j_train) and strip(test) == strip(j_test)
    assert len(test) == 2 and not {t for _, t, _ in test} & {t for _, t, _ in train}
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


def test_kernel_plans_name_the_route_and_its_kernels():
    from rnn_speech_tpu_torch.config import Config

    wide = ab.kernel_plans(Config(num_layers=2, hidden_size=256), 16)
    assert wide == {"route": "wavefront", "train_forward": "persistent",
                    "train_backward": "persistent", "decode_b1": "persistent"}
    toy = ab.kernel_plans(Config(num_layers=1, hidden_size=96), 8)
    assert toy["route"] == "layered" and toy["train_backward"] == "per_step"   # H % 128


def test_heldout_wer_improves_and_beats_threshold(tmp_path):
    result = ab.run(
        str(tmp_path), out_path=str(tmp_path / "curve.json"), clips=60, layers=1,
        hidden=96, batch=8, rounds=6, steps=120, wer_target=35.0, seed=0, lr=4e-3,
        device="cpu",
    )
    curve = result["curve"]
    assert len(curve) >= 2
    # Held-out WER must actually improve over training...
    assert curve[-1]["wer"] < curve[0]["wer"]
    # ...and reach the (generous, scaled-down) target on sentences the
    # model never saw.
    assert result["reached_target"], curve
    assert np.isfinite([p["cer"] for p in curve]).all()
    assert os.path.exists(tmp_path / "curve.json")
    assert set(result["stage_seconds"]) == {"corpus", "train", "eval"}
