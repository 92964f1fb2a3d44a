"""The port's beam-quality tool (``rnn_speech_tpu_torch/tools/
beam_quality_run.py``) on the CPU against ``tools/beam_quality_run.py``:
``fresh_held_out`` is bit-identical to the JAX tool's (texts and clean
renders; tolerance: none) and disjoint from the bundle's training texts,
and ``main`` on a tiny bundle (2x64 with a 1x32 LM, float32, 4 clips, 2
levels, beam 2) writes the JAX tool's keys with the same values, every key but
``decode_seconds`` and the port's own ``device`` and ``stage_seconds``
equal (tolerance: none)."""

import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import beam_quality_run as jbq  # noqa: E402

from rnn_speech_tpu import config as jconfig  # noqa: E402
from rnn_speech_tpu_torch import synth  # noqa: E402
from rnn_speech_tpu_torch.charmap import get_char_map  # noqa: E402
from rnn_speech_tpu_torch.models import acoustic, language  # noqa: E402
from rnn_speech_tpu_torch.tools import beam_quality_run as bq  # noqa: E402
from rnn_speech_tpu_torch.train import checkpoint as tckpt  # noqa: E402


@pytest.mark.parametrize("seed", [0, 3])
def test_fresh_held_out_bit_identical_and_disjoint(seed):
    args = ("unused", 12, seed, 40, 6, 22050)
    port, ref = bq.fresh_held_out(*args), jbq.fresh_held_out(*args)
    assert [t for t, _ in port] == [t for t, _ in ref]
    for (_, a), (_, b) in zip(port, ref):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    texts = synth.sample_sentences(46, np.random.default_rng(seed))
    assert len({t for t, _ in port}) == 12
    assert not {t for t, _ in port} & set(texts)


def _tiny_bundle(root):
    char_map = get_char_map("english")
    gen = torch.Generator().manual_seed(5)
    cfg = acoustic.AcousticConfig(num_layers=2, hidden_size=64, input_dim=120,
                                  num_labels=len(char_map))
    tckpt.save(os.path.join(root, "acoustic"), acoustic.init_params(gen, cfg, "cpu"), 30, 1e-3)
    lcfg = language.LanguageConfig(num_layers=1, hidden_size=32, num_labels=len(char_map))
    tckpt.save(os.path.join(root, "language"), language.init_params(gen, lcfg, "cpu"), 8, 1e-3)
    config = jconfig.Config(num_layers=2, hidden_size=64, max_input_seq_length=300,
                            max_target_seq_length=80, checkpoint_dir=str(root),
                            lm=jconfig.LmConfig(num_layers=1, hidden_size=32),
                            tpu=jconfig.TpuConfig(compute_dtype="float32"))
    with open(os.path.join(root, "hyperparams.json"), "w") as fh:
        json.dump(config.to_dict(), fh)


def test_main_writes_the_jax_tools_keys_and_values(tmp_path, monkeypatch):
    bundle = tmp_path / "bundle"
    _tiny_bundle(bundle)
    args = ["--bundle", str(bundle), "--clips", "4", "--levels", "300,2400",
            "--decode_batch", "4", "--beam_width", "2", "--lm_weight", "0.5",
            "--train_clips", "20", "--train_test_clips", "4"]
    assert bq.main(args + ["--out", str(tmp_path / "port.json"), "--device", "cpu"]) == 0
    monkeypatch.setattr(sys, "argv", ["beam_quality_run.py", "--out",
                                      str(tmp_path / "jax.json")] + args)
    assert jbq.main() == 0
    port = json.loads((tmp_path / "port.json").read_text())
    ref = json.loads((tmp_path / "jax.json").read_text())
    assert set(port) == set(ref) | {"device", "stage_seconds"}
    assert port["device"] == "cpu" and set(port["stage_seconds"]) == {"render", "decode"}
    for table in port["noise_sweep"].values():
        assert set(table) == {"greedy", "beam2", "beam2_lm"}
        for entry in table.values():
            assert entry["clips"] == 4

    def strip(result):
        out = {k: v for k, v in result.items() if k not in ("device", "stage_seconds")}
        out["noise_sweep"] = {
            level: {mode: {k: v for k, v in e.items() if k != "decode_seconds"}
                    for mode, e in table.items()}
            for level, table in result["noise_sweep"].items()}
        return out

    assert strip(port) == strip(ref)


def test_main_runs_on_cuda_unless_asked(tmp_path, monkeypatch):
    """Without a GPU and without ``--device cpu`` the tool raises before
    it renders anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bundle = tmp_path / "bundle"
    _tiny_bundle(bundle)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bq.main(["--bundle", str(bundle), "--out", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()
    assert bq.DEFAULT_OUT == os.path.join("chiprun_out", "beam_quality.json")
