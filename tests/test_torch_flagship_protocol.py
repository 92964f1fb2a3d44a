"""The port's flagship accuracy protocol
(``rnn_speech_tpu_torch/tools/flagship_accuracy_run.py``) on the CPU, at
toy scale, against ``tools/flagship_accuracy_run.py``:

* ``build_corpus`` and ``noisy_points`` are bit-identical to the JAX
  tool's (FLAC bytes, transcripts, clean renders, noisy points; tolerance:
  none);
* ``decode_table`` on one tiny bundle (2x64, a 1x32 LM, 6 clips, 2 levels,
  beam 2 with the LM) gives the JAX tool's entries, every key but
  ``decode_seconds`` equal (tolerance: none), in float32 and bfloat16;
* a bundle either tool exports restores in the other's checkpoint module,
  the same arrays bit for bit;
* the protocol end to end: one continuous session's curves, the sweep's
  tables, the streaming table and the exported bundle (the assertions of
  ``tests/test_flagship_protocol.py``), the refusal of a weights-free
  bundle, and the resume after a crash.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import flagship_accuracy_run as jfr  # noqa: E402

import jax  # noqa: E402

from rnn_speech_tpu import config as jconfig  # noqa: E402
from rnn_speech_tpu.models import acoustic as jacoustic  # noqa: E402
from rnn_speech_tpu.models import language as jlanguage  # noqa: E402
from rnn_speech_tpu.train import checkpoint as jckpt  # noqa: E402
from rnn_speech_tpu_torch import config as tconfig  # noqa: E402
from rnn_speech_tpu_torch import params as params_mod  # noqa: E402
from rnn_speech_tpu_torch import synth  # noqa: E402
from rnn_speech_tpu_torch.charmap import get_char_map  # noqa: E402
from rnn_speech_tpu_torch.models import acoustic, language  # noqa: E402
from rnn_speech_tpu_torch.tools import flagship_accuracy_run as fr  # noqa: E402
from rnn_speech_tpu_torch.train import checkpoint as tckpt  # noqa: E402


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


def test_build_corpus_and_noisy_points_bit_identical(tmp_path):
    kw = dict(clips=5, test_clips=3, seed=4, sr=22050, train_noise=(200.0, 3000.0),
              loop_eval_noise=2400.0)
    timings = {}
    t_train, t_test, t_held = fr.build_corpus(str(tmp_path / "port"), timings=timings, **kw)
    j_train, j_test, j_held = jfr.build_corpus(str(tmp_path / "jax"), **kw)
    assert set(timings) == {"render", "encode"}
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    strip = lambda items: sorted((os.path.basename(p), label, dur) for p, label, dur in items)
    assert strip(t_train) == strip(j_train) and strip(t_test) == strip(j_test)
    assert len(t_train) == 5 and len(t_test) == 3
    assert [t for t, _ in t_held] == [t for t, _ in j_held]
    for (_, a), (_, b) in zip(t_held, j_held):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    levels = (300.0, 2400.0, 4800.0)
    tp, jp = fr.noisy_points(t_held, levels, 4), jfr.noisy_points(j_held, levels, 4)
    assert list(tp) == list(jp) == list(levels)
    for level in levels:
        for (sa, ta), (sb, tb) in zip(tp[level], jp[level]):
            assert ta == tb and sa.dtype == sb.dtype == np.float32
            assert sa.tobytes() == sb.tobytes()


def _tiny_bundle(root, compute_dtype):
    """One set of weights (2x64 acoustic, 1x32 LM, seeded) saved by the
    port; the two tools' Configs rooted at it."""
    char_map = get_char_map("english")
    gen = torch.Generator().manual_seed(3)
    cfg = acoustic.AcousticConfig(num_layers=2, hidden_size=64, input_dim=120,
                                  num_labels=len(char_map))
    tckpt.save(os.path.join(root, "acoustic"), acoustic.init_params(gen, cfg, "cpu"), 7, 1e-3)
    lcfg = language.LanguageConfig(num_layers=1, hidden_size=32, num_labels=len(char_map))
    tckpt.save(os.path.join(root, "language"), language.init_params(gen, lcfg, "cpu"), 5, 1e-3)
    kw = dict(num_layers=2, hidden_size=64, max_input_seq_length=300,
              max_target_seq_length=80, checkpoint_dir=str(root), tensorboard_dir="")
    tc = tconfig.Config(lm=tconfig.LmConfig(num_layers=1, hidden_size=32),
                        tpu=tconfig.TpuConfig(compute_dtype=compute_dtype), **kw)
    jc = jconfig.Config(lm=jconfig.LmConfig(num_layers=1, hidden_size=32),
                        tpu=jconfig.TpuConfig(compute_dtype=compute_dtype), **kw)
    return char_map, tc, jc


def _strip_times(sweep):
    return {level: {mode: {k: v for k, v in entry.items() if k != "decode_seconds"}
                    for mode, entry in table.items()}
            for level, table in sweep.items()}


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_decode_table_equals_the_jax_tools(tmp_path, compute_dtype):
    char_map, tc, jc = _tiny_bundle(tmp_path, compute_dtype)
    rng = np.random.default_rng(0)
    texts = synth.sample_sentences(6, rng)
    held = [(t, synth.render_syllables_clean(t, 22050, rng)) for t in texts]
    points = fr.noisy_points(held, (300.0, 2400.0), 0)
    sweep, paired = fr.decode_table(tc, char_map, points, 2, 0.5, 4, device="cpu")
    j_sweep, j_paired = jfr.decode_table(jc, char_map, jfr.noisy_points(held, (300.0, 2400.0), 0),
                                         2, 0.5, 4)
    assert set(sweep) == {"300.0", "2400.0"}
    assert all(set(t) == {"greedy", "beam2", "beam2_lm"} for t in sweep.values())
    assert _strip_times(sweep) == _strip_times(j_sweep)
    assert paired == j_paired
    # The edits are not saturated: the raw counts compared above carry them.
    assert sweep["300.0"]["greedy"]["char_edits"] > 0


def test_exported_bundles_restore_in_both_packages(tmp_path):
    """The port's export restores through the JAX checkpoint module, and
    the JAX tool's export through the port's: the same bf16-rounded arrays
    bit for bit, the same step and learning rate."""
    char_map, tc, jc = _tiny_bundle(tmp_path / "run", "float32")
    copied = fr.export_weights(str(tmp_path / "port_bundle"), tc)
    assert copied == {"acoustic": "acousticmodel-7.npz", "language": "acousticmodel-5.npz"}
    jfr.export_weights(str(tmp_path / "jax_bundle"), jc)
    jax_templates = {
        "acoustic": jacoustic.init_params(jax.random.PRNGKey(1), jacoustic.AcousticConfig(
            num_layers=2, hidden_size=64, input_dim=120, num_labels=len(char_map))),
        "language": jlanguage.init_params(jax.random.PRNGKey(1), jlanguage.LanguageConfig(
            num_layers=1, hidden_size=32, num_labels=len(char_map))),
    }
    port_templates = {
        "acoustic": acoustic.init_params(torch.Generator().manual_seed(1), acoustic.AcousticConfig(
            num_layers=2, hidden_size=64, input_dim=120, num_labels=len(char_map)), "cpu"),
        "language": language.init_params(torch.Generator().manual_seed(1), language.LanguageConfig(
            num_layers=1, hidden_size=32, num_labels=len(char_map)), "cpu"),
    }
    for sub in ("acoustic", "language"):
        j_params, j_step, j_lr = jckpt.restore(str(tmp_path / "port_bundle" / sub),
                                               jax_templates[sub])
        t_params, t_step, t_lr = tckpt.restore(str(tmp_path / "jax_bundle" / sub),
                                               port_templates[sub])
        assert (t_step, t_lr) == (j_step, j_lr) == ({"acoustic": 7, "language": 5}[sub], 1e-3)
        j_flat = params_mod.flatten(params_mod.params_from_jax(j_params, "cpu"))
        t_flat = params_mod.flatten(t_params)
        assert sorted(j_flat) == sorted(t_flat)
        for key in t_flat:
            assert t_flat[key].numpy().tobytes() == j_flat[key].numpy().tobytes(), key
        with np.load(tckpt.latest_path(str(tmp_path / "port_bundle" / sub))) as data:
            assert tckpt.BF16_KEYS in data.files
    sidecar = json.loads((tmp_path / "port_bundle" / "hyperparams.json").read_text())
    assert jconfig.Config.from_dict(sidecar).checkpoint_dir == str(tmp_path / "port_bundle")


def test_flagship_protocol_toy_scale(tmp_path):
    bundle = tmp_path / "bundle"
    result = fr.run(
        str(tmp_path), out_path=str(tmp_path / "artifact.json"),
        clips=24, test_clips=6, layers=1, hidden=48, batch=8,
        max_steps=20, steps_per_checkpoint=10, lr=4e-3,
        beam_width=2, lm_weight=0.3, lm_steps=10,
        train_noise=(200.0, 800.0), eval_noise_levels=(300.0, 600.0),
        decode_batch=4, artifact_dir=str(bundle),
        streaming_chunk_seconds=(0.5,), streaming_max_clips=3, device="cpu",
    )

    # One continuous session: every checkpoint window logged train error,
    # eval error AND the LR.
    curves = result["curves"]
    assert len(curves["train_error_rate"]) == 2      # 20 steps / window 10
    assert len(curves["eval_error_rate"]) == 2
    assert len(curves["learning_rate"]) == 2
    steps = [s for s, _ in curves["train_error_rate"]]
    assert steps == sorted(steps) and steps[-1] == 20

    # The sweep decodes all three quality modes at every noise level,
    # each scoring every held-out clip, with counts and CIs recorded.
    assert set(result["noise_sweep"]) == {"300.0", "600.0"}
    for table in result["noise_sweep"].values():
        assert set(table) == {"greedy", "beam2", "beam2_lm"}
        for entry in table.values():
            assert entry["clips"] == 6
            assert 0.0 <= entry["wer"] <= 100.0
            assert 0.0 <= entry["cer"] <= 100.0
            assert entry["n_words"] >= 2 * entry["clips"]
            assert entry["word_edits"] >= 0
            lo, hi = entry["wer_ci95"]
            assert lo <= entry["wer"] <= hi
    # Headline table = the middle sweep level (here the upper of two).
    assert result["headline_noise_std"] == 600.0
    assert result["wer_table"] == result["noise_sweep"]["600.0"]
    assert set(result["beam_vs_greedy_paired"]) == {"300.0", "600.0"}
    for rec in result["beam_vs_greedy_paired"].values():
        lo, hi = rec["delta_wer_ci95"]
        assert lo <= rec["delta_wer"] <= hi

    assert os.path.exists(tmp_path / "artifact.json")
    assert "lr_decays_engaged" in result
    assert set(result["decode_delta_vs_greedy"]) == {"beam2", "beam2_lm"}
    assert set(result["beam_improves_beyond_floor"]) == {"300.0", "600.0"}
    assert set(result["stage_seconds"]) == {"render", "encode", "train", "lm", "export",
                                            "decode", "streaming"}

    # Streaming section: chunked-vs-one-shot agreement on the bundle.
    streaming = result["streaming"]
    assert "greedy" in streaming and "beam2_lm" in streaming
    for mode in streaming.values():
        rec = mode["chunks"]["0.5"]
        assert rec["clips"] == 3
        assert 0.0 <= rec["agreement_pct"] <= 100.0

    # The exported bundle is complete and self-describing: both
    # checkpoints resolve through the pointer as bf16 bundles, the
    # hyperparams sidecar reconstructs a Config rooted at the bundle, and
    # the README records the sweep.
    for sub in ("acoustic", "language"):
        path = tckpt.latest_path(str(bundle / sub))
        assert path is not None and os.path.getsize(path) > 0
        with np.load(path) as data:
            assert int(data["__step__"]) > 0
            assert float(data["__learning_rate__"]) > 0
            assert tckpt.BF16_KEYS in data.files       # written as bf16
            assert any(not k.startswith("__") for k in data.files)
    cfg = tconfig.Config.from_dict(json.loads((bundle / "hyperparams.json").read_text()))
    assert cfg.checkpoint_dir == str(bundle)
    assert cfg.hidden_size == 48 and cfg.num_layers == 1
    readme = (bundle / "README.md").read_text()
    assert "beam2_lm" in readme and "greedy" in readme
    assert "word edits" in readme


def test_export_weights_refuses_empty_bundle(tmp_path):
    """A weights-free bundle must raise, not print success."""
    config = tconfig.Config(checkpoint_dir=str(tmp_path / "nonexistent"))
    with pytest.raises(RuntimeError, match="weights-free"):
        fr.export_weights(str(tmp_path / "bundle"), config)


def test_flagship_protocol_resume_after_crash(tmp_path):
    """--resume skips training, replays the corpus rng bit-identically,
    reuses the checkpoints + curves under the workdir, and may EXTEND the
    sweep: the common levels reproduce the original decode exactly."""
    bundle = tmp_path / "bundle"
    kw = dict(
        clips=16, test_clips=4, layers=1, hidden=32, batch=8,
        max_steps=10, steps_per_checkpoint=5, lr=4e-3,
        beam_width=2, lm_weight=0.3, lm_steps=5,
        train_noise=(200.0, 800.0),
        decode_batch=4, artifact_dir=str(bundle), run_streaming=False,
        device="cpu",
    )
    first = fr.run(str(tmp_path), out_path=None,
                   eval_noise_levels=(300.0, 600.0), **kw)

    out = tmp_path / "resumed.json"
    resumed = fr.run(str(tmp_path), out_path=str(out),
                     eval_noise_levels=(300.0, 600.0, 1200.0),
                     headline_noise=600.0, resume=True, **kw)

    # Training was skipped, curves reread from the original session.
    assert resumed["curves"] == first["curves"]
    assert resumed["lr_decays_engaged"] == first["lr_decays_engaged"]
    assert resumed["config"]["train_seconds"] > 0
    assert resumed["config"]["lm"]["steps"] == first["config"]["lm"]["steps"] == 5
    for level in ("300.0", "600.0"):
        assert _strip_times(resumed["noise_sweep"])[level] == \
            _strip_times(first["noise_sweep"])[level]
    assert set(resumed["noise_sweep"]) == {"300.0", "600.0", "1200.0"}
    # Headline pinned by headline_noise, not the (shifted) middle.
    assert resumed["headline_noise_std"] == 600.0
    assert resumed["wer_table"] == resumed["noise_sweep"]["600.0"]
    assert json.loads(out.read_text())["noise_sweep"].keys() == \
        resumed["noise_sweep"].keys()
    with pytest.raises(RuntimeError, match="no acoustic checkpoint"):
        fr.run(str(tmp_path / "empty"), out_path=None, resume=True,
               eval_noise_levels=(300.0, 600.0), **kw)


def test_main_parses_the_jax_tools_flags_and_device(tmp_path, monkeypatch):
    """``main`` takes the JAX tool's flags plus ``--device`` and writes
    under ``chiprun_out/`` by default; ``--resume`` needs ``--workdir``."""
    seen = {}
    monkeypatch.setattr(fr, "run", lambda workdir, out, **kw: seen.update(
        workdir=workdir, out=out, **kw) or {"noise_sweep": {}, "beam_vs_greedy_paired": {}})
    assert fr.main(["--device", "cpu", "--workdir", str(tmp_path), "--max_steps", "600",
                    "--eval_noise_levels", "900", "2400", "4800", "7200", "9600",
                    "--headline_noise", "2400"]) == 0
    assert seen["out"] == os.path.join("chiprun_out", "flagship_accuracy.json")
    assert seen["device"] == "cpu" and seen["max_steps"] == 600
    assert seen["eval_noise_levels"] == (900.0, 2400.0, 4800.0, 7200.0, 9600.0)
    assert (seen["clips"], seen["test_clips"], seen["hidden"]) == (1100, 160, 1024)
    with pytest.raises(SystemExit):
        fr.main(["--resume"])
