"""The port's training loop against the JAX package's.

The policies (plateau decay, the reset coin, the fused batch shape) are
equal exactly.  Both ``train_acoustic`` loops then run on the CPU at a
tiny width (2 x 64, float32, keep probabilities 1, SpecAugment off) from
one checkpoint the JAX ``save`` wrote, over one rendered FLAC corpus, for
4 steps with a checkpoint and an evaluation every 2: the same events
(checkpoint files and steps, evaluation steps, learning-rate values), the
per-step training loss and the evaluation loss within 1e-4 relative, and
the final checkpoint's parameters within 1e-4 relative Frobenius norm
(the JAX scan path against the port's plain path; float32 sums in
different orders)."""

import json
import os
from random import Random
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from rnn_speech_tpu import config as jconfig
from rnn_speech_tpu.charmap import get_char_map as jchar_map
from rnn_speech_tpu.models import acoustic as jac
from rnn_speech_tpu.train import checkpoint as jckpt
from rnn_speech_tpu.train import loop as jloop
from rnn_speech_tpu_torch import config as tconfig
from rnn_speech_tpu_torch import corpus as tcorpus
from rnn_speech_tpu_torch import synth
from rnn_speech_tpu_torch.charmap import get_char_map as tchar_map
from rnn_speech_tpu_torch.train import loop as tloop

LOSS_RTOL = 1e-4
PARAM_RTOL = 1e-4


def test_plateau_policy_equal_to_jax():
    rng = np.random.default_rng(0)
    rates = list(rng.uniform(0.2, 1.0, 60)) + [1.0] * 10 + [0.1] + [0.5] * 12
    t, j = tloop.PlateauPolicy(0.33), jloop.PlateauPolicy(0.33)
    assert [t.update(r) for r in rates] == [j.update(r) for r in rates]
    assert t.history == j.history
    assert tloop.MIN_LEARNING_RATE == jloop.MIN_LEARNING_RATE
    assert tloop.PLATEAU_STRIKES == jloop.PLATEAU_STRIKES


@pytest.mark.parametrize("ratio", [1.0, 0.25, 0.1, 0.0])
def test_reset_coin_sequence_equal_to_jax(ratio):
    a, b = Random(0xC01), Random(0xC01)
    got = [tloop.reset_coin(ratio, a) for _ in range(500)]
    assert got == [jloop.reset_coin(ratio, b) for _ in range(500)]
    assert tloop.COIN_SEED == 0xC01


@pytest.mark.parametrize("fuse,mb", [(True, 3), (False, 3), (True, 1)])
def test_effective_batch_shape_equal_to_jax(fuse, mb):
    config = SimpleNamespace(batch_size=10, mini_batch_size=mb,
                             tpu=SimpleNamespace(fuse_microbatches=fuse))
    got = tloop.effective_batch_shape(config)
    assert got == jloop.effective_batch_shape(config)
    assert got == ((10 * mb, 1) if fuse else (10, mb))


def test_unported_modes_raise(monkeypatch, tmp_path, corpus, caplog):
    """What the loop once refused now runs or raises as the JAX loop does:
    ``--timeline`` without ``tensorboard_dir`` warns and trains untraced; a
    group of more than one rank without a mesh raises ``ValueError``; a
    mesh larger than the ranks there are raises ``ValueError`` naming
    ``torch.distributed.run``; ``RST_MULTIHOST=1`` with a bad
    ``RST_PROCESS_ID`` exits with the JAX CLI's message."""
    import logging

    from rnn_speech_tpu_torch.parallel import launch, mesh

    ini = tmp_path / "c.ini"
    ini.write_text(CONFIG.format(root=tmp_path, corpus=corpus).replace(
        f"tensorboard_dir : {tmp_path}/tb\n", ""))
    config = tconfig.load_config(str(ini))
    assert config.tensorboard_dir is None
    data = sorted(tcorpus.DataProcessor(corpus).get_dataset(), key=lambda d: d[2])
    with caplog.at_level(logging.WARNING, logger=tloop.__name__):
        state = tloop.train_acoustic(config, data, [], tchar_map("english"), max_steps=3,
                                     timeline=True, device="cpu")
    assert "--timeline needs tensorboard_dir; tracing disabled" in caplog.text
    assert int(state["step"]) == 3
    monkeypatch.setattr(launch, "world_and_rank", lambda: (2, 0))
    with pytest.raises(ValueError, match="requires a device mesh"):
        tloop.train_acoustic(config, data, [], tchar_map("english"), max_steps=1,
                             device="cpu")
    with pytest.raises(ValueError, match="torch.distributed.run --nproc_per_node 2"):
        mesh.mesh_shape(2, 1, world=1)
    monkeypatch.setenv("RST_MULTIHOST", "1")
    monkeypatch.setenv("RST_COORD_ADDR", "localhost:1")
    monkeypatch.setenv("RST_NUM_PROCESSES", "2")
    monkeypatch.setenv("RST_PROCESS_ID", "-1")
    with pytest.raises(SystemExit, match="RST_PROCESS_ID must be a non-negative integer"):
        launch.init_from_env("cpu")


CONFIG = """
[acoustic_network_params]
num_layers : 2
hidden_size : 64
dropout_input_keep_prob : 1.0
dropout_output_keep_prob : 1.0
batch_size : 2
mini_batch_size : 2
learning_rate : 0.002
lr_decay_factor : 0.33
grad_clip : 5
signal_processing : fbank
language : english
rnn_state_reset_ratio : 0.5
[general]
use_config_file_if_checkpoint_exists : True
steps_per_checkpoint : 2
steps_per_evaluation : 2
checkpoint_dir : {root}/ckpt
[training]
training_dataset_dirs : {corpus}
test_dataset_dirs : {corpus}
max_input_seq_length : 120
max_target_seq_length : 40
tensorboard_dir : {root}/tb
dataset_size_ordering : True
spec_augment : False
[logging]
log_level : WARNING
[tpu]
compute_dtype : float32
use_pallas_lstm : True
use_pallas_ctc : True
bucket_count : 1
prefetch_depth : 0
fuse_microbatches : True
"""


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Six clips of ~0.7-1.1 s: the sentences' syllables at 22050 Hz."""
    root = tmp_path_factory.mktemp("loop_corpus")
    rng = np.random.default_rng(4)
    texts = synth.sample_sentences(6, rng)
    sigs = []
    for i, text in enumerate(texts):
        clean = synth.render_syllables_clean(text, 22050, rng)[: 15000 + 1800 * i]
        sigs.append(np.clip(clean + rng.normal(0, 200, len(clean)), -32000,
                            32000).astype(np.int16))
    synth.write_corpus(str(root), texts, sigs, 22050)
    return str(root / "demo")


def _run(module, config_mod, char_map, corpus, root, start):
    os.makedirs(root / "tb")
    os.makedirs(root / "ckpt" / "acoustic")
    for name in os.listdir(start):
        with open(os.path.join(start, name), "rb") as src, \
                open(root / "ckpt" / "acoustic" / name, "wb") as dst:
            dst.write(src.read())
    ini = root / "c.ini"
    ini.write_text(CONFIG.format(root=root, corpus=corpus))
    config = config_mod.load_config(str(ini))
    data = sorted(tcorpus.DataProcessor(corpus).get_dataset(), key=lambda d: d[2])
    losses = []
    kw = dict(device="cpu") if module is tloop else {}
    state = module.train_acoustic(
        config, list(data), list(data), char_map, max_steps=4, tb_name="run",
        step_hook=lambda step, m: losses.append((step, float(m["mean_loss"]))), **kw)
    events = [json.loads(line) for line in open(root / "tb" / "run" / "events.jsonl")]
    scalars = [(e["tag"], e["step"], e["value"]) for e in events if e["kind"] == "scalar"]
    return state, losses, scalars, sorted(os.listdir(root / "ckpt" / "acoustic"))


def test_train_acoustic_equal_to_jax(tmp_path, corpus):
    cfg = jac.AcousticConfig(num_layers=2, hidden_size=64, input_dim=120, num_labels=80)
    start = str(tmp_path / "start")
    jckpt.save(start, jac.init_params(jax.random.PRNGKey(7), cfg), 10, 2e-3)
    jstate, jlosses, jscalars, jfiles = _run(jloop, jconfig, jchar_map("english"), corpus,
                                             tmp_path / "jax", start)
    tstate, tlosses, tscalars, tfiles = _run(tloop, tconfig, tchar_map("english"), corpus,
                                             tmp_path / "port", start)
    assert tfiles == jfiles == ["acousticmodel-10.npz", "acousticmodel-12.npz",
                                "acousticmodel-14.npz", "checkpoint"]
    assert [s for s, _ in tlosses] == [s for s, _ in jlosses] == [1, 2, 3, 4]
    np.testing.assert_allclose([v for _, v in tlosses], [v for _, v in jlosses],
                               rtol=LOSS_RTOL)
    # The same events: tags at the same steps; the learning rate equal, the
    # window error rates and the evaluation loss and error within tolerance.
    assert [(tag, step) for tag, step, _ in tscalars] == \
        [(tag, step) for tag, step, _ in jscalars]
    for (tag, _, got), (_, _, ref) in zip(tscalars, jscalars):
        if tag == "learning_rate":
            assert got == ref == pytest.approx(2e-3)
        elif tag == "test/mean_loss":
            np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL, err_msg=tag)
        else:   # greedy error rates: the same labels unless a logit tie flips
            np.testing.assert_allclose(got, ref, atol=0.05, err_msg=tag)
    assert int(tstate["step"]) == int(jstate["step"]) == 14
    got = jckpt.restore(str(tmp_path / "port" / "ckpt" / "acoustic"),
                        jax.tree.map(np.asarray, jstate["params"]))
    ref = jckpt.restore(str(tmp_path / "jax" / "ckpt" / "acoustic"),
                        jax.tree.map(np.asarray, jstate["params"]))
    assert got[1:] == ref[1:]
    for g, r in zip(jax.tree.leaves(got[0]), jax.tree.leaves(ref[0])):
        assert np.linalg.norm(g - r) <= PARAM_RTOL * np.linalg.norm(r)
    # The loop's final parameters are those of its last checkpoint.
    for key, leaf in tstate["params"]["output"].items():
        np.testing.assert_array_equal(leaf.numpy(), got[0]["output"][key])
    assert torch.equal(tstate["lr"], torch.tensor(2e-3, dtype=torch.float32))
