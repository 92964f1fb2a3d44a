"""The port's training loop and CLI on two gloo ranks on the CPU against
one process, as ``tests/test_multihost.py`` holds the JAX package's two
processes against one.

The training corpus is 8 copies of ONE clip with one transcript, so every
batch has identical rows however the ranks shard the file list, and one
rank's trajectory and two ranks' are comparable: losses within 1e-4
relative, and the checkpoints' parameters within 1e-4 relative Frobenius
norm a tensor (float32 sums in another association).  The test set has
an odd number of clips (9), so the ranks' shards get 5 and 4 and the
exhausted rank feeds an all-padding batch in lockstep; the evaluation
loss must match within 1e-4.  ``--evaluate`` on 9 distinct clips prints
on rank 0 exactly what one process prints; rank 1 prints nothing.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from rnn_speech_tpu_torch import cli, params as tparams, synth
from rnn_speech_tpu_torch.models import acoustic
from rnn_speech_tpu_torch.parallel import launch
from rnn_speech_tpu_torch.train import checkpoint

import test_torch_rank_workers as workers

LOSS_RTOL = PARAM_RTOL = 1e-4
SPAWN_TIMEOUT = 300

CONFIG = """
[acoustic_network_params]
num_layers : 2
hidden_size : 16
dropout_input_keep_prob : 1.0
dropout_output_keep_prob : 1.0
batch_size : 8
mini_batch_size : 1
learning_rate : 0.003
lr_decay_factor : 0.33
grad_clip : 5
signal_processing : fbank
language : english
rnn_state_reset_ratio : 0.0
[general]
use_config_file_if_checkpoint_exists : True
steps_per_checkpoint : 2
steps_per_evaluation : 2
checkpoint_dir : {root}/ckpt_{tag}
[training]
training_dataset_dirs : {root}/{train}
test_dataset_dirs : {root}/{test}
max_input_seq_length : 100
max_target_seq_length : 40
batch_normalization : {bn}
dataset_size_ordering : True
tensorboard_dir : {root}/tb_{tag}
[logging]
log_level : WARNING
[tpu]
compute_dtype : float32
prefetch_depth : 0
bucket_count : 4
"""


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("multirank")
    rng = np.random.default_rng(3)
    n = int(16000 * 0.5)
    clip = np.clip(0.3 * 32000 * np.sin(2 * np.pi * 440 * np.arange(n) / 16000)
                   + rng.normal(0, 300, n), -32000, 32000).astype(np.int16)
    synth.write_corpus(str(root / "copies"), ["HELLO WORLD"] * 8, [clip] * 8, 16000)
    synth.write_corpus(str(root / "odd"), ["HELLO WORLD"] * 9, [clip] * 9, 16000)
    texts = synth.sample_sentences(9, rng)
    sigs = [np.clip(synth.render_syllables_clean(t, 16000, rng)[: 9000 + 600 * i]
                    + rng.normal(0, 300, 9000 + 600 * i), -32000, 32000).astype(np.int16)
            for i, t in enumerate(texts)]
    synth.write_corpus(str(root / "distinct"), texts, sigs, 16000)
    return root


def _ini(root, tag, train="copies/demo", test="odd/demo", bn=False):
    os.makedirs(root / f"tb_{tag}", exist_ok=True)
    path = root / f"{tag}.ini"
    path.write_text(CONFIG.format(root=root, tag=tag, train=train, test=test, bn=bn))
    return str(path)


def _metric_files(root, tag):
    found = []
    for dirpath, _, names in os.walk(str(root / f"tb_{tag}")):
        found.extend(os.path.join(dirpath, n) for n in names)
    return sorted(found)


def _eval_losses(files):
    out = []
    for path in files:
        if path.endswith("events.jsonl"):
            out += [rec["value"] for rec in map(json.loads, open(path))
                    if rec.get("tag") == "test/mean_loss"]
    return out


def _restore(root, tag, template):
    got = checkpoint.restore(str(root / f"ckpt_{tag}" / "acoustic"), template)
    assert got is not None
    return {k: v.numpy() for k, v in tparams.flatten(got[0]).items()}, got[1]


def _template():
    cfg = acoustic.AcousticConfig(num_layers=2, hidden_size=16, input_dim=120,
                                  num_labels=80)
    return acoustic.init_params(torch.Generator().manual_seed(5), cfg, "cpu")


def test_two_rank_training_matches_one_rank(root):
    single = workers.train_loop(0, 1, torch.device("cpu"), _ini(root, "single"), 1, 2)
    two = launch.spawn_ranks(workers.train_loop, 2, "gloo", "cpu",
                             args=(_ini(root, "two"), 1, 2), timeout=SPAWN_TIMEOUT)
    # Both ranks hold the same (all-reduced, replicated) metrics and params.
    np.testing.assert_allclose(two[0]["steps"], two[1]["steps"], rtol=1e-6)
    np.testing.assert_allclose(two[0]["params_sum"], two[1]["params_sum"], rtol=1e-6)
    assert [s[0] for s in two[0]["steps"]] == [s[0] for s in single["steps"]] == [1, 2]
    np.testing.assert_allclose([s[1] for s in two[0]["steps"]],
                               [s[1] for s in single["steps"]], rtol=LOSS_RTOL)
    np.testing.assert_allclose(two[0]["params_sum"], single["params_sum"], rtol=PARAM_RTOL)
    got, step = _restore(root, "two", _template())
    ref, ref_step = _restore(root, "single", _template())
    assert step == ref_step == 2
    for key in ref:
        assert np.linalg.norm(got[key] - ref[key]) <= PARAM_RTOL * np.linalg.norm(ref[key])
    # Metrics written once (rank 0 only): the same files, of the same size.
    files_s, files_m = _metric_files(root, "single"), _metric_files(root, "two")
    kinds = lambda files: [re.sub(r"\d+", "N", os.path.basename(f)) for f in files]
    assert len(files_s) == 2 and kinds(files_s) == kinds(files_m)
    for fs, fm in zip(files_s, files_m):
        assert abs(os.path.getsize(fs) - os.path.getsize(fm)) < \
            max(64, 0.2 * os.path.getsize(fs))
    # The lockstep evaluation over the odd test set: the one-process loss.
    ev_s, ev_m = _eval_losses(files_s), _eval_losses(files_m)
    assert len(ev_s) == len(ev_m) == 1
    np.testing.assert_allclose(ev_m, ev_s, rtol=LOSS_RTOL)


@pytest.fixture(scope="module")
def cli_two_ranks(root):
    """One pair of ranks runs, in turn: a (1, 2) FSDP --train_acoustic,
    --evaluate on the (2, 1) mesh, and --evaluate of a batch-normalised
    model on it."""
    fsdp = _ini(root, "fsdp")
    evaluate = _ini(root, "eval", test="distinct/demo")
    bn = _ini(root, "bn", test="distinct/demo", bn=True)
    runs = [["--train_acoustic", "--config", fsdp, "--device", "cpu", "--mesh_data", "1",
             "--mesh_model", "2", "--max_steps", "2"],
            ["--evaluate", "--config", evaluate, "--device", "cpu", "--beam_width", "1",
             "--mesh_data", "0"],
            ["--evaluate", "--config", bn, "--device", "cpu", "--beam_width", "1",
             "--mesh_data", "0"]]
    ranks = launch.spawn_ranks(workers.cli_runs, 2, "gloo", "cpu", args=(runs,),
                               timeout=SPAWN_TIMEOUT)
    return evaluate, ranks


def test_fsdp_cli_run_saves_a_full_checkpoint(root, cli_two_ranks):
    _, ranks = cli_two_ranks
    assert ranks[0][0] == ranks[1][0] == {"rc": 0, "out": ""}
    got, step = _restore(root, "fsdp", _template())
    assert step == 2
    for key, value in tparams.flatten(_template()).items():
        assert got[key].shape == tuple(value.shape) and np.all(np.isfinite(got[key]))
    assert sorted(os.listdir(root / "ckpt_fsdp" / "acoustic")) == [
        "acousticmodel-2.npz", "checkpoint"]


def test_two_rank_evaluate_prints_the_one_rank_numbers(cli_two_ranks, capsys):
    ini, ranks = cli_two_ranks
    assert cli.main(["--evaluate", "--config", ini, "--device", "cpu",
                     "--beam_width", "1"]) == 0
    single = capsys.readouterr().out
    assert "Resulting WER" in single and "Resulting CER" in single
    assert ranks[0][1] == {"rc": 0, "out": single}
    assert ranks[1][1] == {"rc": 0, "out": ""}


def test_sharded_evaluate_refuses_batch_normalization(cli_two_ranks):
    _, ranks = cli_two_ranks
    for rank in ranks:
        assert rank[2]["error"].startswith("ValueError: batch_normalization")
