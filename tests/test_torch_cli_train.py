"""The port's CLI in its training and evaluation modes on the CPU, over a
rendered FLAC corpus in LibriSpeech's layout: ``--train_acoustic`` writes
checkpoints and a second run resumes at their step and learning rate;
``--evaluate`` prints the same WER and CER lines as the JAX CLI's on the
same checkpoint and corpus (greedy, float32: the printed 3-digit values
equal)."""

import os

import numpy as np
import pytest

from rnn_speech_tpu import cli as jcli
from rnn_speech_tpu_torch import cli as tcli
from rnn_speech_tpu_torch import synth
from rnn_speech_tpu_torch.train import checkpoint as tckpt

CONFIG = """
[acoustic_network_params]
num_layers : 2
hidden_size : 32
dropout_input_keep_prob : 0.9
dropout_output_keep_prob : 0.8
batch_size : 3
mini_batch_size : 1
learning_rate : 0.003
lr_decay_factor : 0.33
grad_clip : 5
signal_processing : fbank
language : english
rnn_state_reset_ratio : 1.0
[general]
use_config_file_if_checkpoint_exists : True
steps_per_checkpoint : 2
steps_per_evaluation : 2
checkpoint_dir : {root}/ckpt
[training]
training_dataset_dirs : {root}/corpus/demo
test_dataset_dirs : {root}/corpus/demo
max_input_seq_length : 150
max_target_seq_length : 40
tensorboard_dir : {root}/tb
spec_augment : True
[logging]
log_level : WARNING
[tpu]
compute_dtype : float32
bucket_count : 4
prefetch_depth : 0
"""


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_train")
    rng = np.random.default_rng(9)
    texts = synth.sample_sentences(5, rng)
    sigs = []
    for i, text in enumerate(texts):
        clean = synth.render_syllables_clean(text, 16000, rng)[: 12000 + 2000 * i]
        sigs.append(np.clip(clean + rng.normal(0, 300, len(clean)), -32000,
                            32000).astype(np.int16))
    synth.write_corpus(str(root / "corpus"), texts, sigs, 16000)
    os.makedirs(root / "tb")
    cfg = root / "config.ini"
    cfg.write_text(CONFIG.format(root=root))
    return root, str(cfg)


def test_train_acoustic_writes_checkpoints_and_resumes(workdir):
    root, cfg = workdir
    ckpt_dir = str(root / "ckpt" / "acoustic")
    assert tcli.main(["--train_acoustic", "--config", cfg, "--device", "cpu",
                      "--max_steps", "2", "--learn_rate", "0.0025", "--tb_name", "a"]) == 0
    assert sorted(os.listdir(ckpt_dir)) == ["acousticmodel-2.npz", "checkpoint"]
    first = tckpt.restore_flat(ckpt_dir)
    assert first[1:] == (2, pytest.approx(0.0025))
    # The second run starts at step 2 with the saved rate, not the ini's.
    assert tcli.main(["--train_acoustic", "--config", cfg, "--device", "cpu",
                      "--max_steps", "2", "--tb_name", "b"]) == 0
    assert sorted(os.listdir(ckpt_dir)) == ["acousticmodel-2.npz", "acousticmodel-4.npz",
                                            "checkpoint"]
    second = tckpt.restore_flat(ckpt_dir)
    assert second[1:] == (4, pytest.approx(0.0025))
    assert any(not np.array_equal(second[0][k], first[0][k]) for k in first[0])
    for run in ("a", "b"):
        names = os.listdir(root / "tb" / run)
        assert "events.jsonl" in names
        assert any(n.startswith("events.out.tfevents") for n in names)


def test_evaluate_prints_the_jax_cli_wer_and_cer(workdir, capsys):
    root, cfg = workdir
    if not os.path.exists(root / "ckpt" / "acoustic" / "checkpoint"):
        assert tcli.main(["--train_acoustic", "--config", cfg, "--device", "cpu",
                          "--max_steps", "2"]) == 0
    capsys.readouterr()
    assert tcli.main(["--evaluate", "--config", cfg, "--device", "cpu",
                      "--beam_width", "1"]) == 0
    got = capsys.readouterr().out.strip().splitlines()
    assert jcli.main(["--evaluate", "--config", cfg, "--beam_width", "1"]) == 0
    ref = capsys.readouterr().out.strip().splitlines()
    assert got[-2:] == ref[-2:]
    assert got[-2].startswith("Resulting WER : ") and got[-1].startswith("Resulting CER : ")
