"""The port's sweep driver (``rnn_speech_tpu_torch/tools/sweep.py``) on the
CPU: ``parse_grid`` equals ``tools/sweep.py``'s on the same specs and
refuses the same bad ones; ``--dry_run`` writes one config per grid point
(the base config with the point's values and its own ``checkpoint_dir``)
and prints the port CLI's ``--train_acoustic`` command with ``--device``;
and one real point trains a step through ``python -m
rnn_speech_tpu_torch.cli`` on the CPU and writes its checkpoint."""

import configparser
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import sweep as jsweep  # noqa: E402

from rnn_speech_tpu_torch import synth  # noqa: E402
from rnn_speech_tpu_torch.tools import sweep  # noqa: E402

BASE = """[acoustic_network_params]
num_layers : 1
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
rnn_state_reset_ratio : 1.0
[general]
use_config_file_if_checkpoint_exists : True
steps_per_checkpoint : 1
steps_per_evaluation : 0
checkpoint_dir : {root}/base_ckpt
[training]
training_dataset_dirs : {root}/corpus/demo
max_input_seq_length : 150
max_target_seq_length : 40
[logging]
log_level : WARNING
[tpu]
compute_dtype : float32
prefetch_depth : 0
"""


@pytest.mark.parametrize("specs", [
    ["acoustic_network_params.hidden_size=16,24"],
    ["a.b=1", "training.batch_normalization=True,False", "tpu.frame_stack=1,2,3"],
    ["general.checkpoint_dir=x=y,z"],
])
def test_parse_grid_equals_the_jax_tools(specs):
    assert sweep.parse_grid(specs) == jsweep.parse_grid(specs)


@pytest.mark.parametrize("spec", ["nodot=1", "a.b=", "a.b"])
def test_parse_grid_refuses_bad_specs(spec):
    with pytest.raises(SystemExit, match="Bad --set spec"):
        sweep.parse_grid([spec])
    with pytest.raises(SystemExit, match="Bad --set spec"):
        jsweep.parse_grid([spec])


def test_dry_run_names_the_port_cli(tmp_path, capsys):
    base = tmp_path / "base.ini"
    base.write_text(BASE.format(root=tmp_path))
    out = tmp_path / "runs"
    assert sweep.main(["--config", str(base), "--out", str(out), "--dry_run",
                       "--max_steps", "3", "--device", "cpu",
                       "--set", "acoustic_network_params.hidden_size=16,24",
                       "--set", "training.spec_augment=True,False"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[sweep]")]
    assert len(lines) == 4
    names = sorted(os.listdir(out))
    assert names == ["hidden_size-16_spec_augment-False", "hidden_size-16_spec_augment-True",
                     "hidden_size-24_spec_augment-False", "hidden_size-24_spec_augment-True"]
    for line in lines:
        name, cmd = line[len("[sweep] "):].split(": ", 1)
        argv = cmd.split()
        assert argv[:4] == [sys.executable, "-m", "rnn_speech_tpu_torch.cli", "--train_acoustic"]
        assert argv[argv.index("--device") + 1] == "cpu"
        assert argv[argv.index("--max_steps") + 1] == "3"
        assert argv[argv.index("--tb_name") + 1] == name
        cp = configparser.ConfigParser()
        cp.read(argv[argv.index("--config") + 1])
        assert cp.get("general", "checkpoint_dir") == str(out / name / "ckpt")
        hidden, aug = name.split("_spec_augment-")
        assert cp.get("acoustic_network_params", "hidden_size") == hidden.split("-")[1]
        assert cp.get("training", "spec_augment") == aug
        assert cp.get("training", "max_input_seq_length") == "150"
    with pytest.raises(SystemExit, match="at least one --set"):
        sweep.main(["--config", str(base), "--out", str(out)])


def test_one_point_trains_on_the_cpu(tmp_path):
    rng = np.random.default_rng(2)
    texts = synth.sample_sentences(3, rng)
    sigs = [np.clip(synth.render_syllables_clean(t, 16000, rng)[:14000], -32000, 32000)
            .astype(np.int16) for t in texts]
    synth.write_corpus(str(tmp_path / "corpus"), texts, sigs, 16000)
    base = tmp_path / "base.ini"
    base.write_text(BASE.format(root=tmp_path))
    out = tmp_path / "runs"
    proc = subprocess.run(
        [sys.executable, "-m", "rnn_speech_tpu_torch.tools.sweep", "--config", str(base),
         "--out", str(out), "--max_steps", "1", "--device", "cpu",
         "--set", "acoustic_network_params.hidden_size=16"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "[sweep] hidden_size-16: exit 0" in proc.stdout
    ckpt = out / "hidden_size-16" / "ckpt" / "acoustic"
    assert "acousticmodel-1.npz" in os.listdir(ckpt)
