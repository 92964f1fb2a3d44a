"""The port's CLI modes of the char LM on the CPU, beside the JAX CLI's.

``--generate_text`` on the committed bundle's 1x256 LM prints the JAX
CLI's string; ``--file --lm_weight 0.4`` on a small model (2x64, its
output projection scaled so the logits are peaked) with a 1x16 LM prints
the text of the JAX CLI's ``process_file`` at the same weight;
``--train_language --max_steps 3`` trains on a text corpus, writes
``language/acousticmodel-3.npz`` and ``--generate_text`` restores it; and
``--lm_weight`` without a language checkpoint warns and decodes AM-only.
"""

import io
import os
import shutil
from contextlib import redirect_stdout

import jax
import numpy as np

from rnn_speech_tpu import cli as jcli
from rnn_speech_tpu import config as jconfig
from rnn_speech_tpu.charmap import get_char_map as jget_char_map
from rnn_speech_tpu.models import acoustic as jac
from rnn_speech_tpu.models import language as jlang
from rnn_speech_tpu.train import checkpoint as jckpt
from rnn_speech_tpu_torch import audio_io, cli, synth
from rnn_speech_tpu_torch.train import checkpoint as tckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNDLE = os.path.join(ROOT, "trained_models", "english-syllables")

INI = """[acoustic_network_params]
num_layers : {layers}
hidden_size : {hidden}
dropout_input_keep_prob : 0.9
dropout_output_keep_prob : 0.6
batch_size : 4
mini_batch_size : 1
learning_rate : 0.001
lr_decay_factor : 0.33
grad_clip : 5
rnn_state_reset_ratio : 1.0
signal_processing : fbank
language : english

[lm_network_params]
num_layers : 1
hidden_size : {lm_hidden}
dropout : 0.9
batch_size : 2
learning_rate : 0.01
{corpus}
[general]
use_config_file_if_checkpoint_exists : True
steps_per_checkpoint : 100
steps_per_evaluation : 100
checkpoint_dir : {ckpt}

[training]
max_input_seq_length : 300
max_target_seq_length : 80

[logging]
log_level : WARNING

[tpu]
compute_dtype : float32
use_pallas_lstm : False
wavefront : False
bucket_count : 4
"""


def _ini(tmp_path, ckpt, layers=2, hidden=64, lm_hidden=16, corpus=""):
    path = tmp_path / "lm.ini"
    path.write_text(INI.format(layers=layers, hidden=hidden, lm_hidden=lm_hidden,
                               corpus=corpus, ckpt=ckpt))
    return str(path)


def _printed(capsys):
    return capsys.readouterr().out.strip().splitlines()[-1]


def _jax_mode(fn, ini, *args):
    config = jconfig.HyperParamStore(jconfig.load_config(ini)).config
    out = io.StringIO()
    with redirect_stdout(out):
        assert fn(config, *args) == 0
    return out.getvalue().strip().splitlines()[-1]


def test_generate_text_on_the_bundle_matches_jax(tmp_path, capsys):
    bundle = tmp_path / "bundle"
    shutil.copytree(os.path.join(BUNDLE, "language"), bundle / "language")
    shutil.copy(os.path.join(BUNDLE, "hyperparams.json"), bundle / "hyperparams.json")
    ini = _ini(tmp_path, bundle, layers=3, hidden=1024, lm_hidden=256)
    assert cli.main(["--generate_text", "--config", ini, "--device", "cpu"]) == 0
    printed = _printed(capsys)
    want = _jax_mode(lambda c, *a: jcli.generate_text(c, {}, jget_char_map("english")), ini)
    assert printed == want and printed.startswith("O") and len(printed) > 1


def _small_model(ckpt, lm=True):
    cfg = jac.AcousticConfig(num_layers=2, hidden_size=64, input_dim=120, num_labels=80)
    params = jac.init_params(jax.random.PRNGKey(7), cfg)
    params["output"]["w"] = params["output"]["w"] * 8.0
    jckpt.save(str(ckpt / "acoustic"), jax.tree.map(np.asarray, params), 1, 1e-3)
    if lm:
        lcfg = jlang.LanguageConfig(num_layers=1, hidden_size=16, num_labels=80)
        jckpt.save(str(ckpt / "language"), jax.tree.map(
            np.asarray, jlang.init_params(jax.random.PRNGKey(2), lcfg)), 1, 1e-3)


def _clip(tmp_path):
    text = synth.sample_sentences(1, np.random.default_rng(4))[0]
    sig = synth.render_syllables_clean(text, 22050, np.random.default_rng(5))
    wav = str(tmp_path / "clip.wav")
    audio_io.write_wav(wav, (sig / 32768.0).astype(np.float32), 22050)
    return wav


def test_file_with_lm_weight_matches_jax(tmp_path, capsys):
    ckpt = tmp_path / "ckpt"
    _small_model(ckpt)
    ini, wav = _ini(tmp_path, ckpt), _clip(tmp_path)
    assert cli.main(["--file", wav, "--config", ini, "--device", "cpu",
                     "--lm_weight", "0.4"]) == 0
    printed = _printed(capsys)
    want = _jax_mode(lambda c: jcli.process_file(
        c, {"beam_width": 16, "lm_weight": 0.4}, jget_char_map("english"), wav), ini)
    assert printed == want and len(printed) > 0


def test_train_language_trains_checkpoints_and_generates(tmp_path, capsys):
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("\n".join(synth.sample_sentences(12, np.random.default_rng(0))))
    ckpt = tmp_path / "ckpt"
    ini = _ini(tmp_path, ckpt, corpus=f"text_corpus : {corpus}\n")
    assert cli.main(["--train_language", "--config", ini, "--device", "cpu",
                     "--max_steps", "3"]) == 0
    assert _printed(capsys) == "Language model trained to step 3"
    lm_dir = str(ckpt / "language")
    assert os.path.basename(tckpt.latest_path(lm_dir)) == "acousticmodel-3.npz"
    assert cli.main(["--generate_text", "--config", ini, "--device", "cpu"]) == 0
    printed = _printed(capsys)
    # The JAX CLI restores the port's checkpoint and prints the same string.
    want = _jax_mode(lambda c: jcli.generate_text(c, {}, jget_char_map("english")), ini)
    assert printed == want


def test_lm_weight_without_a_language_checkpoint_decodes_am_only(tmp_path, capsys, caplog):
    ckpt = tmp_path / "ckpt"
    _small_model(ckpt, lm=False)
    ini, wav = _ini(tmp_path, ckpt), _clip(tmp_path)
    assert cli.main(["--file", wav, "--config", ini, "--device", "cpu"]) == 0
    am_only = _printed(capsys)
    assert cli.main(["--file", wav, "--config", ini, "--device", "cpu",
                     "--lm_weight", "0.4"]) == 0
    assert _printed(capsys) == am_only
    assert "no language checkpoint" in caplog.text
