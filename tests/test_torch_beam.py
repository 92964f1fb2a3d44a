"""The port's AM-only prefix beam search against the JAX package's, and the
port's CLI at its default beam width against the JAX CLI's.

``beam_search_decode`` of both packages runs on the same numpy-seeded
logits, with ragged lengths and a zero-length row, at (V, K, blank) =
(6, 4, V-1), (29, 8, 0) and (80, 16, V-1): random logits, near-one-hot
logits, and rows with planted ties (logits drawn from three values, and a
row of equal logits), where both searches must pick the lowest index among
equal scores.  Labels and lengths must be equal; scores agree to 1e-5
(both run the same float32 recursion after an f32 log-softmax, whose exp
and log differ in the last bits between the two libraries).
"""

import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnn_speech_tpu import cli as jcli
from rnn_speech_tpu import config as jconfig
from rnn_speech_tpu.charmap import get_char_map as jget_char_map
from rnn_speech_tpu.models import acoustic as jac
from rnn_speech_tpu.ops import decode as jdecode
from rnn_speech_tpu.train import checkpoint as jckpt
from rnn_speech_tpu_torch import audio_io, cli, synth
from rnn_speech_tpu_torch.ops import decode as tdecode

SCORE_TOL = dict(rtol=1e-5, atol=1e-5)
T, B = 24, 4
LENS = np.asarray([24, 17, 0, 9], np.int32)


def _logits(kind, V, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return (rng.normal(0, 2.0, (T, B, V))).astype(np.float32)
    if kind == "near_one_hot":
        hot = rng.integers(0, V, (T, B))
        out = rng.normal(0, 0.1, (T, B, V))
        np.put_along_axis(out, hot[..., None], 12.0, axis=-1)
        return out.astype(np.float32)
    out = rng.integers(0, 3, (T, B, V)).astype(np.float32)   # planted ties
    out[:, 1] = 0.5                                          # a row of equal logits
    return out


@pytest.mark.parametrize("kind", ["random", "near_one_hot", "ties"])
@pytest.mark.parametrize("V,K,blank", [(6, 4, -1), (29, 8, 0), (80, 16, -1)])
def test_beam_search_matches_jax(V, K, blank, kind):
    logits = _logits(kind, V, seed=V + K)
    ref = jdecode.beam_search_decode(jnp.asarray(logits), jnp.asarray(LENS),
                                     beam_width=K, blank_id=blank)
    got = tdecode.beam_search_decode(torch.as_tensor(logits), torch.as_tensor(LENS),
                                     beam_width=K, blank_id=blank)
    labels, lengths, scores = (np.asarray(a) for a in ref)
    assert got[0].shape == labels.shape == (B, K, T)
    np.testing.assert_array_equal(got[0].numpy(), labels)
    np.testing.assert_array_equal(got[1].numpy(), lengths)
    np.testing.assert_allclose(got[2].numpy(), scores, **SCORE_TOL)
    assert (got[1][2] == 0).all()                          # the zero-length row


def test_beam_search_max_output_and_frozen_rows():
    """``max_output`` caps the width; a row's frames past its length do not
    change its result (the same row alone, cut at its length)."""
    logits = _logits("random", 29, seed=3)
    full = tdecode.beam_search_decode(torch.as_tensor(logits), torch.as_tensor(LENS),
                                      beam_width=8, max_output=5)
    ref = jdecode.beam_search_decode(jnp.asarray(logits), jnp.asarray(LENS),
                                     beam_width=8, max_output=5)
    np.testing.assert_array_equal(full[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(full[1].numpy(), np.asarray(ref[1]))
    cut = tdecode.beam_search_decode(torch.as_tensor(logits[:9, 3:4]),
                                     torch.as_tensor(LENS[3:4]), beam_width=8,
                                     max_output=5)
    for a, b in zip(full, cut):
        assert torch.equal(a[3:4], b)


def test_hash_wraps_like_int32():
    """The prefix hashes wrap modulo 2^32 as JAX's int32 arithmetic does."""
    h = np.asarray([2**31 - 1, -2**31, 123456789, -987654321], np.int32)
    c = np.asarray([0, 5, 79, 12], np.int32)
    want1 = np.asarray(jnp.asarray(h) * np.int32(1000003) ^ (jnp.asarray(c) + 1))
    want2 = np.asarray(jnp.asarray(h) * np.int32(8191) + (jnp.asarray(c) + 1))
    th, tc = torch.as_tensor(h), torch.as_tensor(c).long()
    np.testing.assert_array_equal(
        (tdecode._wrap_i32(th.long() * 1000003) ^ (tc + 1).to(torch.int32)).numpy(), want1)
    np.testing.assert_array_equal(tdecode._wrap_i32(th.long() * 8191 + tc + 1).numpy(),
                                  want2)


INI = """[acoustic_network_params]
num_layers : 2
hidden_size : 64
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


def test_cli_file_at_the_default_beam_width_matches_jax(tmp_path, capsys, monkeypatch):
    """``--file`` on the CPU with no ``--beam_width`` (16 in both CLIs) on a
    small random model (2x64, fbank-120, 80 labels, float32; its output
    projection scaled so the logits are peaked) and a rendered clip of
    about 1 s: the port prints the text that the JAX CLI's
    ``process_file`` -> ``_transcribe_batch`` prints at beam 16."""
    ckpt = tmp_path / "ckpt"
    cfg = jac.AcousticConfig(num_layers=2, hidden_size=64, input_dim=120, num_labels=80)
    params = jac.init_params(jax.random.PRNGKey(7), cfg)
    params["output"]["w"] = params["output"]["w"] * 8.0
    jckpt.save(str(ckpt / "acoustic"), jax.tree.map(np.asarray, params), 1, 1e-3)
    ini = tmp_path / "small.ini"
    ini.write_text(INI.format(ckpt=ckpt))
    text = synth.sample_sentences(1, np.random.default_rng(4))[0]
    sig = synth.render_syllables_clean(text, 22050, np.random.default_rng(5))
    wav = str(tmp_path / "clip.wav")
    audio_io.write_wav(wav, (sig / 32768.0).astype(np.float32), 22050)

    assert cli.main(["--file", wav, "--config", str(ini), "--device", "cpu"]) == 0
    printed = capsys.readouterr().out.strip().splitlines()[-1]

    widths = []
    transcribe = jcli._transcribe_batch

    def recorded(*args, **kw):
        widths.append(args[5])
        return transcribe(*args, **kw)

    monkeypatch.setattr(jcli, "_transcribe_batch", recorded)
    config = jconfig.HyperParamStore(jconfig.load_config(str(ini))).config
    out = io.StringIO()
    with redirect_stdout(out):
        assert jcli.process_file(config, {"beam_width": 16, "lm_weight": 0.0},
                                 jget_char_map("english"), wav) == 0
    assert widths == [16]
    assert jcli.parse_args(["--file", wav])["beam_width"] == 16
    assert cli.parse_args(["--file", wav])["beam_width"] == 16
    assert printed == out.getvalue().strip().splitlines()[-1]
    assert len(printed) > 0


def test_cli_lm_weight_raises_naming_the_lm_slice(tmp_path):
    """``--lm_weight`` above 0 no longer raises ``NotImplementedError`` (the
    LM slice is ported: ``tests/test_torch_cli_lm.py`` holds its text
    against the JAX CLI's); a missing clip raises the audio loader's own
    error after the config is read."""
    ini = tmp_path / "small.ini"
    ini.write_text(INI.format(ckpt=tmp_path / "ckpt"))
    with pytest.raises((OSError, ValueError)) as err:
        cli.main(["--file", str(tmp_path / "x.wav"), "--lm_weight", "0.5",
                  "--config", str(ini), "--device", "cpu"])
    assert not isinstance(err.value, NotImplementedError)
