"""The whole serving slice on the committed flagship bundle (3x1024,
fbank-120, 80 labels) at full width on the CPU: one rendered held-out
clip (about 1 s) through the port's ``cli.main(["--file", ..., "--device", "cpu"])``
and through the JAX forward (scan path, use_pallas=False).

The transcripts must be equal, and equal to the rendered text lowercased
as ``CharMap.decode`` returns it.  Logit tolerance: both sides compute in
bf16 with float32 sums, rounding the same operands; summation order and
rare bf16 rounding flips over ~150 steps of three 1024-wide layers stay
below 0.05 on logits of magnitude ~10, far inside the argmax margins.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rnn_speech_tpu.models import acoustic as jac
from rnn_speech_tpu.ops import decode as jdecode
from rnn_speech_tpu.ops.frontend_jax import DeviceFrontend as JaxFrontend
from rnn_speech_tpu.train import checkpoint as jckpt
from rnn_speech_tpu_torch import audio_io, cli, params as tparams, synth
from rnn_speech_tpu_torch.charmap import get_char_map
from rnn_speech_tpu_torch.models import acoustic as tac
from rnn_speech_tpu_torch.ops.frontend import DeviceFrontend

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNDLE = os.path.join(ROOT, "trained_models", "english-syllables")
SR = 22050
LOGIT_TOL = 0.05

INI = """[acoustic_network_params]
num_layers : 3
hidden_size : 1024
dropout_input_keep_prob : 0.9
dropout_output_keep_prob : 0.6
batch_size : 32
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
checkpoint_dir : {bundle}

[training]
max_input_seq_length : 600
max_target_seq_length : 80

[tpu]
compute_dtype : bfloat16
use_pallas_lstm : True
wavefront : True
bucket_count : 8
"""


def _clip():
    """A held-out sentence of the bundle (the seed-0 draw its training run
    kept out), rendered with sigma=900 noise, about 1 s long."""
    text = synth.sample_sentences(2, np.random.default_rng(0))[1]   # "THE BLUE"
    clean = synth.render_syllables_clean(text, SR, np.random.default_rng(5))
    noise = np.random.default_rng([0, 900]).normal(0, 900.0, len(clean))
    sig = np.clip(clean + noise, -32000, 32000).astype(np.float32) / 32768.0
    return text, sig


def test_slice_on_committed_bundle_matches_jax(tmp_path, capsys):
    text, sig = _clip()
    wav = str(tmp_path / "clip.wav")
    audio_io.write_wav(wav, sig, SR)
    ini = tmp_path / "bundle.ini"
    ini.write_text(INI.format(bundle=BUNDLE))

    assert cli.main(["--file", wav, "--config", str(ini), "--device", "cpu"]) == 0
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    assert printed == text.lower()

    # The same WAV samples through the JAX package's scan path.
    loaded, _ = audio_io.load(wav, sr=SR)
    audio = loaded[None]
    lens = np.asarray([len(loaded)], np.int32)
    jcfg = jac.AcousticConfig(num_layers=3, hidden_size=1024, input_dim=120,
                              num_labels=80, compute_dtype=jnp.bfloat16)
    template = jac.init_params(jax.random.PRNGKey(0), jcfg)
    jparams = jckpt.restore(os.path.join(BUNDLE, "acoustic"), template)[0]
    feats, nf = JaxFrontend("fbank", sr=SR, max_samples=audio.shape[1])(
        jnp.asarray(audio), jnp.asarray(lens))
    ref, _ = jac.forward(jparams, jcfg, jnp.transpose(feats, (1, 0, 2)), nf,
                         jac.zero_state(jcfg, 1))
    labels, lab_len = jdecode.greedy_decode(ref, nf)
    char_map = get_char_map("english")
    jax_text = char_map.decode(list(np.asarray(labels)[0, : int(lab_len[0])]))
    assert jax_text == printed

    tp = tparams.load_bundle(BUNDLE, device="cpu")
    tcfg = tac.config_for_params(tp, compute_dtype=torch.bfloat16,
                                 use_kernels=True, wavefront=True)
    tfe = DeviceFrontend("fbank", sr=SR, max_samples=audio.shape[1], device="cpu")
    tfeats, tnf = tfe(torch.as_tensor(audio), torch.as_tensor(lens))
    with torch.no_grad():
        got, _ = tac.forward(tp, tcfg, tfeats.transpose(0, 1), tnf,
                             tac.zero_state(tcfg, 1))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=LOGIT_TOL)
