"""The fbank frontend's fused spectrogram kernel (``ops/frontend_kernel.py``)
and the port's frontend against the JAX package and its numpy oracle.

* ``DeviceFrontend("fbank", use_kernel=True)`` on the CPU (the kernel's
  plain version) against the JAX ``DeviceFrontend("fbank",
  use_pallas=True)``, whose ``fbank_banks_pallas`` runs in Pallas's
  interpreter (as ``tests/test_frontend.py`` runs it), at 22050 and 16000
  Hz with ragged rows and a zero-length row.
* The port's fbank and MFCC frontends against the host numpy oracle
  ``rnn_speech_tpu/frontend.py`` (``extract_fbank``, ``extract_mfcc``):
  full-length and padded-batch clips, and the short-clip edge rules.

Tolerance, 2e-3 of the reference's largest magnitude (at least 1), the
JAX package's own for its kernel and for its device frontend against the
oracle: every side computes the float32 DFT and mel sums in another order
(the oracle in float64 with ``np.fft``), so the log-mel values (tens of
dB) agree to about 1e-4, and a frame whose power is tiny, where the log
is steep, moves more.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnn_speech_tpu import frontend as oracle
from rnn_speech_tpu.ops import frontend_pallas as jfpal
from rnn_speech_tpu.ops.frontend_jax import DeviceFrontend as JaxFrontend
from rnn_speech_tpu_torch.ops import frontend_kernel as tfk
from rnn_speech_tpu_torch.ops.frontend import DeviceFrontend

TOL = 2e-3


def _assert_close(got, ref):
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(np.asarray(got) / scale, np.asarray(ref) / scale,
                               rtol=0, atol=TOL)


def _audio(sr, lengths, width, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(width) / sr
    audio = np.zeros((len(lengths), width), np.float32)
    for i, n in enumerate(lengths):
        sig = 0.3 * np.sin(2 * np.pi * (180.0 + 60 * i) * t) + rng.normal(0, 0.05, width)
        audio[i, :n] = sig[:n]
    return audio, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("sr", [22050, 16000])
def test_kernel_route_matches_jax_pallas_fbank(sr, monkeypatch):
    width = sr * 2
    audio, lens = _audio(sr, [width, width // 2, 0, width // 3], width, seed=sr)
    orig = jfpal.fbank_banks_pallas
    monkeypatch.setattr(jfpal, "fbank_banks_pallas",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    jfe = JaxFrontend("fbank", sr=sr, max_samples=width, use_pallas=True)
    ref, ref_nf = jfe(jnp.asarray(audio), jnp.asarray(lens))
    tfe = DeviceFrontend("fbank", sr=sr, max_samples=width, device="cpu", use_kernel=True)
    assert tfe.use_kernel
    got, nf = tfe(torch.as_tensor(audio), torch.as_tensor(lens))
    np.testing.assert_array_equal(np.asarray(ref_nf), nf.numpy())
    assert got.shape == ref.shape and got.dtype == torch.float32
    _assert_close(got.numpy(), np.asarray(ref))
    assert tfk.fbank_banks.launches == 0          # the CPU takes the plain version


def test_kernel_switch_is_fbank_only_and_its_plain_version_is_the_default_path():
    """``use_kernel`` is ignored for MFCC (JAX's ``use_pallas`` is fbank
    only); on the CPU the kernel's plain version gives the default
    frontend's features bit for bit."""
    assert not DeviceFrontend("mfcc", sr=16000, max_samples=8000, device="cpu",
                              use_kernel=True).use_kernel
    audio, lens = _audio(16000, [8000, 0, 3100], 8000, seed=1)
    a = DeviceFrontend("fbank", sr=16000, max_samples=8000, device="cpu")
    b = DeviceFrontend("fbank", sr=16000, max_samples=8000, device="cpu", use_kernel=True)
    for x, y in zip(a(torch.as_tensor(audio), torch.as_tensor(lens)),
                    b(torch.as_tensor(audio), torch.as_tensor(lens))):
        assert torch.equal(x, y)


def _oracle_extract(feature):
    return oracle.extract_fbank if feature == "fbank" else oracle.extract_mfcc


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("feature", ["fbank", "mfcc"])
def test_frontend_matches_the_numpy_oracle(feature, use_kernel):
    """A one-second clip alone and a half-second clip inside a padded
    batch, each featurized as the oracle featurizes it alone."""
    sr = 22050
    audio, lens = _audio(sr, [sr, sr // 2], sr, seed=3)
    fe = DeviceFrontend(feature, sr=sr, max_samples=sr, device="cpu", use_kernel=use_kernel)
    feats, nf = fe(torch.as_tensor(audio), torch.as_tensor(lens))
    for b, n in enumerate(lens):
        ref, n_ref = _oracle_extract(feature)(audio[b, :n], sr)
        assert int(nf[b]) == n_ref
        _assert_close(feats[b, :n_ref].numpy(), ref)
        assert not feats[b, n_ref:].any()         # padding frames are zero


@pytest.mark.parametrize("feature,n", [("fbank", 1200), ("mfcc", 150)])
def test_short_clips_match_the_numpy_oracle(feature, n):
    """Clips under the 9-frame delta window (fbank: the head fit of the
    oracle's edge-pad-and-trim) and of at most n_fft // 2 samples (MFCC:
    the oracle's constant padding)."""
    sr = 22050
    x = np.random.default_rng(2).normal(0, 0.2, n).astype(np.float32)
    batch = np.zeros((1, sr), np.float32)
    batch[0, :n] = x
    fe = DeviceFrontend(feature, sr=sr, max_samples=sr, device="cpu")
    feats, nf = fe(torch.as_tensor(batch), torch.as_tensor([n]))
    ref, n_ref = _oracle_extract(feature)(x, sr)
    assert int(nf[0]) == n_ref
    _assert_close(feats[0, :n_ref].numpy(), ref)
