"""The port's DeviceFrontend (fbank-120 and MFCC-20) against the JAX
package's ``frontend_jax.DeviceFrontend`` on the CPU, same raw audio.

Tolerance: both run float32 matmuls at full precision (JAX at
Precision.HIGHEST) but sum the K shifted-view products and the DFT
columns in different orders.  The log-mel values (tens of dB) then agree
to about 1e-4 absolute, and the deltas, which difference neighbouring
frames, to the same; 2e-3 absolute leaves room for the rare frame whose
power is tiny and whose log is steep there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnn_speech_tpu.ops.frontend_jax import DeviceFrontend as JaxFrontend
from rnn_speech_tpu_torch.ops.frontend import DeviceFrontend

TOL = 2e-3
SR = 16000


def _batch(lengths, width, seed):
    rng = np.random.default_rng(seed)
    audio = np.zeros((len(lengths), width), np.float32)
    t = np.arange(width) / SR
    for i, n in enumerate(lengths):
        f0 = 150.0 + 40.0 * i
        sig = 0.3 * np.sin(2 * np.pi * f0 * t) + rng.normal(0, 0.05, width)
        audio[i, :n] = sig[:n]
    return audio, np.asarray(lengths, np.int32)


# Ragged rows: a zero-length row, a clip shorter than the 9-frame
# Savitzky-Golay window, and full-width rows.
CASES = {
    "ragged": ([8000, 0, 1500, 5200], 8000),
    "short": ([900, 1100], 2400),
}


@pytest.mark.parametrize("feature", ["fbank", "mfcc"])
@pytest.mark.parametrize("case", list(CASES))
def test_frontend_matches_jax(feature, case):
    lengths, width = CASES[case]
    audio, lens = _batch(lengths, width, seed=len(lengths))
    jfe = JaxFrontend(feature, sr=SR, max_samples=width)
    tfe = DeviceFrontend(feature, sr=SR, max_samples=width, device="cpu")
    ref, ref_nf = jfe(jnp.asarray(audio), jnp.asarray(lens))
    got, nf = tfe(torch.as_tensor(audio), torch.as_tensor(lens))
    np.testing.assert_array_equal(np.asarray(ref_nf), nf.numpy())
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=TOL)


@pytest.mark.parametrize("feature", ["fbank", "mfcc"])
def test_frame_counts_match_jax(feature):
    jfe = JaxFrontend(feature, sr=22050, max_samples=22050 * 4)
    tfe = DeviceFrontend(feature, sr=22050, max_samples=22050 * 4, device="cpu")
    n = np.asarray([0, 1, 550, 551, 552, 771, 22050, 22050 * 4, 22050 * 5],
                   np.int32)
    np.testing.assert_array_equal(
        np.asarray(jfe.num_frames_for(jnp.asarray(n))),
        tfe.num_frames_for(torch.as_tensor(n)).numpy(),
    )
    for width in (551, 4000, 22050 * 4):
        assert jfe._frames_for_width(width) == tfe._frames_for_width(width)
