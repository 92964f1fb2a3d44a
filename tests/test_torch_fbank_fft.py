"""The fbank kernel's FFT design (``csrc/fbank.cu``) on the CPU: its host
tables (``ops/frontend_kernel.py``) and a torch model of its arithmetic.

* ``mel_ranges``: each filter's [lo, hi) holds exactly the non-zero bins
  of ``fbank_mel_matrix`` at 8, 16 and 22.05 kHz.
* ``fft_window``: the window recovered from ``DeviceFrontend._basis``
  (column 0, cos 0 = 1) equals ``np.hamming(frame_length)`` on its first
  L_eff = min(frame_length, 512) samples and is zero past them.
* A model of the kernel in complex64 torch, in its order: frames of 512
  samples times the window, z[n] = (x[2n], x[2n+1]), four radix-4
  Stockham passes with ``fft_tables``' twiddles, the split step with its
  split factors, the power, each filter summed over its range, the log
  with the float64-eps floor.  Against ``torch.fft.rfft`` (the oracle,
  in this test only) and against ``fbank_banks_plain`` (the plain
  version, the JAX package's matmul path) on rows with an empty one and a
  short one.

Tolerances: the model's spectrum against rfft, 1e-5 of the largest
magnitude (float32 butterflies over log4(256) = 4 passes: a few ulps);
the banks, ``FBANK_TOL`` = 2e-3 of the largest magnitude, the JAX
package's limit for its own kernel (float32 sums in another order); the
empty row's banks equal the eps floor exactly.
"""

import numpy as np
import pytest
import torch

from rnn_speech_tpu_torch import frontend as host
from rnn_speech_tpu_torch.ops import frontend_kernel as tfk
from rnn_speech_tpu_torch.ops.frontend import DeviceFrontend

FBANK_TOL = 2e-3


@pytest.mark.parametrize("sr", [8000, 16000, 22050])
def test_mel_ranges_hold_exactly_the_nonzero_bins(sr):
    mel = host.fbank_mel_matrix(sr).T                      # (bins, n_mels), as the frontend
    lo, hi = tfk.mel_ranges(mel)
    assert lo.dtype == hi.dtype == np.int32 and lo.shape == (mel.shape[1],)
    for m in range(mel.shape[1]):
        assert list(np.flatnonzero(mel[:, m])) == list(range(lo[m], hi[m]))


def test_mel_ranges_of_an_empty_filter():
    mel = np.zeros((9, 3))
    mel[2:5, 0] = 1.0
    mel[8, 2] = 0.5
    lo, hi = tfk.mel_ranges(mel)
    assert list(lo) == [2, 0, 8] and list(hi) == [5, 0, 9]


@pytest.mark.parametrize("sr", [8000, 16000, 22050])
def test_window_from_the_basis_is_the_hamming_window(sr):
    fe = DeviceFrontend("fbank", sr=sr, max_samples=sr, device="cpu")
    w = tfk.fft_window(fe._basis, fe.n_fft)
    l_eff = min(fe.frame_length, fe.n_fft)
    assert w.shape == (512,) and w.dtype == torch.float32
    np.testing.assert_array_equal(w[:l_eff].numpy(),
                                  np.hamming(fe.frame_length)[:l_eff].astype(np.float32))
    assert not w[l_eff:].any()


def _fft_model(frames):
    """(F, 512) float32 windowed frames -> (F, 257) complex64 spectrum, in
    the kernel's order."""
    tw, split = (torch.from_numpy(t) for t in tfk.fft_tables(512))
    x = frames.to(torch.float32)
    z = torch.complex(x[:, 0::2], x[:, 1::2])              # (F, 256)
    n, s, off = 256, 1, 0
    while n > 1:
        m = n // 4
        y = torch.empty_like(z)
        for beta in range(64):
            p, q = beta // s, beta % s
            a, b, c, d = (z[:, q + s * (p + j * m)] for j in range(4))
            apc, amc, bpd, jbmd = a + c, a - c, b + d, -1j * (b - d)
            w1, w2, w3 = tw[off + p]
            y[:, q + s * 4 * p] = apc + bpd
            y[:, q + s * (4 * p + 1)] = w1 * (amc + jbmd)
            y[:, q + s * (4 * p + 2)] = w2 * (apc - bpd)
            y[:, q + s * (4 * p + 3)] = w3 * (amc - jbmd)
        z, off, n, s = y, off + m, m, 4 * s
    k = torch.arange(257)
    zk, zc = z[:, k % 256], z[:, (256 - k) % 256].conj()
    return 0.5 * (zk + zc) - 0.5j * split[None] * (zk - zc)


def _banks_model(pre, basis, mel, step, n_frames):
    """The kernel's banks from the model's spectrum."""
    window = tfk.fft_window(basis, 512)
    pad = torch.nn.functional.pad(pre, (0, max(0, (n_frames - 1) * step + 512 - pre.shape[1])))
    frames = torch.stack([pad[:, t * step:t * step + 512] for t in range(n_frames)], dim=1)
    B = pre.shape[0]
    spec = _fft_model((frames * window).reshape(-1, 512))
    power = (spec.real ** 2 + spec.imag ** 2) / 512
    lo, hi = tfk.mel_ranges(mel.numpy())
    banks = torch.stack([(power[:, lo[m]:hi[m]] * mel[lo[m]:hi[m], m]).sum(-1)
                         for m in range(mel.shape[1])], dim=-1)
    banks = torch.where(banks == 0.0, torch.full((), tfk.EPS), banks)
    return (10.0 * torch.log10(banks)).reshape(B, n_frames, -1)


def test_fft_model_matches_rfft():
    g = torch.Generator().manual_seed(4)
    frames = torch.randn((6, 512), generator=g)
    frames[1] = 0.0
    frames[2, 300:] = 0.0
    got = _fft_model(frames)
    ref = torch.fft.rfft(frames.double())
    err = float((got.to(torch.complex128) - ref).abs().max())
    assert err <= 1e-5 * float(ref.abs().max())
    assert torch.equal(got[1], torch.zeros_like(got[1]))


@pytest.mark.parametrize("sr", [16000, 22050])
def test_banks_model_matches_the_plain_version(sr):
    """Rows: full, an empty one, a short one (fewer samples than a frame)
    and a ragged one, pre-emphasised with the padding zeroed."""
    width = sr // 2
    lengths = [width, 0, 300, width - 1234]
    g = torch.Generator().manual_seed(sr)
    t = torch.arange(width) / sr
    audio = 0.3 * torch.sin(2 * torch.pi * 220.0 * t)[None] + 0.05 * torch.randn(
        (len(lengths), width), generator=g)
    for i, n in enumerate(lengths):
        audio[i, n:] = 0.0
    pre = torch.cat([audio[:, :1], audio[:, 1:] - 0.97 * audio[:, :-1]], dim=1)
    fe = DeviceFrontend("fbank", sr=sr, max_samples=width, device="cpu")
    n_frames = fe._frames_for_width(width)
    got = _banks_model(pre, fe._basis, fe._mel, fe.frame_step, n_frames)
    ref = tfk.fbank_banks_plain(pre, fe._basis, fe._mel, fe.frame_step, n_frames, fe.n_fft)
    assert got.shape == ref.shape == (len(lengths), n_frames, 40)
    assert bool(torch.isfinite(got).all())
    assert float((got - ref).abs().max()) <= FBANK_TOL * float(ref.abs().max())
    floor = torch.full_like(got[1], 10.0 * np.log10(tfk.EPS))
    assert torch.equal(got[1], floor) and torch.equal(ref[1], floor)
