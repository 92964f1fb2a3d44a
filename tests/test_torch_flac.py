"""The port's FLAC decoder and container probes against the JAX package's:
decoded samples equal bit for bit (tolerance 0), durations equal exactly,
and Ogg refused by both."""

import os

import numpy as np
import pytest

from rnn_speech_tpu import audio_io as jaudio
from rnn_speech_tpu.runtime import flac_enc as jenc
from rnn_speech_tpu.runtime import flac_py as jflac
from rnn_speech_tpu_torch import audio_io as taudio
from rnn_speech_tpu_torch import synth
from rnn_speech_tpu_torch.runtime import flac_enc as tenc
from rnn_speech_tpu_torch.runtime import flac_py as tflac

SR = 16000


def _pcm(channels, bits, seed, n=None):
    """Rendered speech-like int PCM at ``bits`` (a synth sentence, plus
    noise on the second channel), (n, channels)."""
    rng = np.random.default_rng(seed)
    text = synth.sample_sentences(1, rng)[0]
    clean = synth.render_syllables_clean(text, SR, rng)[: n or None]
    cols = [clean, 0.5 * clean + rng.normal(0, 400, len(clean))][:channels]
    pcm = np.stack(cols, axis=1) * (2.0 ** (bits - 16))
    lim = 2 ** (bits - 1) - 1
    return np.clip(np.round(pcm), -lim, lim).astype(np.int64)


@pytest.mark.parametrize("channels,bits,subframe", [
    (1, 16, "fixed2"), (2, 16, "fixed2"), (1, 24, "fixed2"), (2, 24, "fixed2"),
    (1, 16, "verbatim"), (2, 8, "fixed2"),
])
def test_flac_decode_bit_equal_to_jax(tmp_path, channels, bits, subframe):
    """A clip written by the port's encoder (which must write the same
    bytes as the JAX one) decodes to the same float32 samples and rate in
    both decoders, and through both ``audio_io.read_flac`` entry points."""
    pcm = _pcm(channels, bits, seed=channels * 100 + bits, n=3000)
    path, jpath = str(tmp_path / "t.flac"), str(tmp_path / "j.flac")
    tenc.encode_flac(path, pcm, SR, bits_per_sample=bits, subframe=subframe,
                     blocksize=1024)
    jenc.encode_flac(jpath, pcm, SR, bits_per_sample=bits, subframe=subframe,
                     blocksize=1024)
    assert open(path, "rb").read() == open(jpath, "rb").read()
    got, rate = tflac.decode_flac(path)
    ref, jrate = jflac.decode_flac(path)
    assert rate == jrate == SR and got.shape == (len(pcm), channels)
    assert got.dtype == ref.dtype == np.float32
    assert got.tobytes() == ref.tobytes()
    via_io, _ = taudio.read_flac(path)
    jvia_io, _ = jaudio.read_flac(path)
    assert via_io.tobytes() == jvia_io.tobytes() == ref.tobytes()
    np.testing.assert_array_equal(np.round(got * 2.0 ** (bits - 1)), pcm)


def test_flac_load_resamples_like_jax(tmp_path):
    """``load`` at 22050 Hz of a 16 kHz FLAC clip: same waveform."""
    path = str(tmp_path / "c.flac")
    tenc.encode_flac(path, _pcm(2, 16, seed=3, n=6000), SR)
    got, sr = taudio.load(path)
    ref, jsr = jaudio.load(path)
    assert sr == jsr == 22050 and got.tobytes() == ref.tobytes()


def _sphere(path, n, rate=16000):
    header = (b"NIST_1A\n    1024\nsample_rate -i %d\nchannel_count -i 1\n"
              b"sample_n_bytes -i 2\nsample_byte_format -s2 01\n"
              b"sample_count -i %d\nsample_coding -s3 pcm\nend_head\n" % (rate, n))
    with open(path, "wb") as fh:
        fh.write(header.ljust(1024, b" "))
        fh.write(np.arange(n, dtype="<i2").tobytes())


def _ogg(path, rate=22050, granule=44100):
    ident = b"\x01vorbis" + b"\0" * 4 + b"\x01" + rate.to_bytes(4, "little") + b"\0" * 16
    page = (b"OggS\0\x02" + granule.to_bytes(8, "little", signed=True)
            + b"\0" * 12 + ident)
    with open(path, "wb") as fh:
        fh.write(page)


def test_probe_duration_equal_to_jax(tmp_path):
    """WAV, FLAC and SPHERE durations from their headers, exactly the
    JAX package's; Ogg and unknown containers raise in both probes."""
    wav, flac, sph = (str(tmp_path / n) for n in ("a.wav", "b.flac", "c.sph"))
    taudio.write_wav(wav, np.zeros(12345, np.float32), 22050)
    tenc.encode_flac(flac, _pcm(1, 16, seed=5, n=23456), SR)
    _sphere(sph, 34567)
    for path in (wav, flac, sph):
        assert taudio.probe_duration(path) == jaudio.probe_duration(path)
    assert taudio.probe_duration(flac) == 23456 / SR
    ogg, junk = str(tmp_path / "d.ogg"), str(tmp_path / "e.bin")
    _ogg(ogg)
    open(junk, "wb").write(b"JUNK" * 8)
    assert taudio._probe_ogg_duration(ogg) == jaudio._probe_ogg_duration(ogg) == 2.0
    for path in (ogg, junk):
        with pytest.raises(jaudio.AudioFormatError):
            jaudio.probe_duration(path)
        with pytest.raises(taudio.AudioFormatError):
            taudio.probe_duration(path)


def test_sphere_segment_cut_equal_to_jax(tmp_path):
    sph = str(tmp_path / "s.sph")
    _sphere(sph, 32000)
    a, b = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    taudio.sphere_segment_to_wav(sph, a, 0.5, 1.25)
    jaudio.sphere_segment_to_wav(sph, b, 0.5, 1.25)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_corrupt_flac_raises(tmp_path):
    path = str(tmp_path / "bad.flac")
    tenc.encode_flac(path, _pcm(1, 16, seed=7, n=4000), SR)
    data = open(path, "rb").read()
    open(path, "wb").write(data[:60] + bytes(len(data) - 60))
    with pytest.raises((ValueError, EOFError)):
        taudio.decode_audio(path)
    assert os.path.getsize(path) == len(data)
