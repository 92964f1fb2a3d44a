"""The port's native host runtime (``rnn_speech_tpu_torch/runtime/``: the
C++ FLAC decoder and async loader, their build and bindings) against the
JAX package's pure-Python paths, on the CPU.

The references never touch the JAX package's native library: FLAC goes
through its ``flac_py``, the JAX pipeline and CLI run with that library
reported missing (their own fallback), and WAV and SPHERE are parsed in
Python.  Each test states its tolerance; with no resampling the decoders
agree bit for bit, and resampled output keeps the bounds of the JAX
package's ``tests/test_native_loader.py``."""

import ctypes
import logging
import os
import struct
import subprocess
import sys

import numpy as np
import pytest

from rnn_speech_tpu import audio_io as jaudio
from rnn_speech_tpu import cli as jcli
from rnn_speech_tpu.charmap import get_char_map as jchar_map
from rnn_speech_tpu.runtime import audiodec as jaudiodec
from rnn_speech_tpu.runtime import flac_py as jflac
from rnn_speech_tpu.runtime import loader as jloader
from rnn_speech_tpu.train import pipeline as jpipe
from rnn_speech_tpu_torch import audio_io as taudio
from rnn_speech_tpu_torch import cli as tcli
from rnn_speech_tpu_torch import corpus as tcorpus
from rnn_speech_tpu_torch import synth
from rnn_speech_tpu_torch.charmap import get_char_map as tchar_map
from rnn_speech_tpu_torch.runtime import audiodec, flac_enc, flac_py, native_build
from rnn_speech_tpu_torch.runtime import loader
from rnn_speech_tpu_torch.train import pipeline as tpipe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def jax_python_decode(monkeypatch):
    """The JAX package with its native library reported missing: its FLAC
    decode falls back to ``flac_py`` and its pipeline and CLI to their
    Python paths."""
    monkeypatch.setattr(jaudiodec, "get_native_lib", lambda: None)
    monkeypatch.setattr(jloader, "available", lambda: False)


def _jax_load(path, sr=22050):
    """The JAX package's ``audio_io.load`` with FLAC through its ``flac_py``."""
    with open(path, "rb") as fh:
        flac = fh.read(4) == b"fLaC"
    data, rate = jflac.decode_flac(path) if flac else jaudio.decode_audio(path)
    out = jaudio.to_mono(data)
    if sr is not None and sr != rate:
        out = jaudio.resample(out, rate, sr)
    return np.ascontiguousarray(out, dtype=np.float32)


def _pcm(n, channels, bits, seed):
    """Rendered speech-like int PCM at ``bits`` (a synth sentence, plus
    noise on the second channel), (n, channels)."""
    rng = np.random.default_rng(seed)
    clean = synth.render_syllables_clean(synth.sample_sentences(1, rng)[0], 16000, rng)
    clean = np.resize(clean, n)
    cols = [clean, 0.5 * clean + rng.normal(0, 400, n)][:channels]
    pcm = np.stack(cols, axis=1) * (2.0 ** (bits - 16))
    lim = 2 ** (bits - 1) - 1
    return np.clip(np.round(pcm), -lim, lim).astype(np.int64)


# ------------------------------------------------------------------ decoder

@pytest.mark.parametrize("bits", [8, 16, 24])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("blocksize,subframe", [(256, "fixed2"), (1152, "fixed2"),
                                                (4096, "fixed2"), (1024, "verbatim")])
def test_native_decode_bit_equal_to_flac_py(tmp_path, bits, channels, blocksize, subframe):
    """Tolerance 0: the native decoder's float32 samples and rate equal the
    port's and the JAX package's ``flac_py``, through ``audio_io`` too."""
    pcm = _pcm(5000, channels, bits, seed=bits * 10 + channels)
    path = str(tmp_path / "t.flac")
    flac_enc.encode_flac(path, pcm, 16000, bits_per_sample=bits, blocksize=blocksize,
                         subframe=subframe)
    got, rate = audiodec.decode_flac(path)
    ref, ref_rate = flac_py.decode_flac(path)
    jref, jrate = jflac.decode_flac(path)
    assert rate == ref_rate == jrate == 16000
    assert got.dtype == np.float32 and got.shape == (len(pcm), channels)
    assert got.tobytes() == ref.tobytes() == jref.tobytes()
    assert taudio.read_flac(path)[0].tobytes() == got.tobytes()
    np.testing.assert_array_equal(np.round(got * 2.0 ** (bits - 1)), pcm)


def test_native_decode_bit_equal_on_synth_corpus(tmp_path):
    """Tolerance 0 on the port's rendered corpus (``synth.write_corpus``)."""
    rng = np.random.default_rng(4)
    texts = synth.sample_sentences(4, rng)
    sigs = [np.clip(synth.render_syllables_clean(t, 16000, rng)
                    + rng.normal(0, 300), -32000, 32000).astype(np.int16) for t in texts]
    chapter = synth.write_corpus(str(tmp_path), texts, sigs, 16000)
    for i, sig in enumerate(sigs):
        path = os.path.join(chapter, f"1-2-{i:04d}.flac")
        got, _ = audiodec.decode_flac(path)
        assert got.tobytes() == jflac.decode_flac(path)[0].tobytes()
        np.testing.assert_array_equal(np.round(got[:, 0] * 32768.0), sig)


def test_native_decode_rejects_corrupt_streams(tmp_path):
    """A file that is not a FLAC stream, a zeroed stream and one cut in
    the middle of its frames raise ``ValueError`` naming the decoder's
    code; a stream of STREAMINFO alone decodes to no samples, as in
    ``flac_py``."""
    path = str(tmp_path / "c.flac")
    flac_enc.encode_flac(path, _pcm(4000, 1, 16, seed=1)[:, 0], 16000)
    data = open(path, "rb").read()
    cases = {"junk.flac": b"JUNK" * 16, "zero.flac": b"fLaC" + bytes(64),
             "cut.flac": data[: len(data) // 2]}
    for name, body in cases.items():
        bad = str(tmp_path / name)
        open(bad, "wb").write(body)
        with pytest.raises(ValueError, match="FLAC decode failed"):
            audiodec.decode_flac(bad)
    open(path, "wb").write(data[:42])
    got, rate = audiodec.decode_flac(path)
    assert got.shape == flac_py.decode_flac(path)[0].shape == (0, 1) and rate == 16000


# ------------------------------------------------------------------- loader

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The four files of the JAX package's loader tests: a 22.05 kHz WAV,
    a 16 kHz FLAC, a stereo WAV and a SPHERE file."""
    root = tmp_path_factory.mktemp("native_runtime")
    rng = np.random.default_rng(0)
    paths = []
    wav = str(root / "a.wav")
    taudio.write_wav(wav, (rng.normal(0, 0.2, 22050) * 20000).astype(np.int16), 22050)
    paths.append(wav)
    flac = str(root / "b.flac")
    flac_enc.encode_flac(flac, (rng.normal(0, 0.2, 16000) * 20000).astype(np.int16), 16000)
    paths.append(flac)
    stereo = str(root / "c.wav")
    taudio.write_wav(stereo, (rng.normal(0, 0.2, (8000, 2)) * 20000).astype(np.int16), 22050)
    paths.append(stereo)
    sph = str(root / "d.sph")
    pcm = (rng.normal(0, 0.2, 16000) * 20000).astype(np.int16)
    header = ("NIST_1A\n    1024\n"
              "channel_count -i 1\nsample_rate -i 22050\nsample_n_bytes -i 2\n"
              f"sample_count -i {len(pcm)}\nsample_byte_format -s2 01\n"
              "sample_coding -s3 pcm\nend_head\n").encode().ljust(1024, b" ")
    with open(sph, "wb") as fh:
        fh.write(header + pcm.astype("<i2").tobytes())
    paths.append(sph)
    return paths


def _load_one(path, sr=22050, n_threads=1):
    with loader.NativeAudioLoader([path], max_samples=1 << 20, target_rate=sr,
                                  n_threads=n_threads) as ld:
        return next(ld)


def test_loader_matches_python_path_no_resample(corpus):
    """Files already at the target rate: atol 1e-6 against the JAX
    package's Python load (downmix included)."""
    checked = 0
    for path in corpus:
        if path.endswith(".flac"):
            continue
        _, audio, rc = _load_one(path, n_threads=2)
        assert rc == 0
        np.testing.assert_allclose(audio, _jax_load(path), atol=1e-6)
        checked += 1
    assert checked == 3


def test_loader_resample_exact_vs_python_path(tmp_path):
    """White noise at 16, 48 and 8 kHz to 22.05 kHz: the same length and
    atol 2e-6 against the JAX package's Python polyphase resampler."""
    rng = np.random.default_rng(3)
    for sr_in in (16000, 48000, 8000):
        wav = str(tmp_path / f"noise{sr_in}.wav")
        taudio.write_wav(wav, (0.5 * rng.normal(size=sr_in)).astype(np.float32), sr_in)
        ref = _jax_load(wav)
        _, audio, rc = _load_one(wav)
        assert rc == 0 and len(audio) == len(ref)
        np.testing.assert_allclose(audio, ref, atol=2e-6)


def test_loader_resample_close_to_python_path(corpus, tmp_path):
    """16 kHz -> 22.05 kHz away from the filter edges (200 samples): a
    tone mix within max 5e-3, mean 1e-3; the noise FLAC within max 5e-2,
    mean 1e-2."""
    t = np.arange(16000) / 16000.0
    tone = sum(np.sin(2 * np.pi * f * t + f) for f in (220.0, 880.0, 2500.0))
    wav = str(tmp_path / "tone.wav")
    taudio.write_wav(wav, (tone / 4.0).astype(np.float32), 16000)
    for path, (max_tol, mean_tol) in ((wav, (5e-3, 1e-3)), (corpus[1], (5e-2, 1e-2))):
        ref = _jax_load(path)
        _, audio, rc = _load_one(path)
        assert rc == 0 and abs(len(audio) - len(ref)) <= 2
        n = min(len(audio), len(ref))
        err = np.abs(audio[200: n - 200] - ref[200: n - 200])
        assert err.max() < max_tol and err.mean() < mean_tol


def test_loader_order_and_truncation(corpus):
    """Delivery in submission order with 3 threads and capacity 2, every
    clip truncated to max_samples (1000) and equal to its own load's head
    (tolerance 0)."""
    order = corpus[::-1]
    with loader.NativeAudioLoader(order, max_samples=1000, target_rate=22050,
                                  n_threads=3, capacity=2) as ld:
        got = list(ld)
    assert [i for i, _, _ in got] == list(range(len(order)))
    assert all(rc == 0 and len(a) == 1000 for _, a, rc in got)
    for (_, audio, _), path in zip(got, order):
        assert audio.tobytes() == _load_one(path)[1][:1000].tobytes()


def test_loader_bad_file_reports_nonzero_rc(corpus, tmp_path):
    bad = str(tmp_path / "bad.wav")
    with open(bad, "wb") as fh:
        fh.write(b"RIFFgarbage")
    missing = str(tmp_path / "missing.flac")
    with loader.NativeAudioLoader([corpus[0], bad, missing], max_samples=1 << 20,
                                  target_rate=22050, n_threads=2) as ld:
        results = list(ld)
    assert results[0][2] == 0
    assert results[1][2] != 0 and results[1][1] is None
    assert results[2][2] != 0 and results[2][1] is None


def test_loader_float_wav_rejected(tmp_path):
    """Non-PCM WAV (IEEE float format tag) reports a decode error, not
    silence."""
    bad = str(tmp_path / "float.wav")
    data = np.zeros(1000, np.float32).tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
    fmt = b"fmt " + struct.pack("<IHHIIHH", 16, 3, 1, 22050, 22050 * 4, 4, 32)
    with open(bad, "wb") as fh:
        fh.write(hdr + fmt + b"data" + struct.pack("<I", len(data)) + data)
    _, audio, rc = _load_one(bad)
    assert rc != 0 and audio is None


def test_loader_large_list_lazy_submission(corpus):
    """Submission stays within the window (2 x capacity + threads) of the
    items delivered for the whole iteration, not just at startup."""
    paths = list(corpus) * 50
    with loader.NativeAudioLoader(paths, max_samples=1 << 20, target_rate=22050,
                                  n_threads=2, capacity=4) as ld:
        assert ld._submitted <= 2 * 4 + 4
        got = 0
        for _, _, rc in ld:
            got += rc == 0
            assert ld._submitted - ld._delivered <= 2 * 4 + 4
    assert got == len(paths)


def test_loader_non_consecutive_submit_indices(corpus):
    """Delivery follows submission order over arbitrary unique indices, not
    indices consecutive from 0 (bounded drain: a regression fails, it does
    not hang)."""
    lib = loader._bind(audiodec.get_native_lib())
    handle = lib.rst_loader_create(1, 1 << 20, 22050, 8)
    try:
        for idx in (5, 2, 40):
            lib.rst_loader_submit(handle, idx, corpus[0].encode())
        lib.rst_loader_close(handle)
        buf = np.empty((1 << 20,), np.float32)
        seen = []
        for _ in range(4):
            index, n = ctypes.c_int64(), ctypes.c_int64()
            rc = lib.rst_loader_next(handle, ctypes.byref(index),
                                     buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                     1 << 20, ctypes.byref(n))
            if rc == -1:
                break
            assert rc == 0 and n.value > 0
            seen.append(index.value)
        assert seen == [5, 2, 40]
    finally:
        lib.rst_loader_destroy(handle)


def test_loader_fuzz_no_crashes(tmp_path):
    """Mutated and truncated WAV and FLAC containers each answer (decoded
    or rc != 0): none crashes a worker thread or wedges the queue."""
    rng = np.random.default_rng(0)
    bases = {"w": str(tmp_path / "b.wav"), "f": str(tmp_path / "b.flac")}
    taudio.write_wav(bases["w"], (rng.normal(0, 0.2, 2000) * 20000).astype(np.int16), 16000)
    flac_enc.encode_flac(bases["f"], (rng.normal(0, 0.2, 2000) * 20000).astype(np.int16),
                         16000)
    paths = []
    for tag, base in bases.items():
        data = bytearray(open(base, "rb").read())
        for i in range(25):
            mutated = bytearray(data)
            for _ in range(rng.integers(1, 8)):
                mutated[rng.integers(0, len(mutated))] = rng.integers(0, 256)
            paths.append(str(tmp_path / f"{tag}{i}.bin"))
            open(paths[-1], "wb").write(bytes(mutated))
        for i in range(10):
            paths.append(str(tmp_path / f"{tag}t{i}.bin"))
            open(paths[-1], "wb").write(bytes(data[: rng.integers(1, len(data))]))
    with loader.NativeAudioLoader(paths, max_samples=1 << 15, target_rate=22050,
                                  n_threads=4) as ld:
        results = list(ld)
    assert [i for i, _, _ in results] == list(range(len(paths)))
    assert all((rc == 0) == (a is not None) for _, a, rc in results)


# ----------------------------------------------------------------- pipeline

@pytest.fixture(scope="module")
def flac_dataset(tmp_path_factory):
    """Seven 16 kHz FLAC clips of ~0.3-0.9 s in LibriSpeech's layout, one
    of them corrupt (skipped by every path)."""
    root = tmp_path_factory.mktemp("native_pipe")
    rng = np.random.default_rng(0)
    texts = synth.sample_sentences(7, rng)
    sigs = []
    for i, text in enumerate(texts):
        clean = synth.render_syllables_clean(text, 16000, rng)[: 5000 + 1500 * i]
        sigs.append(np.clip(clean + rng.normal(0, 300, len(clean)), -32000,
                            32000).astype(np.int16))
    chapter = synth.write_corpus(str(root), texts, sigs, 16000)
    with open(f"{chapter}/1-2-0003.flac", "r+b") as fh:
        fh.seek(200)
        fh.write(b"\xff" * 64)
    return sorted(tcorpus.DataProcessor(str(root / "demo")).get_dataset())


def _pipe_cfg(module, **kw):
    base = dict(batch_size=2, max_input_seq_length=80, max_target_seq_length=40,
                bucket_count=8, mini_batch_size=2)
    base.update(kw)
    return module.PipelineConfig(**base)


@pytest.mark.parametrize("rate", [16000, 22050])
def test_native_pipeline_close_to_jax_python_path(flac_dataset, jax_python_decode, rate):
    """The port's native pipeline (2 threads) against the JAX pipeline's
    Python path (its decode workers' code, inline): labels, lengths and
    shapes equal; audio bit-equal where no resampling happens (target
    16 kHz) and within max 5e-2, mean 1e-2 away from the filter edges where
    16 kHz is resampled to 22.05 kHz (the bounds of the JAX package's
    loader-pipeline test)."""
    before = tpipe.native_batches
    got = list(tpipe.InputPipeline(flac_dataset, tchar_map("english"), _pipe_cfg(
        tpipe, num_workers=2, sample_rate=rate)))
    assert tpipe.native_batches - before == len(got)
    ref = list(jpipe.InputPipeline(flac_dataset, jchar_map("english"), _pipe_cfg(
        jpipe, num_workers=0, use_native_loader=False, sample_rate=rate)))
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for key in ("labels", "label_lengths", "audio_lengths"):
            assert g[key].tobytes() == r[key].tobytes(), key
        assert g["audio"].shape == r["audio"].shape and g["audio"].dtype == np.float32
        if rate == 16000:
            assert g["audio"].tobytes() == r["audio"].tobytes()
            continue
        for m, b in np.ndindex(*g["audio_lengths"].shape):
            n = int(g["audio_lengths"][m, b])
            if n > 400:
                err = np.abs(g["audio"][m, b, 200: n - 200] - r["audio"][m, b, 200: n - 200])
                assert err.max() < 5e-2 and err.mean() < 1e-2
    lengths = np.concatenate([b["label_lengths"].ravel() for b in got])
    assert (lengths > 0).sum() == len(flac_dataset) - 1


@pytest.mark.parametrize("kw", [dict(use_native_loader=False),
                                dict(on_device_frontend=False)],
                         ids=["pool-audio", "pool-features"])
def test_pool_pipeline_equal_to_jax_python_path(flac_dataset, jax_python_decode, kw):
    """Where the native loader does not apply (``use_native_loader`` off,
    or the host frontend) the port decodes in its process pool, FLAC
    natively and resampled in Python: bit-equal (tolerance 0) to the JAX
    pipeline's Python path."""
    before = tpipe.native_batches
    got = list(tpipe.InputPipeline(flac_dataset, tchar_map("english"),
                                   _pipe_cfg(tpipe, num_workers=2, **kw)))
    ref = list(jpipe.InputPipeline(flac_dataset, jchar_map("english"),
                                   _pipe_cfg(jpipe, num_workers=0, **kw)))
    assert tpipe.native_batches == before
    assert len(got) == len(ref) >= 1
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for key in r:
            assert g[key].tobytes() == r[key].tobytes(), key


# ---------------------------------------------------------------- --evaluate

EVAL_CONFIG = """
[acoustic_network_params]
num_layers : 2
hidden_size : 32
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
steps_per_evaluation : 100
checkpoint_dir : {root}/ckpt
[training]
training_dataset_dirs : {root}/corpus/demo
test_dataset_dirs : {root}/corpus/demo
max_input_seq_length : 150
max_target_seq_length : 40
tensorboard_dir : {root}/tb
[logging]
log_level : WARNING
[tpu]
compute_dtype : float32
bucket_count : 4
prefetch_depth : 0
"""


def test_evaluate_through_the_loader_prints_the_jax_cli_lines(tmp_path, jax_python_decode,
                                                               capsys, caplog):
    """``--evaluate`` on the CPU over six 16 kHz FLAC clips, one corrupt and
    one longer than max_input_seq_length: every clip comes through the
    native loader, both are skipped with the JAX CLI's warnings, and the
    WER and CER lines equal the JAX CLI's (its serial Python decode) on the
    same checkpoint."""
    rng = np.random.default_rng(11)
    texts = synth.sample_sentences(6, rng)
    sigs = []
    for i, text in enumerate(texts):
        clean = np.resize(synth.render_syllables_clean(text, 16000, rng),
                          40000 if i == 4 else 9000 + 1500 * i)
        sigs.append(np.clip(clean + rng.normal(0, 300, len(clean)), -32000,
                            32000).astype(np.int16))
    chapter = synth.write_corpus(str(tmp_path / "corpus"), texts, sigs, 16000)
    os.makedirs(tmp_path / "tb")
    cfg = str(tmp_path / "config.ini")
    open(cfg, "w").write(EVAL_CONFIG.format(root=tmp_path))
    assert tcli.main(["--train_acoustic", "--config", cfg, "--device", "cpu",
                      "--max_steps", "1"]) == 0
    with open(f"{chapter}/1-2-0001.flac", "r+b") as fh:
        fh.seek(200)
        fh.write(b"\xff" * 64)

    def evaluate(main, argv):
        """(the two result lines, the skip warnings up to their first ':')."""
        capsys.readouterr()
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            assert main(argv + ["--evaluate", "--config", cfg, "--beam_width", "1"]) == 0
        skipped = sorted(r.getMessage().split(":")[0] for r in caplog.records
                         if "Skipping" in r.getMessage() or "too long" in r.getMessage())
        return capsys.readouterr().out.strip().splitlines()[-2:], skipped

    before = loader.delivered
    got, got_skipped = evaluate(tcli.main, ["--device", "cpu"])
    assert loader.delivered - before == len(texts)
    ref, ref_skipped = evaluate(jcli.main, [])
    assert got_skipped == ref_skipped == sorted(
        [f"Skipping unreadable {chapter}/1-2-0001.flac", "Warning - sample too long "])
    assert got == ref
    assert got[0].startswith("Resulting WER : ") and got[1].startswith("Resulting CER : ")


# ------------------------------------------------------------- no fallback

def test_no_fallback_when_the_library_cannot_be_built(tmp_path, monkeypatch, flac_dataset):
    """With ``$CXX`` a missing compiler and a fresh build directory, the
    decoder, the loader and the native pipeline each raise
    ``RuntimeError`` naming the build, and nothing decodes in Python or in
    the process pool in their place."""
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-c++"))
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "fresh")
    monkeypatch.setattr(native_build, "_lib", None)

    def python_decode(*args, **kw):
        raise AssertionError("decoded in Python")

    monkeypatch.setattr(flac_py, "decode_flac", python_decode)
    monkeypatch.setattr(tpipe, "_process_item", python_decode)
    path = flac_dataset[0][0]
    with pytest.raises(RuntimeError, match="host runtime build failed"):
        audiodec.decode_flac(path)
    with pytest.raises(RuntimeError, match="host runtime build failed"):
        taudio.load(path)
    with pytest.raises(RuntimeError, match="host runtime build failed"):
        loader.NativeAudioLoader([path], max_samples=1000, target_rate=22050)
    with pytest.raises(RuntimeError, match="host runtime build failed"):
        list(tpipe.InputPipeline(flac_dataset, tchar_map("english"),
                                 _pipe_cfg(tpipe, num_workers=2)))
    assert not list((tmp_path / "fresh").glob("*.so"))


def test_build_is_hash_named_and_reused(tmp_path, monkeypatch):
    """The library is named by a hash of the sources and flags, built once
    into the build directory (no temporary file left behind), and reused;
    the TSan variant has a name of its own."""
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path)
    plain, tsan = native_build.library_path(), native_build.library_path(tsan=True)
    assert plain != tsan and plain.parent == tmp_path
    assert plain.name.startswith("host_runtime-") and plain.suffix == ".so"
    assert native_build.build() == plain and plain.exists()
    stamp = plain.stat().st_mtime_ns
    assert native_build.build() == plain and plain.stat().st_mtime_ns == stamp
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        [plain.name, "host_runtime.lock"])


# --------------------------------------------------------------------- TSan

def test_tsan_harness_reports_no_race():
    """``python -m rnn_speech_tpu_torch.runtime.tsan_check`` (the loader
    under ThreadSanitizer) exits 0 with no sanitizer report, within 120 s."""
    env = {k: v for k, v in os.environ.items() if k != "LD_PRELOAD"}
    proc = subprocess.run([sys.executable, "-m", "rnn_speech_tpu_torch.runtime.tsan_check"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "WARNING: ThreadSanitizer" not in proc.stderr
    assert "TSAN HARNESS PASSED" in proc.stdout
