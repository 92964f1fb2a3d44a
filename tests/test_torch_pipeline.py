"""The port's input pipeline against the JAX package's on a rendered FLAC
corpus in LibriSpeech's layout: every macro batch equal, array for array
and bit for bit (tolerance 0), across worker counts, audio-width buckets,
both feed modes and microbatching; ``order_by_duration`` and
``shard_for_host`` equal too."""

import numpy as np
import pytest

from rnn_speech_tpu import corpus as jcorpus
from rnn_speech_tpu.charmap import get_char_map as jchar_map
from rnn_speech_tpu.train import pipeline as jpipe
from rnn_speech_tpu_torch import audio_io as taudio
from rnn_speech_tpu_torch import synth
from rnn_speech_tpu_torch.charmap import get_char_map as tchar_map
from rnn_speech_tpu_torch.runtime import loader
from rnn_speech_tpu_torch.train import pipeline as tpipe

SR = 16000    # LibriSpeech's rate: the pipeline resamples to 22050 Hz


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Seven clips of ~0.3-0.9 s rendered by the port's synth and FLAC
    encoder, one of them unreadable (the pipeline skips it)."""
    root = tmp_path_factory.mktemp("pipe")
    rng = np.random.default_rng(0)
    texts = synth.sample_sentences(7, rng)
    sigs = []
    for i, text in enumerate(texts):
        clean = synth.render_syllables_clean(text, SR, rng)[: 5000 + 1500 * i]
        sigs.append(np.clip(clean + rng.normal(0, 300, len(clean)), -32000,
                            32000).astype(np.int16))
    chapter = synth.write_corpus(str(root), texts, sigs, SR)
    with open(f"{chapter}/1-2-0003.flac", "r+b") as fh:    # corrupt one frame
        fh.seek(200)
        fh.write(b"\xff" * 64)
    data = jcorpus.DataProcessor(str(root / "demo")).get_dataset()
    return sorted(data)


def _cfg(module, **kw):
    base = dict(batch_size=2, max_input_seq_length=80, max_target_seq_length=40,
                use_native_loader=True)
    base.update(kw)
    return module.PipelineConfig(**base)


CASES = [
    dict(num_workers=0, bucket_count=1, on_device_frontend=True, mini_batch_size=1),
    dict(num_workers=0, bucket_count=8, on_device_frontend=True, mini_batch_size=3),
    dict(num_workers=2, bucket_count=8, on_device_frontend=True, mini_batch_size=2),
    dict(num_workers=0, bucket_count=1, on_device_frontend=False, mini_batch_size=2),
    dict(num_workers=2, bucket_count=8, on_device_frontend=False, mini_batch_size=1),
]


@pytest.mark.parametrize("kw", CASES, ids=[
    "w{num_workers}-b{bucket_count}-{fe}-mb{mini_batch_size}".format(
        fe="audio" if c["on_device_frontend"] else "features", **c) for c in CASES])
def test_batches_equal_to_jax(dataset, kw):
    got = list(tpipe.InputPipeline(dataset, tchar_map("english"), _cfg(tpipe, **kw)))
    ref = list(jpipe.InputPipeline(dataset, jchar_map("english"), _cfg(jpipe, **kw)))
    assert len(got) == len(ref) >= 1
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for key in r:
            assert g[key].dtype == r[key].dtype and g[key].shape == r[key].shape, key
            assert g[key].tobytes() == r[key].tobytes(), key
    lengths = np.concatenate([b["label_lengths"].ravel() for b in got])
    assert (lengths > 0).sum() == len(dataset) - 1     # the corrupt clip is skipped
    empty = tpipe.InputPipeline([], tchar_map("english"), _cfg(tpipe, **kw)).empty_batch()
    jempty = jpipe.InputPipeline([], jchar_map("english"), _cfg(jpipe, **kw)).empty_batch()
    for key in jempty:
        assert empty[key].tobytes() == jempty[key].tobytes(), key


def test_max_samples_equal_to_jax():
    for T in (1, 80, 3510):
        assert _cfg(tpipe, max_input_seq_length=T).max_samples == \
            _cfg(jpipe, max_input_seq_length=T).max_samples


def test_native_loader_in_order_over_the_dataset(dataset):
    """The native loader over the corpus (2 threads, capacity 2): every clip
    in the dataset's order, the corrupt one reported by its rc; at the
    corpus's rate each clip equals ``audio_io.load`` bit for bit (tolerance
    0), and resampled to 22.05 kHz it has ``load``'s length and stays within
    max 5e-2, mean 1e-2 of it away from the filter edges."""
    paths = [item[0] for item in dataset]
    for rate in (SR, 22050):
        with loader.NativeAudioLoader(paths, max_samples=1 << 20, target_rate=rate,
                                      n_threads=2, capacity=2) as ld:
            got = list(ld)
        assert [i for i, _, _ in got] == list(range(len(paths)))
        assert sum(rc != 0 for _, _, rc in got) == 1
        for (_, audio, rc), path in zip(got, paths):
            if rc:
                assert audio is None
                continue
            ref = taudio.load(path, sr=rate)[0]
            if rate == SR:
                assert audio.tobytes() == ref.tobytes()
                continue
            assert len(audio) == len(ref)
            err = np.abs(audio[200:-200] - ref[200:-200])
            assert err.max() < 5e-2 and err.mean() < 1e-2


def test_order_by_duration_and_shard_for_host_equal_to_jax():
    rng = np.random.default_rng(3)
    data = [[f"f{i}", "x", float(d)] for i, d in enumerate(rng.uniform(0.5, 9, 23))]
    for window in (None, 1, 4, 7, 100):
        assert tpipe.order_by_duration(data, window) == jpipe.order_by_duration(data, window)
    for index, count in ((0, 1), (0, 3), (2, 3), (1, 4)):
        assert tpipe.shard_for_host(data, index, count) == \
            jpipe.shard_for_host(data, index, count)
    # No torch.distributed group here: rank 0 of 1, the dataset unchanged.
    assert tpipe.shard_for_host(data) == jpipe.shard_for_host(data) == data
