"""The port's corpus readers, ``DataProcessor`` and dataset split against
the JAX package's on the four layouts of ``tests/test_corpus.py`` (rebuilt
here): the same ``[audio_file, label, duration]`` triples, exactly."""

import os
import random

import numpy as np
import pytest

from rnn_speech_tpu import audio_io as jaudio
from rnn_speech_tpu import corpus as jcorpus
from rnn_speech_tpu.models.recognizer import SpeechRecognizer as JRecognizer
from rnn_speech_tpu_torch import audio_io as taudio
from rnn_speech_tpu_torch import corpus as tcorpus
from rnn_speech_tpu_torch.models.recognizer import SpeechRecognizer as TRecognizer
from rnn_speech_tpu_torch.runtime import flac_enc


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    pcm = (rng.normal(0, 0.05, 16000) * 32767).astype(np.int16)

    libri = root / "Libri" / "train-clean-100" / "19" / "198"
    libri.mkdir(parents=True)
    (libri / "19-198.trans.txt").write_text(
        "19-198-0000 NORTHANGER ABBEY\n"
        "19-198-0001 THIS LITTLE WORK...\n"
        "19-198-0002 NEITHER THE...\n"
    )
    flac_enc.encode_flac(str(libri / "19-198-0000.flac"), pcm, 16000)
    flac_enc.encode_flac(str(libri / "19-198-0001.flac"), pcm[:8000], 16000)

    shtooka = root / "Shtooka" / "flac"
    shtooka.mkdir(parents=True)
    (shtooka / "index.tags.txt").write_text(
        "\\Swac_Index_Tags\n\n[GLOBAL]\nSWAC_LANG = eng\n\n"
        "[eng - I_arose.flac]\nSWAC_TEXT = I arose\n\n"
        "[eng - I_ate.flac]\nSWAC_TEXT = I ate\n\n"
        "[eng - I_awoke.flac]\nSWAC_TEXT = I awoke\n"
    )
    flac_enc.encode_flac(str(shtooka / "eng - I_arose.flac"), pcm, 16000)
    flac_enc.encode_flac(str(shtooka / "eng - I_ate.flac"), pcm[:5000], 16000)

    vysta = root / "Vystadial_2013" / "data_voip_en" / "dev"
    vysta.mkdir(parents=True)
    wav_name = "jurcic-028-121024_234433_0013625_0013836.wav"
    taudio.write_wav(str(vysta / wav_name), pcm.astype(np.float32) / 32768.0, 16000)
    (vysta / (wav_name + ".trn")).write_text("ALRIGHT THANK YOU AND GOODBYE\n")
    (vysta / "no_audio.wav.trn").write_text("FILE WITH NO AUDIO...\n")
    taudio.write_wav(str(vysta / "short.wav"), np.zeros(4000, np.float32), 16000)
    (vysta / "short.wav.trn").write_text("TOO SHORT TO KEEP\n")
    taudio.write_wav(str(vysta / "tiny_label.wav"), np.zeros(16000, np.float32), 16000)
    (vysta / "tiny_label.wav.trn").write_text("OK\n")

    ted_stm = root / "TEDLIUM" / "test" / "stm"
    ted_sph = root / "TEDLIUM" / "test" / "sph"
    ted_stm.mkdir(parents=True)
    ted_sph.mkdir(parents=True)
    (ted_stm / "AimeeMullins_2009P.stm").write_text(
        "AimeeMullins_2009P 1 inter_segment_gap 0 17.82 <o,,unknown> "
        "ignore_time_segment_in_scoring\n"
        "AimeeMullins_2009P 1 AimeeMullins 0.5 1.5 <o,f0,female> "
        "i 'd like to share ...\n"
    )
    sph_pcm = (rng.normal(0, 0.05, 32000) * 32767).astype("<i2")
    header = (b"NIST_1A\n    1024\nsample_rate -i 16000\nchannel_count -i 1\n"
              b"sample_n_bytes -i 2\nsample_byte_format -s2 01\n"
              b"sample_count -i 32000\nsample_coding -s3 pcm\nend_head\n")
    with open(ted_sph / "AimeeMullins_2009P.sph", "wb") as fh:
        fh.write(header.ljust(1024, b" "))
        fh.write(sph_pcm.tobytes())
    return root


LAYOUTS = [("Libri", "LibriSpeech", "read_librispeech"),
           ("Shtooka", "Shtooka", "read_shtooka"),
           ("Vystadial_2013", "Vystadial_2013", "read_vystadial"),
           ("TEDLIUM", "TEDLIUM", "read_tedlium")]


@pytest.mark.parametrize("sub,kind,reader", LAYOUTS, ids=[l[1] for l in LAYOUTS])
def test_reader_triples_equal_to_jax(corpus_dir, sub, kind, reader):
    path = str(corpus_dir / sub)
    assert tcorpus.detect_type(path) == jcorpus.detect_type(path) == kind
    got = getattr(tcorpus, reader)(path)
    ref = getattr(jcorpus, reader)(path)
    assert got and sorted(got) == sorted(ref)
    assert tcorpus.scan_durations(got) == jcorpus.scan_durations(ref)


def test_detect_type_unrecognized(tmp_path):
    assert tcorpus.detect_type(str(tmp_path)) == jcorpus.detect_type(str(tmp_path)) \
        == "Unrecognized"
    with pytest.raises(ValueError):
        tcorpus.DataProcessor(str(tmp_path))


def test_tedlium_segment_cut_equal_to_jax(corpus_dir, tmp_path):
    sph = str(corpus_dir / "TEDLIUM" / "test" / "sph" / "AimeeMullins_2009P.sph")
    a, b = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    assert tcorpus.extract_segment_from_sph(sph, a, 0.5, 1.5)
    assert jcorpus.extract_segment_from_sph(sph, b, 0.5, 1.5)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert taudio.probe_duration(a) == jaudio.probe_duration(b) == 1.0


def test_dataprocessor_filters_and_cache_equal_to_jax(corpus_dir, tmp_path):
    """All four layouts at once (the filters drop the short clip, the
    two-char label and the missing files), then through the filelist
    cache: written by the port, read back by both."""
    paths = ",".join(str(corpus_dir / sub) for sub, _, _ in LAYOUTS)
    ref = jcorpus.DataProcessor(paths).get_dataset()
    cache = str(tmp_path / "filelist.cache")
    got = tcorpus.DataProcessor(paths, file_cache=cache).get_dataset()
    assert sorted(got) == sorted(ref)
    names = [os.path.basename(item[0]) for item in got]
    assert "short.wav" not in names and "tiny_label.wav" not in names
    assert os.path.exists(cache)
    assert tcorpus.DataProcessor(paths, file_cache=cache).get_dataset() == got
    assert jcorpus.DataProcessor(paths, file_cache=cache).get_dataset() == got
    strict = tcorpus.DataProcessor(paths, min_audio_size=0.9, min_text_size=8)
    assert sorted(strict.get_dataset()) == sorted(
        jcorpus.DataProcessor(paths, min_audio_size=0.9, min_text_size=8).get_dataset())


@pytest.mark.parametrize("kw", [dict(ordered=True), dict(train_frac=0.5),
                                dict(ordered=False), dict(test_dirs=True)],
                         ids=["ordered", "train_frac", "shuffled", "test_dirs"])
def test_load_acoustic_dataset_split_equal_to_jax(corpus_dir, kw):
    paths = ",".join(str(corpus_dir / sub) for sub in ("Libri", "Shtooka", "Vystadial_2013"))
    args = dict(ordered=kw.get("ordered", False), train_frac=kw.get("train_frac"),
                test_dataset_dirs=paths if kw.get("test_dirs") else None)
    random.seed(11)
    ref = JRecognizer.load_acoustic_dataset(paths, **args)
    random.seed(11)
    got = TRecognizer.load_acoustic_dataset(paths, **args)
    assert got == ref
    assert len(got[0]) >= 2


def test_recognizer_char_map():
    assert TRecognizer("english").get_char_map_length() == JRecognizer(
        "english").get_char_map_length() == 80
    with pytest.raises(ValueError):
        TRecognizer("klingon")
