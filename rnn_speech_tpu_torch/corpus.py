"""Corpus readers: LibriSpeech, Shtooka, Vystadial_2013, TED-LIUM.

The port's own copy of ``rnn_speech_tpu/corpus.py``: auto-detection of
the dataset layout by marker file, directory walking into ``[audio_file,
cleaned_label, duration]`` triples, durations from container-header probes
(WAV/FLAC/SPHERE; no audio frames are decoded) over a process pool for
large corpora, a pickled file-list cache keyed on the path list, and
filters for too-short labels and audio.  TED-LIUM ``.sph`` segments are
cut natively (NIST SPHERE is a 1024-byte ASCII header + PCM), with a
``sox`` subprocess only for encodings the parser does not handle.
"""

from __future__ import annotations

import logging
import os
import pickle
import subprocess
import time
from concurrent.futures import ProcessPoolExecutor
from typing import List, Optional, Sequence

from rnn_speech_tpu_torch import audio_io
from rnn_speech_tpu_torch.charmap import clean_label

logger = logging.getLogger(__name__)

DEFAULT_MIN_TEXT_LENGTH = 3     # chars; labels <= this are dropped
DEFAULT_MIN_AUDIO_LENGTH = 0.4  # seconds; clips <= this are dropped

Triple = List  # [audio_file: str, label: str, duration: Optional[float]]


def find_files(root: str, suffix: str) -> List[str]:
    out: List[str] = []
    for base, _, files in os.walk(root):
        out.extend(os.path.join(base, f) for f in files if f.endswith(suffix))
    return out


def detect_type(path: str) -> str:
    """Identify the corpus layout by its marker files."""
    if find_files(path, ".trn"):
        return "Vystadial_2013"
    if find_files(path, ".stm"):
        return "TEDLIUM"
    if find_files(path, "index.tags.txt"):
        return "Shtooka"
    if find_files(path, ".trans.txt"):
        return "LibriSpeech"
    return "Unrecognized"


# ------------------------------------------------------------------ readers

def read_librispeech(path: str) -> List[Triple]:
    """``<utt-id> TRANSCRIPT`` lines in ``*.trans.txt``, flac siblings."""
    out: List[Triple] = []
    for text_file in find_files(path, ".txt"):
        directory = os.path.dirname(text_file)
        with open(text_file, "r") as fh:
            for line in fh.read().split("\n"):
                head = line.split(" ")[0]
                if len(head) < 5:
                    # Not an utterance line; the reference stops the file here.
                    break
                audio = os.path.join(directory, head + ".flac")
                if os.path.exists(audio):
                    out.append([audio, clean_label(line.replace(head, "")), None])
    return out


def read_shtooka(path: str) -> List[Triple]:
    """``index.tags.txt`` INI files, one section per audio file."""
    import configparser

    out: List[Triple] = []
    for text_file in find_files(path, ".txt"):
        if not text_file.endswith("index.tags.txt"):
            continue
        cp = configparser.ConfigParser(comment_prefixes=("#", ";", "\\"))
        cp.read(text_file)
        root = text_file[: -len("index.tags.txt")]
        for section in cp.sections():
            audio = root + section
            if os.path.exists(audio):
                out.append([audio, clean_label(cp[section]["SWAC_TEXT"]), None])
    return out


def read_vystadial(path: str) -> List[Triple]:
    """``<file>.wav`` with sibling ``<file>.wav.trn`` transcript."""
    out: List[Triple] = []
    for wav in find_files(path, ".wav"):
        trn = wav + ".trn"
        if os.path.exists(trn):
            with open(trn, "r") as fh:
                out.append([wav, clean_label(fh.readline()), None])
    return out


def read_tedlium(path: str) -> List[Triple]:
    """``.stm`` segment files; segments are cut out of sibling ``.sph``."""
    out: List[Triple] = []
    for stm in find_files(path, ".stm"):
        with open(stm, "r") as fh:
            lines = fh.read().split("\n")
        for line in lines:
            if line == "":
                continue
            parts = line.split(" ", maxsplit=6)
            if len(parts) < 7:
                continue
            if parts[2] == "inter_segment_gap":
                continue
            if parts[6] == "ignore_time_segment_in_scoring":
                continue
            start, end = parts[3], parts[4]
            directory = os.path.split(stm)[0]
            sph = os.path.join(directory, "..", "sph", f"{parts[0]}.sph")
            wav = os.path.join(directory, "..", "sph", f"{parts[0]}_{start}.wav")
            ok = True
            if not os.path.exists(wav):
                ok = extract_segment_from_sph(sph, wav, float(start), float(end))
            if ok:
                out.append([wav, clean_label(parts[6]), None])
    return out


def extract_segment_from_sph(
    sph_file: str, wav_file: str, start: float, end: float
) -> bool:
    """Cut ``[start, end]`` seconds out of a SPHERE file into a WAV.

    Native first (header parse + PCM slice); falls back to ``sox`` for
    encodings we do not handle (e.g. shorten-compressed SPHERE).
    """
    try:
        audio_io.sphere_segment_to_wav(sph_file, wav_file, start, end)
        return True
    except (audio_io.AudioFormatError, OSError) as exc:
        logger.debug("Native SPHERE extraction failed (%s); trying sox", exc)
    try:
        subprocess.call(["sox", sph_file, wav_file, "trim", str(start), f"={end}"])
    except OSError as exc:
        logger.warning("Execution failed : %s", exc)
        return False
    return True


_READERS = {
    "LibriSpeech": read_librispeech,
    "Shtooka": read_shtooka,
    "Vystadial_2013": read_vystadial,
    "TEDLIUM": read_tedlium,
}


# -------------------------------------------------------------- duration scan

def _probe_duration(item: Triple) -> Triple:
    audio_file, text, _ = item
    try:
        length = audio_io.probe_duration(audio_file)
    except (audio_io.AudioFormatError, OSError):
        logger.warning("Audio file incorrect : %s", audio_file)
        length = 0
    return [audio_file, text, length]


def scan_durations(items: Sequence[Triple], workers: Optional[int] = None) -> List[Triple]:
    """Fill the duration slot of every triple via header probes.

    Header probing reads a few hundred bytes per file; for large corpora the
    cost is dominated by filesystem metadata, so a modest process pool is
    used (mirroring the reference's ``multiprocessing.Pool`` fan-out).
    """
    if len(items) < 256:
        return [_probe_duration(it) for it in items]
    import multiprocessing

    # Spawn (not fork): callers may hold a multithreaded CUDA runtime.
    with ProcessPoolExecutor(
        max_workers=workers, mp_context=multiprocessing.get_context("spawn")
    ) as pool:
        return list(pool.map(_probe_duration, items, chunksize=64))


# ---------------------------------------------------------------- DataProcessor

class DataProcessor:
    """Walks corpora into ``[audio_file, label, duration]`` triples.

    Same construction-time behavior as the reference: optional pickle cache
    keyed on the raw path list, duration scan, and min-size filtering.
    """

    def __init__(
        self,
        raw_data_paths: str,
        file_cache: Optional[str] = None,
        min_text_size: int = DEFAULT_MIN_TEXT_LENGTH,
        min_audio_size: float = DEFAULT_MIN_AUDIO_LENGTH,
    ):
        self.raw_data_paths = raw_data_paths.replace(" ", "").split(",")
        self.file_cache = file_cache
        self.min_text_size = min_text_size
        self.min_audio_size = min_audio_size

        cached = self._load_filelist()
        if cached is not None:
            logger.info("%s : using audio files list from cache", self.raw_data_paths)
            self.data = cached
        else:
            self.data = []
            for path in self.raw_data_paths:
                kind = detect_type(path)
                try:
                    reader = _READERS[kind]
                except KeyError:
                    raise ValueError(
                        f"Unknown training_dataset_type for path {path!r}"
                    ) from None
                self.data += reader(path)

            logger.info("Probing audio duration for %d files", len(self.data))
            t0 = time.time()
            self.data = scan_durations(self.data)
            logger.info("Duration scan took %.2fs", time.time() - t0)

            if self.file_cache is not None:
                self._save_filelist(self.data)

        if not self.data:
            raise ValueError(f"No data found in directories {self.raw_data_paths}")

        self.data = [d for d in self.data if len(d[1]) > self.min_text_size]
        self.data = [d for d in self.data if d[2] is not None and d[2] > self.min_audio_size]

    def get_dataset(self) -> List[Triple]:
        return self.data

    def _save_filelist(self, data: List[Triple]) -> None:
        with open(self.file_cache, "wb") as fh:
            pickle.dump([self.raw_data_paths, data], fh)

    def _load_filelist(self) -> Optional[List[Triple]]:
        if self.file_cache is None or not os.path.exists(self.file_cache):
            return None
        with open(self.file_cache, "rb") as fh:
            paths, data = pickle.load(fh)
        if paths == self.raw_data_paths:
            return data
        return None
