"""Synthesize a LibriSpeech-layout corpus (no external data needed).

    python -m rnn_speech_tpu_torch.tools.make_demo_corpus --out DIR
        [--mode letters|syllables|tones] [--clips N] [--seconds S]
        [--sample_rate SR] [--seed S] [--noise_std X]

The port's counterpart of ``tools/make_demo_corpus.py``, with the same
flags, the same draws and byte-identical files (FLAC through
``runtime/flac_enc.py``, transcripts in ``1-2.trans.txt``):

  * ``--mode letters`` (default): an "audio font" in which every
    character is its own 90 ms tone (fundamental and harmonic, Hann
    envelope, a noise floor), so a model that learns the letter-to-sound
    mapping generalizes to sentences it never saw; ``--clips N`` draws N
    distinct word sentences (the corpus of ``accuracy_benchmark``).
  * ``--mode syllables``: the coarticulated formant font of
    ``synth.render_syllables_clean`` plus broadband noise of
    ``--noise_std`` (the font of ``flagship_accuracy_run``).
  * ``--mode tones``: up to 12 fixed transcripts, one tone mixture each.

Then point a config's ``training_dataset_dirs`` / ``test_dataset_dirs`` at
``DIR/demo`` and run ``python -m rnn_speech_tpu_torch.cli
--train_acoustic --config <ini>``.  Host-only: numpy, no device.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from rnn_speech_tpu_torch.synth import (  # noqa: F401 - the tool's surface
    CHAR_GAP_MS, CHAR_TONE_MS, SPACE_MS, WORDS, render_syllables_clean,
    sample_sentences, write_corpus,
)

DEFAULT_TEXTS = [
    "HELLO WORLD", "GOOD MORNING", "SPEECH TEST", "OPEN SOURCE",
    "TENSOR CHIP", "AUDIO CLIP", "FAST MODEL", "GREEN TEST",
    "NORTH STAR", "CLEAR VOICE", "QUICK BROWN FOX", "LAZY DOG",
]


def render_syllables(text: str, sr: int, rng,
                     noise_std: float = 900.0) -> np.ndarray:
    """Coarticulated syllables + additive broadband noise, as int16."""
    sig = render_syllables_clean(text, sr, rng)
    sig = sig + rng.normal(0, noise_std, len(sig))
    return np.clip(sig, -32000, 32000).astype(np.int16)


def render_letters(text: str, sr: int, rng) -> np.ndarray:
    """Audio-font rendering: per-character tones at systematic pitches."""
    tone_n = int(sr * CHAR_TONE_MS / 1000)
    gap_n = int(sr * CHAR_GAP_MS / 1000)
    space_n = int(sr * SPACE_MS / 1000)
    env = np.hanning(tone_n)
    pieces = []
    for ch in text:
        if ch == " ":
            pieces.append(np.zeros(space_n))
            continue
        idx = ord(ch) - ord("A")
        if not 0 <= idx < 26:
            continue
        f0 = 220.0 * (2.0 ** (idx / 12.0))      # a semitone scale
        t = np.arange(tone_n)
        tone = (
            np.sin(2 * np.pi * f0 * t / sr)
            + 0.4 * np.sin(2 * np.pi * 2 * f0 * t / sr)
        ) * env
        pieces.append(tone)
        pieces.append(np.zeros(gap_n))
    sig = np.concatenate(pieces) if pieces else np.zeros(space_n)
    sig = sig * 9000 + rng.normal(0, 300, len(sig))
    return sig.astype(np.int16)


def render_tones(n_texts: int, seconds: float, sr: int, rng) -> list:
    """``--mode tones``: one tone mixture a transcript, ``seconds`` long."""
    n = int(sr * seconds)
    t = np.arange(n)
    sigs = []
    for i in range(n_texts):
        f0 = 200.0 + 50.0 * i
        sigs.append((
            np.sin(2 * np.pi * f0 * t / sr) * 12000
            + np.sin(2 * np.pi * 2.1 * f0 * t / sr) * 4000
            + rng.normal(0, 500, n)
        ).astype(np.int16))
    return sigs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", required=True, help="Corpus root directory")
    parser.add_argument("--mode", choices=("letters", "syllables", "tones"),
                        default="letters")
    parser.add_argument("--clips", type=int, default=300,
                        help="letters: distinct sentences; tones: max %d"
                             % len(DEFAULT_TEXTS))
    parser.add_argument("--seconds", type=float, default=1.0,
                        help="tones mode clip duration (> 0.4: shorter "
                             "clips are dropped by the min-duration filter)")
    parser.add_argument("--sample_rate", type=int, default=16000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--noise_std", type=float, default=900.0,
                        help="syllables mode: additive broadband noise "
                             "sigma (int16 scale; signal peaks ~9000)")
    args = parser.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    sr = args.sample_rate

    t0 = time.perf_counter()
    if args.mode in ("letters", "syllables"):
        texts = sample_sentences(args.clips, rng)
        if args.mode == "letters":
            sigs = [render_letters(t, sr, rng) for t in texts]
        else:
            sigs = [render_syllables(t, sr, rng, noise_std=args.noise_std)
                    for t in texts]
    else:
        if args.seconds <= 0.4:
            parser.error(
                "--seconds must exceed 0.4: the corpus reader drops clips "
                "at or under 0.4 s (the reference's min-audio filter), "
                "which would leave an empty dataset"
            )
        texts = DEFAULT_TEXTS[: max(1, min(args.clips, len(DEFAULT_TEXTS)))]
        sigs = render_tones(len(texts), args.seconds, sr, rng)
    render_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    root = write_corpus(args.out, texts, sigs, sr)
    encode_s = time.perf_counter() - t0

    print(f"Wrote {len(texts)} clips to {root} "
          f"(render {render_s:.1f} s, FLAC encode {encode_s:.1f} s)")
    print(f"Point training_dataset_dirs/test_dataset_dirs at: "
          f"{os.path.join(args.out, 'demo')}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
