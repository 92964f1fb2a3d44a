"""Coarticulated-syllable audio font (numpy only).

The port's own copy of the held-out audio renderer of
``tools/make_demo_corpus.py``: ``render_syllables_clean``, its helpers,
the word list and ``sample_sentences``, verbatim.  ``chip_smoke.py``
renders clips with known transcripts from it without importing anything
outside the port; ``tests/test_torch_imports.py`` pins the copy to the
original byte for byte.
"""

from __future__ import annotations

import numpy as np

WORDS = [
    "THE", "AND", "CAT", "DOG", "SUN", "SKY", "RED", "BLUE", "BIRD",
    "TREE", "WIND", "RAIN", "STAR", "MOON", "FISH", "BOAT", "ROAD",
    "HILL", "SNOW", "FIRE", "GOLD", "IRON", "WOLF", "BEAR", "LAKE",
    "SAND", "ROCK", "LEAF", "SEED", "CORN", "MILK", "SALT", "WEST",
    "EAST", "DAWN", "DUSK", "SHIP", "DOOR", "GATE", "BELL",
]

CHAR_TONE_MS = 90          # per-character tone length
CHAR_GAP_MS = 20           # silence between characters (letters font)
SPACE_MS = 120             # silence for a word gap
COART_TRANS_MS = 50        # formant-glide span across character boundaries
WORD_FADE_MS = 15          # voicing onset/offset ramp at word edges
EDGE_PAD_MS = 60           # leading/trailing silence around the clip


def _syllable_formants(idx: int):
    """Distinct (F1, F2) target per character; the *7 stride decorrelates
    F2 from F1 so alphabet neighbors are not spectral neighbors."""
    return 320.0 + 58.0 * idx, 950.0 + 88.0 * ((idx * 7) % 26)


def _boxcar(track: np.ndarray, width: int) -> np.ndarray:
    """Moving-average smoothing (edge-replicated) — turns a piecewise-
    constant target track into linear glides of ``width`` samples."""
    width = max(int(width), 1)
    if width <= 1:
        return track
    padded = np.concatenate(
        [np.full(width // 2, track[0]), track,
         np.full(width - width // 2 - 1, track[-1])]
    )
    kernel = np.full(width, 1.0 / width)
    return np.convolve(padded, kernel, mode="valid")


def render_syllables_clean(text: str, sr: int, rng) -> np.ndarray:
    """Coarticulated formant audio font, float64 at ~9000 peak (no noise).

    Each character is a voiced vowel-like syllable — a harmonic series on
    a glottal fundamental, spectrally shaped by two character-dependent
    formant resonances.  Unlike the round-3 version (isolated 90 ms tones
    with 20 ms silence gaps — VERDICT r3 Weak #1: "no coarticulation, so
    the AM near-memorizes"), voicing is CONTINUOUS within a word and the
    identity cues smear across boundaries the way real speech does:

      * ONE glottal source runs through the whole word: the harmonic
        phases are continuous across characters (no envelope gap to
        segment on);
      * formant tracks GLIDE between adjacent characters' (F1, F2)
        targets over ~50 ms — each boundary region is a transition whose
        spectrum belongs to neither character alone;
      * f0 declines ~10% over the clip with mild vibrato on top of the
        per-clip pitch draw (0.85-1.2x), so absolute harmonic frequencies
        are non-informative;
      * per-character duration (0.75-1.3x) and amplitude jitter survive
        from round 3, so segmentation cannot rely on a fixed grid.

    A model must therefore learn pitch-invariant spectral-shape classes
    from transitional evidence under noise — the hardened accuracy-corpus
    task behind tools/flagship_accuracy_run.py.
    """
    tone_n0 = int(sr * CHAR_TONE_MS / 1000)
    space_n = int(sr * SPACE_MS / 1000)
    pad_n = int(sr * EDGE_PAD_MS / 1000)
    trans_n = max(int(sr * COART_TRANS_MS / 1000), 2)
    fade_n = max(int(sr * WORD_FADE_MS / 1000), 2)

    # Segment plan: (samples, F1, F2, level); silence carries level 0 and
    # placeholder formants (filled from the nearest voiced neighbor so
    # the glide has anchors everywhere).
    segs = [[pad_n, np.nan, np.nan, 0.0]]
    for ch in text:
        if ch == " ":
            segs.append([space_n, np.nan, np.nan, 0.0])
            continue
        idx = ord(ch) - ord("A")
        if not 0 <= idx < 26:
            continue
        F1, F2 = _syllable_formants(idx)
        n = int(tone_n0 * float(rng.uniform(0.75, 1.3)))
        segs.append([n, F1, F2, float(rng.uniform(0.7, 1.1))])
    segs.append([pad_n, np.nan, np.nan, 0.0])
    if all(s[3] == 0.0 for s in segs):
        return np.zeros(space_n + 2 * pad_n)

    # Piecewise-constant per-sample target tracks.
    f1_t = np.concatenate([np.full(n, F1) for n, F1, _, _ in segs])
    f2_t = np.concatenate([np.full(n, F2) for n, _, F2, _ in segs])
    lvl_t = np.concatenate([np.full(n, lv) for n, _, _, lv in segs])
    for track in (f1_t, f2_t):      # anchor silences: nearest voiced value
        idxs = np.arange(len(track))
        good = ~np.isnan(track)
        track[:] = np.interp(idxs, idxs[good], track[good])
    f1_t = _boxcar(f1_t, trans_n)   # formant glides across boundaries
    f2_t = _boxcar(f2_t, trans_n)
    lvl_t = _boxcar(lvl_t, 2 * fade_n)  # smooth onsets/offsets, no gaps

    n_total = len(lvl_t)
    tt = np.arange(n_total) / sr
    dur = n_total / sr
    f0 = 110.0 * float(rng.uniform(0.85, 1.2))     # per-clip pitch
    f0_t = f0 * (1.0 - 0.10 * tt / max(dur, 1e-6)) * (
        1.0 + 0.005 * np.sin(2 * np.pi * 5.0 * tt
                             + rng.uniform(0, 2 * np.pi))
    )
    phase = 2 * np.pi * np.cumsum(f0_t) / sr       # continuous source
    bw1, bw2 = 110.0, 160.0
    sig = np.zeros(n_total)
    k_max = min(int((sr * 0.45) // f0), 40)
    for k in range(1, k_max + 1):
        amp = (
            np.exp(-0.5 * ((k * f0_t - f1_t) / bw1) ** 2)
            + 0.7 * np.exp(-0.5 * ((k * f0_t - f2_t) / bw2) ** 2)
        )
        if amp.max() < 1e-3:
            continue
        # Random phase offset per harmonic: waveform shape varies even at
        # the same pitch and character sequence.
        sig += amp * np.sin(k * phase + rng.uniform(0, 2 * np.pi))
    peak = np.abs(sig).max() or 1.0
    return sig / peak * 9000.0 * lvl_t


def sample_sentences(n: int, rng) -> list:
    """n distinct sentences of 2-5 vocabulary words."""
    out, seen = [], set()
    while len(out) < n:
        k = int(rng.integers(2, 6))
        words = tuple(rng.choice(WORDS, size=k, replace=True))
        if words in seen:
            continue
        seen.add(words)
        out.append(" ".join(words))
    return out
