"""Character maps and the text<->label codec.

The port's own copy of ``rnn_speech_tpu/charmap.py`` (host-only Python):
the same token inventory, greedy longest-match encoding, inverse decoding
with space re-insertion, and label cleaning, so label ids agree between
the two packages.

The codec tokenizes text against an 80-entry English map: 8 apostrophe
tokens, 18 double-letter tokens, a-z, A-Z (a capital letter marks a word
start; spaces are removed by capitalizing the next word's initial), a bare
apostrophe, and ``_`` as the end-of-sentence marker (the final map entry,
whose index also serves the CTC blank-adjacent EOS role in the reference
design).

This module is pure Python/numpy on purpose: encoding happens on the host
inside the data pipeline.  For device-side work we expose fixed-shape padded
label arrays (``encode_padded``), which is what the jit-compiled CTC loss
consumes.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

# Token inventory. Order matters: indices are the model's label ids.
_APOSTROPHE_TOKENS = ["'d", "'ll", "'m", "'nt", "'s", "s'", "'t", "'ve"]
_DOUBLE_LETTER_TOKENS = [
    "bb", "cc", "dd", "ee", "ff", "gg", "ii", "kk", "ll", "mm", "nn",
    "oo", "pp", "rr", "ss", "tt", "uu", "zz",
]
_LOWER = [chr(c) for c in range(ord("a"), ord("z") + 1)]
_UPPER = [chr(c) for c in range(ord("A"), ord("Z") + 1)]

ENGLISH_CHAR_MAP: List[str] = (
    _APOSTROPHE_TOKENS + _DOUBLE_LETTER_TOKENS + _LOWER + _UPPER + ["'", "_"]
)

_REMOVED_PUNCT = ".,?!:"
_SPACED_PUNCT = "-_"


def clean_label(text: str) -> str:
    """Normalize a transcript: lowercase, strip punctuation, squeeze spaces."""
    text = text.strip().lower()
    for ch in _REMOVED_PUNCT:
        text = text.replace(ch, "")
    for ch in _SPACED_PUNCT:
        text = text.replace(ch, " ")
    # Single collapse pass (two spaces -> one), matching observed behavior.
    text = text.replace("  ", " ")
    return text


class CharMap:
    """A token map plus the greedy multi-char codec.

    The lookup tables are precomputed dicts rather than repeated
    ``list.index`` scans, so host-side encoding of a large corpus is O(n).
    """

    def __init__(self, tokens: Sequence[str] = ENGLISH_CHAR_MAP):
        self.tokens: List[str] = list(tokens)
        self.eos_id: int = len(self.tokens) - 1
        # Exact-match index per window size. Multi-char windows are matched
        # case-insensitively; single chars are matched exactly (capitals map
        # to their own entries, encoding word starts).
        self._by3: Dict[str, int] = {}
        self._by2: Dict[str, int] = {}
        self._by1: Dict[str, int] = {}
        for idx, tok in enumerate(self.tokens):
            if len(tok) == 3:
                self._by3.setdefault(tok, idx)
            elif len(tok) == 2:
                self._by2.setdefault(tok, idx)
            elif len(tok) == 1:
                self._by1.setdefault(tok, idx)

    def __len__(self) -> int:
        return len(self.tokens)

    @property
    def num_labels(self) -> int:
        return len(self.tokens)

    # ---------------------------------------------------------------- encode

    @staticmethod
    def _despace_capitalize(text: str) -> str:
        """Drop spaces; the following word's initial becomes a capital."""
        out = []
        next_is_upper = True
        for ch in text:
            if ch == " ":
                next_is_upper = True
            elif next_is_upper:
                out.append(ch.upper())
                next_is_upper = False
            else:
                out.append(ch)
        return "".join(out)

    def encode(self, text: str, add_eos: bool = True) -> List[int]:
        """Greedy longest-match (3 then 2 then 1 chars) tokenization.

        Unknown characters abort the remainder of the string with a warning,
        mirroring the reference's contract for dirty transcripts.

        Deviation (deliberate): multi-char windows match EXACTLY except at
        string position 0, where the reference's case-folding is kept
        (util/dataprocessor.py:153-163 lowercases every window).  After
        despacing, capitals exist only at word starts, so the reference's
        ``.lower()`` makes a boundary like "that the" -> "ThatThe" match
        the "tt" token across the word seam — silently deleting the space
        from the label ("thatthe"); likewise "call Lloyd" loses Lloyd's
        capital.  At position 0 there is no preceding boundary to lose, so
        folding there preserves the reference's pinned encodings (e.g.
        "bb" -> one token) while every interior boundary survives — but
        only when the window stays INSIDE the first word: a capital at
        window position >= 1 is the second word's start ("e ebb" ->
        "EEbb"), and folding across it would delete that boundary too.
        """
        s = self._despace_capitalize(text)
        ids: List[int] = []
        i, n = 0, len(s)
        while i < n:
            def _fold_ok(w: str) -> bool:
                return i == 0 and not any(c.isupper() for c in w[1:])
            if n - i >= 3:
                w = s[i:i + 3]
                hit = self._by3.get(w.lower() if _fold_ok(w) else w)
                if hit is not None:
                    ids.append(hit)
                    i += 3
                    continue
            if n - i >= 2:
                w = s[i:i + 2]
                hit = self._by2.get(w.lower() if _fold_ok(w) else w)
                if hit is not None:
                    ids.append(hit)
                    i += 2
                    continue
            hit = self._by1.get(s[i])
            if hit is None:
                logger.warning("Unable to process label : %s", s)
                break
            ids.append(hit)
            i += 1
        if add_eos:
            ids.append(self.eos_id)
        return ids

    def decode(self, ids: Sequence[int], continuation: bool = False) -> str:
        """Inverse mapping: re-insert spaces before capitals, lowercase all.

        Out-of-range ids are dropped; a single EOS occurrence is removed.
        ``continuation=True`` treats the ids as the continuation of earlier
        output: a LEADING capital (word start) then also gets its space, so
        streaming decoders can emit piecewise —
        ``decode(a) + decode(b, continuation=bool(a))`` equals
        ``decode(a + b)`` for any split point.
        """
        toks = [self.tokens[i] for i in ids if 0 <= int(i) < len(self.tokens)]
        eos = self.tokens[-1]
        if eos in toks:
            toks.remove(eos)
        out: List[str] = []
        for pos, tok in enumerate(toks):
            if (pos != 0 or continuation) and tok[:1].isupper():
                out.append(" ")
            out.append(tok.lower())
        return "".join(out)

    # ---------------------------------------------------- fixed-shape device IO

    def encode_padded(
        self, text: str, max_len: int, add_eos: bool = True, pad_id: int = -1
    ) -> Tuple[np.ndarray, int]:
        """Encode into a fixed-shape int32 array for jit consumption.

        Returns (labels[max_len], true_length). Truncates past ``max_len``.
        ``pad_id`` defaults to -1 so padding can never collide with a real
        label id (id 0 is a real token, unlike the reference's sparse-tensor
        trick that conflated id 0 with emptiness).
        """
        ids = self.encode(text, add_eos=add_eos)[:max_len]
        arr = np.full((max_len,), pad_id, dtype=np.int32)
        arr[: len(ids)] = ids
        return arr, len(ids)

    def one_hot(self, text: str, add_eos: bool = True) -> np.ndarray:
        """One-hot encode a string: (len, num_labels) float array."""
        ids = self.encode(text, add_eos=add_eos)
        out = np.zeros((len(ids), len(self.tokens)), dtype=np.float64)
        out[np.arange(len(ids)), ids] = 1.0
        return out


_CHAR_MAPS = {"english": ENGLISH_CHAR_MAP}


def get_char_map(language: str) -> CharMap:
    """Language -> CharMap registry (reference supports English only)."""
    try:
        return CharMap(_CHAR_MAPS[language])
    except KeyError:
        raise ValueError(f"Unsupported language: {language!r}") from None
