"""Counter-based random bits for dropout: the plain version of
``csrc/philox.cuh``.

Counterpart of the JAX package's in-kernel bits (``_keep_bits`` in
``rnn_speech_tpu/ops/lstm_wavefront.py`` and ``_threshold`` in
``rnn_speech_tpu/ops/dropout_pallas.py``), which draw from the TPU core's
generator seeded per grid step.  Here every bit is Philox4x32-10 (Salmon
et al., "Parallel random numbers: as easy as 1, 2, 3", SC 2011) of a
counter built from the element's logical coordinates, keyed on two
32-bit seed words.  No counter depends on a block or thread id, so the
forward and backward kernels, which tile differently, and this plain
version draw the same bits:

* dropout (``ops/dropout.py``): element n of the flat tensor, keep k of
  the site: counter (n >> 2, n >> 34, k, 0), word n & 3;
* the Bernoulli mask stream (``dropout.bernoulli_mask``): the dropout
  layout with k = 0, so the mask of a shape is ``dropout_mask(seed,
  shape, [keep])``;
* wavefront inter-layer boundary l at step t, row b, unit j
  (``ops/lstm_wavefront.py``): counter (j >> 2, b, t, l), word j & 3.

An element is kept iff its word < ``threshold(keep)`` =
min(round(keep·2^32), 2^32 - 1).  The plain version computes the same
32-bit words on any device with int64 tensors: each 32 x 32-bit product
is split into 16-bit halves of the counter word so nothing overflows.

``seed_words(generator)`` draws the two key words on the host from a CPU
``torch.Generator``: they reach the kernels as scalar arguments, so a
step needs no device synchronisation for its dropout seeds.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

Tensor = torch.Tensor
MASK32 = 0xFFFFFFFF
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
ROUNDS = 10
_CHUNK = 1 << 22        # counters per step of the chunked plain versions


def threshold(keep: float) -> int:
    """uint32 threshold with P(word < threshold) = keep, for 0 < keep < 1."""
    if not 0.0 < keep < 1.0:
        raise ValueError(f"keep probability must be in (0, 1), got {keep}")
    return min(int(round(keep * 2.0 ** 32)), MASK32)


def seed_words(generator: torch.Generator) -> Tuple[int, int]:
    """Two uint32 key words drawn on the host from a CPU generator."""
    if generator.device.type != "cpu":
        raise ValueError("dropout seeds come from a CPU torch.Generator "
                         f"(host draw, no sync), got one on {generator.device}")
    w = torch.randint(0, 2 ** 32, (2,), dtype=torch.int64, generator=generator)
    return int(w[0]), int(w[1])


def _mulhilo(m: int, x: Tensor) -> Tuple[Tensor, Tensor]:
    """(hi, lo) 32-bit words of m·x for a constant m < 2^32 and int64 x in
    [0, 2^32): x splits into 16-bit halves, each partial < 2^48."""
    a = m * (x & 0xFFFF)
    b = m * (x >> 16)
    s = a + ((b & 0xFFFF) << 16)
    return (b >> 16) + (s >> 32), s & MASK32


def philox4x32(c0: Tensor, c1: Tensor, c2: Tensor, c3: Tensor,
               key: Sequence[int]) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Philox4x32-10 of int64 counters with values in [0, 2^32) (tensors
    that broadcast together) under ``key`` = (k0, k1); four int64 words."""
    k0, k1 = int(key[0]) & MASK32, int(key[1]) & MASK32
    for r in range(ROUNDS):
        if r:
            k0, k1 = (k0 + PHILOX_W0) & MASK32, (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _words_of(c0: Tensor, c1, c2, c3, key) -> Tensor:
    """(..., 4) words of each counter, in word order."""
    return torch.stack(philox4x32(c0, c1, c2, c3, key), dim=-1)


def flat_keep_mask(seed: Sequence[int], numel: int, keep_index: int, keep: float,
                   device) -> Tensor:
    """(numel,) bool: element n is kept under the dropout counter layout."""
    thr = threshold(keep)
    out = torch.empty((numel,), dtype=torch.bool, device=device)
    nq = -(-numel // 4)
    for q0 in range(0, nq, _CHUNK):
        q = torch.arange(q0, min(nq, q0 + _CHUNK), dtype=torch.int64, device=device)
        zero = torch.zeros_like(q)
        w = _words_of(q & MASK32, q >> 32, zero + keep_index, zero, seed).reshape(-1)
        n = min(numel - 4 * q0, w.numel())
        out[4 * q0:4 * q0 + n] = w[:n] < thr
    return out


def dropout_mask(seed: Sequence[int], shape, keeps: Sequence[float], device) -> Tensor:
    """bool mask of ``shape``: AND of one independent mask per keep."""
    numel = 1
    for d in shape:
        numel *= int(d)
    mask = None
    for k, keep in enumerate(keeps):
        m = flat_keep_mask(seed, numel, k, keep, device)
        mask = m if mask is None else mask & m
    return mask.reshape(tuple(shape))


def wavefront_masks(seed: Sequence[int], n_boundaries: int, T: int, B: int, H: int,
                    keep: float, device) -> Tensor:
    """(n_boundaries, T, B, H) bool: the inter-layer keep bits that both
    wavefront kernels draw for boundary l at step t (H % 4 == 0)."""
    if H % 4:
        raise ValueError(f"the wavefront bits need H % 4 == 0, got H={H}")
    thr = threshold(keep)
    out = torch.empty((n_boundaries, T, B, H), dtype=torch.bool, device=device)
    j4 = torch.arange(H // 4, dtype=torch.int64, device=device)
    b = torch.arange(B, dtype=torch.int64, device=device)
    step = max(1, _CHUNK // max(B * H // 4, 1))
    for l in range(n_boundaries):
        for t0 in range(0, T, step):
            t = torch.arange(t0, min(T, t0 + step), dtype=torch.int64, device=device)
            c0 = j4[None, None, :]
            c1 = b[None, :, None]
            c2 = t[:, None, None]
            c3 = torch.full((), l, dtype=torch.int64, device=device)
            c0, c1, c2 = torch.broadcast_tensors(c0, c1, c2)
            w = _words_of(c0, c1, c2, c3.expand_as(c0), seed)   # (t, B, H/4, 4)
            out[l, t0:t0 + t.numel()] = (w < thr).reshape(t.numel(), B, H)
    return out
