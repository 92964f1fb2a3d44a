"""CTC decoding on the device (batched, time-major): greedy and the
AM-only prefix beam search.

Counterpart of ``greedy_decode``, ``greedy_stream_decode``,
``_left_compact`` and the beam search (``BeamState``, ``_top_k_indices``,
``_beam_init``, ``_beam_scan`` without its LM branch, ``_backtrack``,
``beam_search_decode``) of ``rnn_speech_tpu/ops/decode.py``.  Greedy:
argmax, collapse repeats, strip blanks, and left-compact the kept symbols
into a (B, U) array padded with -1.  The JAX package compacts by a co-sort
and selects beam fields by one-hot masks because gathers and scatters
serialise on the TPU; here a cumsum gives each kept symbol its output slot
and one scatter writes it, and the beam step selects by ``gather``, which
is exact for the int32 hashes and the float32 scores alike.

The beam search is Graves' prefix beam search with the JAX package's
state: per beam the prefix's two int32 hashes, its parent prefix's,
whether it is non-empty, its last character and log P(prefix, ending in
blank / non-blank); a (parent, appended character) trellis per frame
rebuilds the prefixes at the end.  Equal prefixes merge exactly: stay(i)
duplicates extend(j, last_i) iff prefix_j is prefix_i's parent.  Its
arithmetic is the JAX package's, in float32 after an f32 log-softmax, with
NEG_INF = -1e30 and the dead-beam test at NEG_INF / 2; the hashes wrap
modulo 2^32 as int32 arithmetic does in JAX (computed in int64 and wrapped
back, so the CPU and CUDA give the same bits); the top-K and the final
order put the lowest index first among equal scores (stable sorts), as
``lax.top_k`` and ``jnp.argsort`` do.  Rows past ``logit_lengths`` freeze.
The search is a Python loop over the frames, a few tens of small tensor
operations each.  LM shallow fusion and the streaming ``BeamStream`` come
with the language-model and streaming slices.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

Tensor = torch.Tensor
NEG_INF = -1.0e30
_HASH_MULT = 1000003
_HASH_MULT2 = 8191


def _left_compact(chars: torch.Tensor, keep: torch.Tensor,
                  U: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Left-compact kept symbols along the leading time axis.

    ``chars``/``keep`` are (T, B); returns (out (B, U) padded with -1,
    lengths (B,) int32, capped at U)."""
    T, B = chars.shape
    keep = keep.to(torch.bool)
    pos = torch.cumsum(keep.to(torch.int64), dim=0) - 1          # slot per t
    # Dropped entries, and kept ones past U, go to a spill column U.
    slot = torch.where(keep & (pos < U), pos, torch.full_like(pos, U))
    out = torch.full((B, U + 1), -1, dtype=torch.int32, device=chars.device)
    out.scatter_(1, slot.t(), chars.t().to(torch.int32))
    lengths = keep.sum(dim=0).clamp(max=U).to(torch.int32)
    return out[:, :U].contiguous(), lengths


def greedy_decode(
    logits: torch.Tensor,          # (T, B, V)
    logit_lengths: torch.Tensor,   # (B,)
    blank_id: int = -1,
    max_output: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best-path decode -> (labels (B, U) padded with -1, lengths (B,));
    U = max_output or T."""
    T, B, V = logits.shape
    if blank_id < 0:
        blank_id = V + blank_id
    U = max_output or T
    best = torch.argmax(logits, dim=-1).to(torch.int32)           # (T, B)
    prev = torch.cat(
        [torch.full((1, B), -1, dtype=torch.int32, device=logits.device),
         best[:-1]], dim=0
    )
    lens = torch.as_tensor(logit_lengths, device=logits.device)
    valid = torch.arange(T, device=logits.device)[:, None] < lens[None, :]
    keep = valid & (best != blank_id) & (best != prev)
    return _left_compact(best, keep, U)


def greedy_stream_decode(
    logits: torch.Tensor,          # (T, B, V)
    logit_lengths: torch.Tensor,   # (B,)
    prev: torch.Tensor,            # (B,) last valid frame's raw argmax
    blank_id: int = -1,
    max_output: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Chunk-carried greedy decode: the repeat collapse sees the previous
    chunk's final frame through ``prev`` (start at -1), so feeding chunks
    and concatenating reproduces the whole-clip ``greedy_decode`` text.
    Returns (labels (B, U), lengths (B,), new_prev (B,))."""
    T, B, V = logits.shape
    if blank_id < 0:
        blank_id = V + blank_id
    U = max_output or T
    dev = logits.device
    prev = torch.as_tensor(prev, device=dev).to(torch.int32)
    best = torch.argmax(logits, dim=-1).to(torch.int32)
    prev_shift = torch.cat([prev[None, :], best[:-1]], dim=0)
    lens = torch.as_tensor(logit_lengths, device=dev).to(torch.int64)
    valid = torch.arange(T, device=dev)[:, None] < lens[None, :]
    keep = valid & (best != blank_id) & (best != prev_shift)
    out, lengths = _left_compact(best, keep, U)
    last = (lens - 1).clamp(min=0)
    last_best = best.gather(0, last[None, :])[0]
    new_prev = torch.where(lens > 0, last_best, prev)
    return out, lengths, new_prev


class BeamState(NamedTuple):
    hash: Tensor      # (B, K) int32 prefix identity (primary)
    hash2: Tensor     # (B, K) int32 prefix identity (secondary)
    phash: Tensor     # (B, K) int32 parent-prefix identity (primary)
    phash2: Tensor    # (B, K) int32 parent-prefix identity (secondary)
    has_par: Tensor   # (B, K) bool: prefix is nonempty (parent exists)
    last: Tensor      # (B, K) int64 last char (blank if empty)
    p_b: Tensor       # (B, K) float32 log P(prefix, ending in blank)
    p_nb: Tensor      # (B, K) float32 log P(prefix, ending in non-blank)


def _wrap_i32(x: Tensor) -> Tensor:
    """int64 values wrapped to int32 as two's-complement int32 arithmetic
    wraps them."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _top_k_indices(rank: Tensor, k: int) -> Tensor:
    """Indices of the k largest entries per row, descending, ties broken
    toward the lowest index (``lax.top_k``'s order): a stable descending
    sort."""
    return torch.sort(rank, dim=-1, descending=True, stable=True).indices[:, :k]


def _beam_init(B: int, K: int, blank_id: int, device) -> BeamState:
    """Fresh state of a B-row, K-beam search: beam 0 holds the empty
    prefix with log P = 0, the others are dead."""
    zeros = torch.zeros((B, K), dtype=torch.int32, device=device)
    first = torch.arange(K, device=device)[None, :] == 0
    return BeamState(
        hash=zeros, hash2=zeros.clone(), phash=zeros.clone(), phash2=zeros.clone(),
        has_par=torch.zeros((B, K), dtype=torch.bool, device=device),
        last=torch.full((B, K), blank_id, dtype=torch.int64, device=device),
        p_b=torch.where(first, 0.0, NEG_INF).expand(B, K).contiguous(),
        p_nb=torch.full((B, K), NEG_INF, device=device),
    )


def _beam_step(state: BeamState, lp_t: Tensor, live: Tensor,
               blank_id: int) -> Tuple[BeamState, Tensor, Tensor]:
    """One frame of the prefix beam search on log-probs ``lp_t`` (B, V);
    rows where ``live`` (B,) is False keep their state.  Returns (state,
    parent (B, K), appended char (B, K), -1 for a stay)."""
    B, K = state.last.shape
    V = lp_t.shape[1]
    dev = lp_t.device
    chars = torch.arange(V, device=dev)
    arange_k = torch.arange(K, device=dev)
    total = torch.logaddexp(state.p_b, state.p_nb)                  # (B, K)
    last_oh = state.last[:, :, None] == chars                       # (B, K, V)

    # Slot i < K per beam: "stay" (emit blank, or repeat the last char).
    stay_pb = total + lp_t[:, blank_id:blank_id + 1]
    lp_last = lp_t.gather(1, state.last)
    stay_pnb = state.p_nb + lp_last

    # Slots K..C-1: extend beam j with char c (the blank column masked out).
    base = torch.where(last_oh, state.p_b[:, :, None], total[:, :, None])
    ext_pnb = torch.where(chars == blank_id, NEG_INF, base + lp_t[:, None, :])

    # Exact merge: stay(i) duplicates extend(j, last_i) iff prefix_j is
    # parent(prefix_i); at most one j matches.
    match = ((state.phash[:, :, None] == state.hash[:, None, :])
             & (state.phash2[:, :, None] == state.hash2[:, None, :])
             & state.has_par[:, :, None])                           # (B, i, j)
    last_eq = state.last[:, :, None] == state.last[:, None, :]
    ext_at_last = torch.where(
        (state.last == blank_id)[:, :, None], NEG_INF,
        torch.where(last_eq, state.p_b[:, None, :], total[:, None, :])
        + lp_last[:, :, None])                                      # (B, i, j)
    contrib = torch.where(match, ext_at_last, NEG_INF).max(dim=-1).values
    stay_pnb = torch.logaddexp(stay_pnb, contrib)
    # Kill the merged extend candidates: kill(j, c) = any_i match(i, j) &
    # last_i == c.
    kill = torch.bmm(match.transpose(1, 2).float(), last_oh.float()) > 0.5
    ext_pnb = torch.where(kill, NEG_INF, ext_pnb)

    # Flatten + top-K.
    cand_pb = torch.cat([stay_pb, torch.full((B, K * V), NEG_INF, device=dev)], dim=1)
    cand_pnb = torch.cat([stay_pnb, ext_pnb.reshape(B, K * V)], dim=1)
    top_idx = _top_k_indices(torch.logaddexp(cand_pb, cand_pnb), K)
    is_stay = top_idx < K
    parent = torch.where(is_stay, top_idx, (top_idx - K) // V)
    char = torch.where(is_stay, -1, (top_idx - K) % V)

    sel = lambda field: field.gather(1, parent)
    h_par, h2_par, ph_par, ph2_par = (sel(f) for f in (state.hash, state.hash2,
                                                       state.phash, state.phash2))
    hp_par, last_par = sel(state.has_par), sel(state.last)
    # The selected candidates' scores from (B, K) selections: stay slots
    # carry (stay_pb, merged stay_pnb) at their parent; extend slots carry
    # p_b = NEG_INF and p_nb = (char == last_par ? p_b_par : total_par) +
    # lp_t[char], NEG_INF where the candidate was blank-masked or killed.
    char_sel = torch.where(is_stay, 0, char)
    ext_val = (torch.where(char_sel == last_par, sel(state.p_b), sel(total))
               + lp_t.gather(1, char_sel))
    match_par = match.gather(2, parent[:, None, :].expand(B, K, K)).transpose(1, 2)
    killed = (match_par & (state.last[:, None, :] == char_sel[:, :, None])).any(-1)
    ext_pnb_sel = torch.where(killed | (char_sel == blank_id), NEG_INF, ext_val)
    new_pb = torch.where(is_stay, sel(stay_pb), NEG_INF)
    new_pnb = torch.where(is_stay, sel(stay_pnb), ext_pnb_sel)
    dead = torch.logaddexp(new_pb, new_pnb) <= NEG_INF / 2

    c1 = char + 1
    new = BeamState(
        hash=torch.where(is_stay, h_par, _wrap_i32(h_par.long() * _HASH_MULT)
                         ^ c1.to(torch.int32)),
        hash2=torch.where(is_stay, h2_par, _wrap_i32(h2_par.long() * _HASH_MULT2 + c1)),
        phash=torch.where(is_stay, ph_par, h_par),
        phash2=torch.where(is_stay, ph2_par, h2_par),
        has_par=hp_par | ~is_stay,
        last=torch.where(is_stay, last_par, char),
        p_b=torch.where(dead, NEG_INF, new_pb),
        p_nb=torch.where(dead, NEG_INF, new_pnb),
    )
    # Freeze finished rows.
    live = live[:, None]
    merged = BeamState(*[torch.where(live, n, o) for n, o in zip(new, state)])
    return (merged, torch.where(live, parent, arange_k),
            torch.where(live, char, -1))


def _beam_scan(log_probs: Tensor, logit_lengths: Tensor, init: BeamState,
               blank_id: int) -> Tuple[BeamState, Tensor, Tensor]:
    """The prefix-beam step over ``log_probs`` (T, B, V) from ``init``.
    Returns (final state, parents (T, B, K), emitted (T, B, K)): the
    trellis records the backtrack reads."""
    T, B, _ = log_probs.shape
    K = init.last.shape[1]
    lens = torch.as_tensor(logit_lengths, device=log_probs.device)
    state, parents, emitted = init, [], []
    for t in range(T):
        state, parent, char = _beam_step(state, log_probs[t], t < lens, blank_id)
        parents.append(parent)
        emitted.append(char)
    if not T:
        empty = torch.zeros((0, B, K), dtype=torch.int64, device=log_probs.device)
        return state, empty, empty
    return state, torch.stack(parents), torch.stack(emitted)


def _backtrack(parents: Tensor, emitted: Tensor,
               order: Tensor) -> Tuple[Tensor, Tensor]:
    """Trace beam lineages back through a (T, B, K) trellis.  ``order``
    (B, K) picks the final beams to follow.  Returns (ancestors (B, K),
    chars (T, B, K)): the start-of-trellis beam each followed beam descends
    from, and its emitted chars (-1 for stays) in forward time order."""
    beam = order
    chars = torch.empty_like(emitted)
    for t in reversed(range(emitted.shape[0])):
        chars[t] = emitted[t].gather(1, beam)
        beam = parents[t].gather(1, beam)
    return beam, chars


def beam_search_decode(
    logits: torch.Tensor,          # (T, B, V)
    logit_lengths: torch.Tensor,   # (B,)
    beam_width: int = 16,
    blank_id: int = -1,
    max_output: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """AM-only prefix beam search.  Returns (labels (B, K, U) padded with
    -1, lengths (B, K), scores (B, K)) sorted best first; U = max_output
    or T."""
    T, B, V = logits.shape
    K = beam_width
    if blank_id < 0:
        blank_id = V + blank_id
    U = max_output or T
    log_probs = torch.log_softmax(logits.to(torch.float32), dim=-1)
    init = _beam_init(B, K, blank_id, logits.device)
    final, parents, emitted = _beam_scan(log_probs, logit_lengths, init, blank_id)
    scores = torch.logaddexp(final.p_b, final.p_nb)
    order = torch.sort(-scores, dim=-1, stable=True).indices
    scores = scores.gather(1, order)
    _, chars_fwd = _backtrack(parents, emitted, order)
    out, lengths = _left_compact(chars_fwd.reshape(T, B * K),
                                 (chars_fwd >= 0).reshape(T, B * K), U)
    return out.reshape(B, K, U), lengths.reshape(B, K), scores
