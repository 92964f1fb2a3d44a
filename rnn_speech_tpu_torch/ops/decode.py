"""CTC decoding on the device (batched, time-major): greedy, the prefix
beam search with optional char-LM shallow fusion, and their chunk-carried
streaming forms.

Counterpart of ``greedy_decode``, ``greedy_stream_decode``,
``_left_compact``, the beam search (``BeamState``, ``_top_k_indices``,
``_beam_init``, ``_beam_scan``, ``_backtrack``, ``beam_search_decode``)
and the streaming beam (``BeamStream``, ``beam_stream_init``,
``beam_stream_decode``, ``beam_stream_flush``) of
``rnn_speech_tpu/ops/decode.py``.  Greedy: argmax, collapse repeats,
strip blanks, and left-compact the kept symbols into a (B, U) array
padded with -1.  The JAX package compacts by a co-sort and selects beam
fields by one-hot masks (and, for the LM view, by a bf16 high part plus a
residual on the TPU's matrix unit) because gathers and scatters serialise
on the TPU; here a cumsum gives each kept symbol its output slot and one
scatter writes it, and the beam step selects by ``gather``, which is
exact for the int32 hashes and the float32 scores alike (the JAX
package's split selection is exact on the CPU too, so both select the
same bits).

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
operations each.

Shallow fusion (``lm`` = ``models/language.stepper``'s (init, advance),
``lm_weight`` != 0) ranks candidates by AM log-prob + lm_weight x the LM
log-prob of the emitted characters: a stay keeps its prefix's LM score,
an extension adds the LM's next-char log-prob.  The LM carry is (the
cumulative LM log-prob (B, K), the next-char log-prob table (B, K, V),
the LM state with leaves (B, K, H)); each frame it is reselected by
parent and advanced once for every beam (N = B·K rows, one step of the
LM), keeping the advanced view only where a character was appended;
finished rows keep theirs.  With ``lm_weight`` 0 no LM runs and the search
is the AM-only one bit for bit.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

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


def _tree_map(fn, tree):
    """``fn`` over the tensors of an LM state (a list of (c, h) pairs)."""
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    return fn(tree)


def _tree_map2(fn, a, b):
    if isinstance(a, (list, tuple)):
        return type(a)(_tree_map2(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)


def _beam_init(B: int, K: int, V: int, blank_id: int, device, lm=None):
    """Fresh (BeamState, LM carry) of a B-row, K-beam search: beam 0 holds
    the empty prefix with log P = 0, the others are dead.  The LM carry is
    (cumulative LM log-prob (B, K), next-char log-probs (B, K, V), LM state
    with leaves (B, K, H)), or None without an LM."""
    zeros = torch.zeros((B, K), dtype=torch.int32, device=device)
    first = torch.arange(K, device=device)[None, :] == 0
    state = BeamState(
        hash=zeros, hash2=zeros.clone(), phash=zeros.clone(), phash2=zeros.clone(),
        has_par=torch.zeros((B, K), dtype=torch.bool, device=device),
        last=torch.full((B, K), blank_id, dtype=torch.int64, device=device),
        p_b=torch.where(first, 0.0, NEG_INF).expand(B, K).contiguous(),
        p_nb=torch.full((B, K), NEG_INF, device=device),
    )
    if lm is None:
        return state, None
    lm_state0, lm_logp0 = lm[0](B * K)
    lm0 = (torch.zeros((B, K), dtype=torch.float32, device=device),
           lm_logp0.reshape(B, K, -1)[:, :, :V],
           _tree_map(lambda leaf: leaf.reshape(B, K, -1), lm_state0))
    return state, lm0


def _beam_step(state: BeamState, lp_t: Tensor, live: Tensor, blank_id: int,
               lm_c=None, lm_advance=None, lm_weight: float = 0.0):
    """One frame of the prefix beam search on log-probs ``lp_t`` (B, V);
    rows where ``live`` (B,) is False keep their state.  With an LM carry
    ``lm_c`` and its ``lm_advance``, candidates rank by shallow fusion and
    the carry advances.  Returns (state, LM carry, parent (B, K), appended
    char (B, K), -1 for a stay)."""
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
    score = torch.logaddexp(cand_pb, cand_pnb)                      # AM score
    if lm_c is not None:
        lm_cum, lm_logp, lm_state = lm_c
        # Shallow-fusion rank: a stay keeps the prefix's LM score; an
        # extension adds the LM's next-char log-prob.
        lm_rank = torch.cat([lm_cum, (lm_cum[:, :, None] + lm_logp).reshape(B, K * V)],
                            dim=1)
        rank = torch.where(score <= NEG_INF / 2, NEG_INF, score + lm_weight * lm_rank)
    else:
        rank = score
    top_idx = _top_k_indices(rank, K)
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
    live2 = live[:, None]
    merged = BeamState(*[torch.where(live2, n, o) for n, o in zip(new, state)])

    lm_out = lm_c
    if lm_c is not None:
        # Reselect the LM view by parent, then advance every beam by its
        # appended character (0 for a stay, whose advance is discarded).
        row_sel = lambda leaf: leaf.gather(
            1, parent[:, :, None].expand(B, K, leaf.shape[2]))
        cum_par = lm_cum.gather(1, parent)
        logp_par = row_sel(lm_logp)                                  # (B, K, V)
        logp_char = logp_par.gather(2, char_sel[:, :, None])[..., 0]
        new_cum = torch.where(is_stay, cum_par, cum_par + logp_char)
        state_par = _tree_map(row_sel, lm_state)
        adv_state, adv_logp = lm_advance(
            _tree_map(lambda leaf: leaf.reshape(B * K, -1), state_par),
            char_sel.reshape(B * K))
        keep_stay = is_stay[:, :, None]
        new_logp = torch.where(keep_stay, logp_par, adv_logp.reshape(B, K, -1)[:, :, :V])
        new_state = _tree_map2(
            lambda old, adv: torch.where(keep_stay, old, adv.reshape(B, K, -1)),
            state_par, adv_state)
        live3 = live[:, None, None]
        lm_out = (torch.where(live2, new_cum, lm_cum),
                  torch.where(live3, new_logp, lm_logp),
                  _tree_map2(lambda n, o: torch.where(live3, n, o), new_state, lm_state))
    return (merged, lm_out, torch.where(live2, parent, arange_k),
            torch.where(live2, char, -1))


def _beam_scan(log_probs: Tensor, logit_lengths: Tensor, init: BeamState, lm0,
               blank_id: int, lm=None, lm_weight: float = 0.0):
    """The prefix-beam step over ``log_probs`` (T, B, V) from ``init`` and
    the LM carry ``lm0``.  Returns (final state, final LM carry, parents
    (T, B, K), emitted (T, B, K)): the trellis records the backtrack reads.
    Shared by the whole-clip and the streaming decoders; splitting a clip
    at any frame and chaining the carries is exact."""
    T, B, _ = log_probs.shape
    K = init.last.shape[1]
    use_lm = lm is not None and lm_weight != 0.0
    lm_c = lm0 if use_lm else None
    lens = torch.as_tensor(logit_lengths, device=log_probs.device)
    state, parents, emitted = init, [], []
    for t in range(T):
        state, lm_c, parent, char = _beam_step(
            state, log_probs[t], t < lens, blank_id, lm_c,
            lm[1] if use_lm else None, lm_weight)
        parents.append(parent)
        emitted.append(char)
    lm_final = lm_c if use_lm else lm0
    if not T:
        empty = torch.zeros((0, B, K), dtype=torch.int64, device=log_probs.device)
        return state, lm_final, empty, empty
    return state, lm_final, torch.stack(parents), torch.stack(emitted)


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


def _compact_beams(chars_fwd: Tensor, U: int) -> Tuple[Tensor, Tensor]:
    """(T, B, K) emitted chars (-1 for stays) -> (labels (B, K, U), lengths
    (B, K))."""
    T, B, K = chars_fwd.shape
    out, lengths = _left_compact(chars_fwd.reshape(T, B * K),
                                 (chars_fwd >= 0).reshape(T, B * K), U)
    return out.reshape(B, K, U), lengths.reshape(B, K)


def beam_search_decode(
    logits: torch.Tensor,          # (T, B, V)
    logit_lengths: torch.Tensor,   # (B,)
    beam_width: int = 16,
    blank_id: int = -1,
    max_output: int = 0,
    lm=None,                       # optional (init, advance) of language.stepper
    lm_weight: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefix beam search.  Returns (labels (B, K, U) padded with -1,
    lengths (B, K), scores (B, K)) sorted best first; U = max_output or T.
    With ``lm`` and ``lm_weight`` != 0 the candidates rank, and the final
    scores are, AM log-prob + lm_weight x LM log-prob (shallow fusion)."""
    T, B, V = logits.shape
    K = beam_width
    if blank_id < 0:
        blank_id = V + blank_id
    U = max_output or T
    use_lm = lm is not None and lm_weight != 0.0
    log_probs = torch.log_softmax(logits.to(torch.float32), dim=-1)
    init, lm0 = _beam_init(B, K, V, blank_id, logits.device, lm if use_lm else None)
    final, lm_final, parents, emitted = _beam_scan(
        log_probs, logit_lengths, init, lm0, blank_id, lm, lm_weight)
    scores = torch.logaddexp(final.p_b, final.p_nb)
    if use_lm:
        scores = scores + lm_weight * lm_final[0]                   # fused score
    order = torch.sort(-scores, dim=-1, stable=True).indices
    scores = scores.gather(1, order)
    _, chars_fwd = _backtrack(parents, emitted, order)
    out, lengths = _compact_beams(chars_fwd, U)
    return out, lengths, scores


class BeamStream(NamedTuple):
    """Carried state of chunk-at-a-time beam decoding (the ``--record``
    decode path): the beam, the LM carry (or None), and each beam's
    not-yet-committed label suffix.  Symbols every live beam shares can
    never be revised; ``beam_stream_decode`` returns them and trims them
    off, so the buffer only covers the beams' disagreement."""

    beam: BeamState
    lm: Any                 # (cum, logp, state) of _beam_init, or None
    prefix: Tensor          # (B, K, U) int32, -1 padded
    prefix_len: Tensor      # (B, K) int32


def beam_stream_init(n_batch: int, num_labels: int, beam_width: int = 16,
                     max_suffix: int = 64, blank_id: int = -1, lm=None,
                     device=None) -> BeamStream:
    """Fresh streaming-beam state on ``device`` (default cuda).
    ``max_suffix`` bounds the uncommitted label buffer (committed symbols
    are trimmed each chunk, so it only holds the beams' divergence plus
    one chunk's output)."""
    from rnn_speech_tpu_torch import resolve_device

    dev = resolve_device(device)
    if blank_id < 0:
        blank_id = num_labels + blank_id
    beam, lm0 = _beam_init(n_batch, beam_width, num_labels, blank_id, dev, lm)
    return BeamStream(
        beam=beam, lm=lm0,
        prefix=torch.full((n_batch, beam_width, max_suffix), -1, dtype=torch.int32,
                          device=dev),
        prefix_len=torch.zeros((n_batch, beam_width), dtype=torch.int32, device=dev),
    )


def beam_stream_decode(stream: BeamStream, logits: Tensor, logit_lengths: Tensor,
                       blank_id: int = -1, lm=None,
                       lm_weight: float = 0.0) -> Tuple[BeamStream, Tensor, Tensor]:
    """Advance the beam search by one chunk of frames ``logits`` (T, B, V),
    ``logit_lengths`` (B,) valid frames each.

    Returns (stream', committed (B, U+T), committed_len (B,)): the newly
    final symbols, the longest common prefix of every live beam.  Chunks'
    committed symbols plus ``beam_stream_flush``'s tail equal the
    whole-clip ``beam_search_decode`` best beam at every chunk size, as
    long as the beams' disagreement fits ``max_suffix``; past that the
    overflow is force-committed from the best beam (every emitted symbol
    still appears exactly once)."""
    T, B, V = logits.shape
    K = stream.beam.last.shape[1]
    U = stream.prefix.shape[2]
    Uw = U + T                     # appending this chunk's (<= T) symbols never clamps
    if blank_id < 0:
        blank_id = V + blank_id
    dev = logits.device
    log_probs = torch.log_softmax(logits.to(torch.float32), dim=-1)
    arange_k = torch.arange(K, device=dev)
    arange_u = torch.arange(Uw, device=dev)

    final, lm_final, parents, emitted = _beam_scan(
        log_probs, logit_lengths, stream.beam, stream.lm, blank_id, lm, lm_weight)

    # Each step's top-K already orders the beams by the (fused) score, so
    # beam 0 of the carried state is the best hypothesis.
    ancestors, chars_fwd = _backtrack(parents, emitted,
                                      arange_k[None, :].expand(B, K).contiguous())
    chunk_out, chunk_len = _compact_beams(chars_fwd, max(T, 1))

    # New suffix per beam = its ancestor's carried suffix ++ this chunk's
    # emissions.
    prefix_w = torch.nn.functional.pad(stream.prefix, (0, T), value=-1)   # (B, K, Uw)
    par_prefix = prefix_w.gather(1, ancestors[:, :, None].expand(B, K, Uw))
    par_len = stream.prefix_len.gather(1, ancestors)
    idx = arange_u[None, None, :] - par_len[:, :, None].long()             # (B, K, Uw)
    from_chunk = chunk_out.gather(2, idx.clamp(0, chunk_out.shape[2] - 1))
    new_prefix = torch.where(idx < 0, par_prefix,
                             torch.where(idx < chunk_len[:, :, None], from_chunk, -1))
    new_len = par_len + chunk_len

    # Committed = the longest common prefix over live beams (dead beams are
    # NEG_INF filler and do not constrain it).
    live = torch.logaddexp(final.p_b, final.p_nb) > NEG_INF / 2           # (B, K)
    within = arange_u[None, None, :] < new_len[:, :, None]
    agrees = (new_prefix == new_prefix[:, 0:1, :]) & within
    ok = torch.all(agrees | ~live[:, :, None], dim=1)                     # (B, Uw)
    commit_len = torch.cumprod(ok.to(torch.int32), dim=-1).sum(-1).to(torch.int32)

    # Bounded-latency forced commit: if the longest live suffix left after
    # the natural commit still exceeds U, commit the best beam's oldest
    # overflow symbols too.
    live_len = torch.where(live, new_len, 0)
    force = torch.clamp(live_len.max(dim=1).values - commit_len - U, min=0)
    commit_len = (commit_len + force).to(torch.int32)
    committed = torch.where(arange_u[None, :] < commit_len[:, None],
                            new_prefix[:, 0, :], -1)

    # Trim the committed head off every suffix and re-bound it to U.
    tidx = (arange_u[None, None, :] + commit_len[:, None, None].long()).clamp(max=Uw - 1)
    trimmed = new_prefix.gather(2, tidx.expand(B, K, Uw))
    trim_len = torch.clamp(new_len - commit_len[:, None], 0, U).to(torch.int32)
    trimmed = torch.where(arange_u[None, None, :] < trim_len[:, :, None], trimmed,
                          -1)[:, :, :U].to(torch.int32).contiguous()
    out = BeamStream(beam=final, lm=lm_final, prefix=trimmed, prefix_len=trim_len)
    return out, committed.to(torch.int32), commit_len


def beam_stream_flush(stream: BeamStream) -> Tuple[Tensor, Tensor]:
    """End of stream: the best beam's remaining uncommitted suffix,
    (labels (B, U), lengths (B,))."""
    return stream.prefix[:, 0, :], stream.prefix_len[:, 0]
