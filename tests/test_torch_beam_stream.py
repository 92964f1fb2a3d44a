"""The port's chunk-carried beam search (``BeamStream``) on the CPU,
against the whole-clip search and against the JAX package's streaming
decoder (the counterpart of ``tests/test_decode.py``'s streaming beam
cases; the greedy stream's are in ``test_torch_decode.py``).

Concatenating each chunk's committed symbols and the flush tail must give
the whole-clip best beam exactly, at every chunk size, with and without
the char LM; when the beams' disagreement outlives ``max_suffix`` the
overflow is force-committed and nothing is dropped; the committed total
equals the whole-clip length for any capacity and chunking; commits are
monotone prefixes.  Every chunk's committed array, its length and the
carried suffix buffer equal JAX's ``beam_stream_decode`` exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnn_speech_tpu.models import language as jlang
from rnn_speech_tpu.ops import decode as jdecode
from rnn_speech_tpu_torch import params as tparams
from rnn_speech_tpu_torch.models import language as tlang
from rnn_speech_tpu_torch.ops import decode as tdecode


def _lm(V, hidden=16, seed=3):
    jcfg = jlang.LanguageConfig(num_layers=1, hidden_size=hidden, num_labels=V)
    jp = jlang.init_params(jax.random.PRNGKey(seed), jcfg)
    tcfg = tlang.LanguageConfig(num_layers=1, hidden_size=hidden, num_labels=V)
    tp = tparams.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jlang.stepper(jp, jcfg), tlang.stepper(tp, tcfg)


def _run_stream(logits, lengths, chunks, K, U=64, lm=None, lm_weight=0.0):
    """Feed the chunks; return (concat(committed) + flush tail per row,
    the per-chunk (committed, lengths, prefix, prefix_len) arrays)."""
    T, B, V = logits.shape
    stream = tdecode.beam_stream_init(B, V, beam_width=K, max_suffix=U, lm=lm, device="cpu")
    got = [[] for _ in range(B)]
    trace = []
    off = 0
    for n in chunks:
        cl = torch.clamp(torch.as_tensor(lengths) - off, 0, n)
        stream, com, comlen = tdecode.beam_stream_decode(
            stream, torch.as_tensor(logits[off:off + n]), cl, lm=lm, lm_weight=lm_weight)
        for b in range(B):
            got[b].extend(com[b, : int(comlen[b])].tolist())
        trace.append((com.numpy(), comlen.numpy(), stream.prefix.numpy(),
                      stream.prefix_len.numpy()))
        off += n
    tail, tail_len = tdecode.beam_stream_flush(stream)
    for b in range(B):
        got[b].extend(tail[b, : int(tail_len[b])].tolist())
    return got, trace


def _run_jax_stream(logits, lengths, chunks, K, U=64, lm=None, lm_weight=0.0):
    T, B, V = logits.shape
    stream = jdecode.beam_stream_init(B, V, beam_width=K, max_suffix=U, lm=lm)
    trace = []
    off = 0
    for n in chunks:
        cl = jnp.clip(jnp.asarray(lengths) - off, 0, n)
        stream, com, comlen = jdecode.beam_stream_decode(
            stream, jnp.asarray(logits[off:off + n]), cl, lm=lm, lm_weight=lm_weight)
        trace.append(tuple(np.asarray(a) for a in (com, comlen, stream.prefix,
                                                   stream.prefix_len)))
        off += n
    return trace


def _whole(logits, lengths, K, lm=None, lm_weight=0.0):
    out, lens, _ = tdecode.beam_search_decode(torch.as_tensor(logits), torch.as_tensor(lengths),
                                              beam_width=K, lm=lm, lm_weight=lm_weight)
    return [out[b, 0, : int(lens[b, 0])].tolist() for b in range(out.shape[0])]


def _even(T, n):
    return [min(n, T - o) for o in range(0, T, n)]


@pytest.mark.parametrize("chunk", [1, 6, 11, 37])
def test_beam_stream_matches_whole_clip(chunk):
    rng = np.random.default_rng(0)
    T, B, V, K = 37, 3, 8, 4
    logits = rng.normal(0, 2, (T, B, V)).astype(np.float32)
    lengths = np.asarray([37, 20, 1], np.int32)
    got, _ = _run_stream(logits, lengths, _even(T, chunk), K)
    assert got == _whole(logits, lengths, K)


@pytest.mark.parametrize("chunk", [4, 25])
def test_beam_stream_with_lm_fusion_matches_whole_clip(chunk):
    rng = np.random.default_rng(1)
    T, B, V, K = 25, 2, 8, 4
    _, tlm = _lm(V)
    logits = rng.normal(0, 2, (T, B, V)).astype(np.float32)
    lengths = np.asarray([25, 13], np.int32)
    got, _ = _run_stream(logits, lengths, _even(T, chunk), K, lm=tlm, lm_weight=0.7)
    assert got == _whole(logits, lengths, K, lm=tlm, lm_weight=0.7)


def test_beam_stream_forced_commit_on_suffix_saturation():
    """Two beams that disagree on symbol 0 forever keep the all-beams
    commit from firing while every frame emits: the forced commit must
    carry every symbol past ``max_suffix`` through, in order."""
    T, B, V, K = 40, 1, 5, 4
    base = np.full((T, B, V), -8.0, np.float32)
    base[0, 0, 0] = 2.01
    base[0, 0, 1] = 1.99
    for t in range(1, T):
        base[t, 0, 2 + (t % 2)] = 4.0
    lengths = np.asarray([T], np.int32)
    whole = _whole(base, lengths, K)[0]
    assert len(whole) == T
    U = 8
    got, trace = _run_stream(base, lengths, _even(T, 6), K, U=U)
    assert max(int(p_len.max()) for _, _, _, p_len in trace) == U   # saturated
    assert got[0] == whole


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_beam_stream_length_conservation_fuzz(seed):
    rng = np.random.default_rng(seed)
    T, B, V, K = 41, 2, 6, 4
    logits = rng.normal(0, 1.0, (T, B, V)).astype(np.float32)
    lengths = np.asarray([T, T - 11], np.int32)
    _, lens, _ = tdecode.beam_search_decode(torch.as_tensor(logits),
                                            torch.as_tensor(lengths), beam_width=K)
    chunks, left = [], T
    while left:
        n = min(int(rng.integers(1, 9)), left)
        chunks.append(n)
        left -= n
    for U in (48, 8):
        got, _ = _run_stream(logits, lengths, chunks, K, U=U)
        assert [len(g) for g in got] == lens[:, 0].tolist(), (U, chunks)


def test_beam_stream_commits_are_monotone_prefixes():
    rng = np.random.default_rng(7)
    T, B, V, K = 30, 1, 6, 4
    logits = rng.normal(0, 1.5, (T, B, V)).astype(np.float32)
    _, trace = _run_stream(logits, np.asarray([T], np.int32), _even(T, 5), K)
    emitted, snapshots = [], []
    for com, comlen, _, _ in trace:
        emitted.extend(com[0, : int(comlen[0])].tolist())
        snapshots.append(list(emitted))
    for a, b in zip(snapshots, snapshots[1:]):
        assert b[: len(a)] == a


@pytest.mark.parametrize("use_lm", [False, True])
@pytest.mark.parametrize("U,chunks", [(64, [5, 1, 9, 7, 3, 6]), (8, [6, 6, 6, 6, 7])])
def test_every_committed_array_equals_jax(use_lm, U, chunks):
    rng = np.random.default_rng(11)
    T, B, V, K = sum(chunks), 3, 7, 4
    logits = rng.normal(0, 1.5, (T, B, V)).astype(np.float32)
    lengths = np.asarray([T, 17, 4], np.int32)
    jlm, tlm = _lm(V, seed=5) if use_lm else (None, None)
    w = 0.6 if use_lm else 0.0
    _, got = _run_stream(logits, lengths, chunks, K, U=U, lm=tlm, lm_weight=w)
    want = _run_jax_stream(logits, lengths, chunks, K, U=U, lm=jlm, lm_weight=w)
    for i, (g, r) in enumerate(zip(got, want)):
        for a, b in zip(g, r):
            np.testing.assert_array_equal(a, b, err_msg=f"chunk {i}")
