"""The port's greedy CTC decoders against the JAX package's, same logits.

Decoding is discrete (argmax, collapse, compaction), so outputs must be
equal exactly; the logits are drawn with no ties."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnn_speech_tpu.ops import decode as jdecode
from rnn_speech_tpu_torch.ops import decode as tdecode


def _logits(seed, T, B, V):
    rng = np.random.default_rng(seed)
    # Few classes and a strong blank make repeats and blanks frequent.
    x = rng.normal(0, 1, (T, B, V)).astype(np.float32)
    x[..., -1] += 0.8
    return x


@pytest.mark.parametrize("max_output", [0, 3, 40])
@pytest.mark.parametrize("lengths", [[20, 0, 7, 1], [20, 20, 20, 20]])
def test_greedy_matches_jax(lengths, max_output):
    T, B, V = 20, 4, 5
    x = _logits(len(lengths) + max_output, T, B, V)
    lens = np.asarray(lengths, np.int32)
    ref, ref_len = jdecode.greedy_decode(jnp.asarray(x), jnp.asarray(lens),
                                         max_output=max_output)
    got, got_len = tdecode.greedy_decode(torch.as_tensor(x), torch.as_tensor(lens),
                                         max_output=max_output)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    np.testing.assert_array_equal(np.asarray(ref_len), got_len.numpy())


def test_stream_greedy_matches_jax():
    T, B, V = 12, 3, 4
    x = _logits(7, T, B, V)
    lens = np.asarray([12, 5, 0], np.int32)
    prev = np.asarray([-1, 2, 1], np.int32)
    ref = jdecode.greedy_stream_decode(jnp.asarray(x), jnp.asarray(lens),
                                       jnp.asarray(prev))
    got = tdecode.greedy_stream_decode(torch.as_tensor(x), torch.as_tensor(lens),
                                       torch.as_tensor(prev))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r), g.numpy())


@pytest.mark.parametrize("chunk", [1, 4, 7])
def test_chunked_stream_equals_whole_clip(chunk):
    """Feeding chunks with the carried ``prev`` and concatenating the
    outputs reproduces the whole-clip greedy decode."""
    T, B, V = 25, 3, 4
    x = torch.as_tensor(_logits(11, T, B, V))
    lens = torch.as_tensor([25, 18, 9])
    whole, whole_len = tdecode.greedy_decode(x, lens)
    prev = torch.full((B,), -1, dtype=torch.int32)
    pieces = [[] for _ in range(B)]
    for start in range(0, T, chunk):
        part = x[start : start + chunk]
        part_len = (lens - start).clamp(0, part.shape[0])
        out, out_len, prev = tdecode.greedy_stream_decode(part, part_len, prev)
        for b in range(B):
            pieces[b] += out[b, : int(out_len[b])].tolist()
    for b in range(B):
        assert pieces[b] == whole[b, : int(whole_len[b])].tolist()
