"""The port's AM+LM shallow-fusion beam search against the JAX package's,
on the CPU (the counterpart of ``tests/test_fusion.py``).

A tiny char LM (1x32, V=6) is trained in JAX to prefer 1 -> 2 over 1 -> 3
and carried into the port by ``params_from_jax``.  With ``lm_weight`` 0
the port's search equals its AM-only search bit for bit; a near tie the
AM alone resolves as [1, 3] flips to [1, 2] with the LM; the search runs
batched with a zero-length row; and on numpy-seeded logits, with ragged
lengths, the port's labels and lengths equal JAX's
``beam_search_decode(lm=...)`` exactly and its fused scores agree within
1e-4 absolute (the LM's float32 forward differs from JAX's in the last
bits, and the fused score sums one LM log-prob per emitted character).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnn_speech_tpu.models import language as jlang
from rnn_speech_tpu.ops import decode as jdecode
from rnn_speech_tpu.train import optim as joptim
from rnn_speech_tpu_torch import params as tparams
from rnn_speech_tpu_torch.models import language as tlang
from rnn_speech_tpu_torch.ops import decode as tdecode

SCORE_ATOL = 1e-4


@pytest.fixture(scope="module")
def tiny_lm():
    V = 6
    cfg = jlang.LanguageConfig(num_layers=1, hidden_size=32, num_labels=V)
    params = jlang.init_params(jax.random.PRNGKey(0), cfg)
    texts = np.array([[1, 2, 1, 2, 1, 2, 1, 2]], np.int32).T
    lengths = jnp.asarray([texts.shape[0]], jnp.int32)
    opt = joptim.init_adam(params)

    @jax.jit
    def train(params, opt):
        loss, grads = jax.value_and_grad(lambda p: jlang.next_char_loss(
            p, cfg, jnp.asarray(texts), lengths, jlang.zero_state(cfg, 1)))(params)
        params, opt = joptim.adam_update(params, grads, opt, 1e-2)
        return params, opt, loss

    for _ in range(300):
        params, opt, loss = train(params, opt)
    assert float(loss) < 0.1
    tcfg = tlang.LanguageConfig(num_layers=1, hidden_size=32, num_labels=V)
    tp = tparams.params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    return (params, cfg), (tp, tcfg), V


def _ambiguous_logits(V, blank, T=8, tilt=0.05):
    """The AM slightly prefers [1, 3]; [1, 2] is a close second."""
    lg = np.full((T, 1, V), -8.0, np.float32)
    lg[:, 0, blank] = 2.0
    lg[2, 0, 1] = 6.0
    lg[5, 0, 3] = 4.0 + tilt
    lg[5, 0, 2] = 4.0 - tilt
    return lg


def test_lm_weight_zero_matches_am_only(tiny_lm):
    _, (tp, tcfg), V = tiny_lm
    logits = torch.as_tensor(np.random.default_rng(2).normal(0, 2, (16, 3, V))
                             .astype(np.float32))
    ll = torch.as_tensor([16, 9, 0])
    plain = tdecode.beam_search_decode(logits, ll, beam_width=4)
    fused = tdecode.beam_search_decode(logits, ll, beam_width=4,
                                       lm=tlang.stepper(tp, tcfg), lm_weight=0.0)
    for a, b in zip(plain, fused):
        assert torch.equal(a, b)


def test_lm_flips_near_tie(tiny_lm):
    _, (tp, tcfg), V = tiny_lm
    logits = torch.as_tensor(_ambiguous_logits(V, V - 1))
    ll = torch.as_tensor([logits.shape[0]])
    labels, lengths, _ = tdecode.beam_search_decode(logits, ll, beam_width=4)
    assert labels[0, 0, : int(lengths[0, 0])].tolist() == [1, 3]
    labels, lengths, scores = tdecode.beam_search_decode(
        logits, ll, beam_width=4, lm=tlang.stepper(tp, tcfg), lm_weight=0.8)
    assert labels[0, 0, : int(lengths[0, 0])].tolist() == [1, 2]
    assert (scores[0, 1:] <= scores[0, :-1] + 1e-5).all()      # best first


def test_fusion_runs_batched(tiny_lm):
    _, (tp, tcfg), V = tiny_lm
    rng = np.random.default_rng(0)
    T, B = 12, 3
    logits = torch.as_tensor(rng.normal(0, 2, (T, B, V)).astype(np.float32))
    labels, lengths, scores = tdecode.beam_search_decode(
        logits, torch.as_tensor([12, 7, 0]), beam_width=4,
        lm=tlang.stepper(tp, tcfg), lm_weight=0.5)
    assert labels.shape == (B, 4, T)
    assert int(lengths[2, 0]) == 0                               # the empty row
    assert torch.isfinite(scores[:, 0]).all()


@pytest.mark.parametrize("weight", [0.3, 0.8])
@pytest.mark.parametrize("seed,T,B,K,lens", [
    (0, 12, 3, 4, [12, 7, 0]),
    (1, 20, 2, 8, [20, 13]),
    (2, 9, 4, 3, [9, 1, 5, 8]),
])
def test_fused_search_matches_jax(tiny_lm, seed, T, B, K, lens, weight):
    (jp, jcfg), (tp, tcfg), V = tiny_lm
    logits = np.random.default_rng(seed).normal(0, 2, (T, B, V)).astype(np.float32)
    lens = np.asarray(lens, np.int32)
    ref = jdecode.beam_search_decode(jnp.asarray(logits), jnp.asarray(lens), beam_width=K,
                                     lm=jlang.stepper(jp, jcfg), lm_weight=weight)
    got = tdecode.beam_search_decode(torch.as_tensor(logits), torch.as_tensor(lens),
                                     beam_width=K, lm=tlang.stepper(tp, tcfg),
                                     lm_weight=weight)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=0, atol=SCORE_ATOL)
