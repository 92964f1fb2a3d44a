"""The alpha-stream CTC backward (``RST_CTC_ALPHA_STREAM=1``) of the port's
CTC kernels: the plain versions of ``ctc_alpha_stream`` and
``ctc_beta_post_stream`` against the JAX package's ``ctc_pallas.ctc_loss``
under the same switch (``_alpha_kernel`` with ``emit_alphas=True`` and
``_beta_post_kernel``, run in TPU interpret mode), and against the port's
own checkpoint route.

Inputs from numpy seeds, with ragged rows, repeated labels (the s-2 skip
barred), an empty label, a label longer than its input and a zero-length
input (``test_torch_ctc_kernel.py``'s batch).

Tolerances, as ``test_torch_ctc_kernel.py`` states them: against JAX the
same float32 recursion, losses to 1e-5; JAX sums the posteriors per label
with a two-term bf16 split matmul, exact to about 2^-16 relative, hence
5e-5 on gradients.  Against the port's checkpoint route: the same rows,
recursion and summation order, so equal bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rnn_speech_tpu.ops import ctc_pallas as jctc_pallas
from rnn_speech_tpu_torch.ops import ctc_kernel as tck

SAME_ALGO = dict(rtol=1e-5, atol=1e-5)
JAX_SPLIT = dict(rtol=5e-5, atol=5e-5)


def _batch(seed, T=21, V=7, U=6):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, (T, 7, V)).astype(np.float32)
    logit_lengths = np.asarray([T, 13, 6, 3, 0, 17, T - 1], np.int32)
    label_lengths = np.asarray([6, 4, 0, 5, 2, 5, 3], np.int32)
    labels = rng.integers(0, V - 1, (7, U)).astype(np.int32)
    labels[5, :5] = [1, 1, 2, 2, 2]
    labels[np.arange(U)[None, :] >= label_lengths[:, None]] = -1
    g = rng.uniform(0.5, 2.0, 7).astype(np.float32)
    return (logits, logit_lengths, labels, label_lengths), g


def _port(args, g):
    logits, ll, labels, ul = args
    z = torch.tensor(logits, requires_grad=True)
    loss = tck.ctc_loss(z, torch.as_tensor(ll), torch.as_tensor(labels), torch.as_tensor(ul))
    loss.backward(torch.as_tensor(g))
    return loss.detach().numpy(), z.grad.numpy()


@pytest.mark.parametrize("seed,T", [(0, 21), (1, 40)])
def test_stream_route_matches_jax_alpha_stream(seed, T, monkeypatch):
    monkeypatch.setenv("RST_CTC_ALPHA_STREAM", "1")
    (logits, ll, labels, ul), g = _batch(seed, T=T)
    fn = lambda z: jctc_pallas.ctc_loss(z, jnp.asarray(ll), jnp.asarray(labels),
                                        jnp.asarray(ul), -1, jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        ref_loss, vjp = jax.vjp(fn, jnp.asarray(logits))
        ref_grad = vjp(jnp.asarray(g))[0]
    calls = {"stream": 0, "ckpt": 0}
    for name, attr in (("stream", "ctc_beta_post_stream"), ("ckpt", "ctc_beta_post")):
        orig = getattr(tck, attr)

        def counted(*a, _orig=orig, _name=name):
            calls[_name] += 1
            return _orig(*a)
        monkeypatch.setattr(tck, attr, counted)
    loss, grad = _port((logits, ll, labels, ul), g)
    assert calls == {"stream": 1, "ckpt": 0}
    np.testing.assert_allclose(loss, np.asarray(ref_loss), **SAME_ALGO)
    np.testing.assert_allclose(grad, np.asarray(ref_grad), **JAX_SPLIT)
    assert loss[3] == 0.0 and loss[4] == 0.0          # invalid and empty-input rows
    assert not grad[:, 3].any() and not grad[:, 4].any()


def test_stream_route_equals_the_checkpoint_route(monkeypatch):
    """The same loss and gradient bit for bit: the stream's rows are the
    rebuilt rows, summed in the same order."""
    args, g = _batch(2, T=45)
    ckpt = _port(args, g)
    monkeypatch.setenv("RST_CTC_ALPHA_STREAM", "1")
    stream = _port(args, g)
    for a, b in zip(stream, ckpt):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("K", [1, 4, 8, 32])
def test_stream_rows_equal_the_checkpoints_at_every_block_end(K):
    """``alpha_stream_plain``'s row at each block end equals
    ``alpha_plain``'s checkpoint, its last row the last row, and the
    stream backward's label_post the checkpoint backward's, bit for bit."""
    args, _ = _batch(3, T=37)
    log_probs, ext, skip_ok, ll, ul, valid = tck._setup(
        *(torch.as_tensor(a) for a in args), -1)
    alphas, last = tck.ctc_alpha_stream(log_probs, ext, skip_ok, ll, ul)
    ckpts, last_ck = tck.ctc_alpha_ckpt(log_probs, ext, skip_ok, ll, ul, K)
    T = log_probs.shape[0]
    assert alphas.shape == (T,) + tuple(last.shape)
    ends = [min(T, (i + 1) * K) - 1 for i in range(ckpts.shape[0])]
    assert torch.equal(alphas[ends], ckpts) and torch.equal(last, last_ck)
    logp = tck._loss(last, ul, valid)[1]
    lists = tck.label_lists(ext, ul, log_probs.shape[-1])
    post = tck.ctc_beta_post_stream(log_probs, ext, skip_ok, ll, ul, logp, alphas, lists)
    assert torch.equal(post, tck.ctc_beta_post(log_probs, ext, skip_ok, ll, ul, logp,
                                               ckpts, K, lists))
    assert tck.ctc_alpha_stream.launches == tck.ctc_beta_post_stream.launches == 0
