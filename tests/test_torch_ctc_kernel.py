"""The plain versions of the port's CTC kernels (``ops/ctc_kernel.py``)
against the JAX package's Pallas CTC (``ctc_pallas.ctc_loss``, run in TPU
interpret mode), the port's scan CTC and ``torch.nn.functional.ctc_loss``.

Inputs from numpy seeds, with ragged rows, repeated labels (the s-2 skip
barred), an empty label, a label longer than its input (an invalid row)
and a zero-length input.

Tolerances, stated per comparison:
* against the port's scan CTC: the same float32 log-space recursion;
  only the order in which the posteriors of a label's states are summed
  differs, so loss and gradient agree to 1e-5 (relative and absolute);
* against JAX with float32 posteriors: the same recursion, but JAX sums
  the posteriors per label with a two-term bf16 split matmul
  (``_split_matmul``), exact to about 2^-16 relative, hence 5e-5 on
  gradients (losses 1e-5);
* against JAX with its bf16 posterior stream (what the JAX step runs for
  bf16 models): each posterior is rounded to 2^-9 relative before the
  sum, so 1e-2 absolute on gradients of magnitude <= 1 (the port keeps
  float32 posteriors, closer to exact); losses do not depend on it, 1e-5;
* ``torch.nn.functional.ctc_loss``: an independent implementation in
  another order, 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rnn_speech_tpu.ops import ctc_pallas as jctc_pallas
from rnn_speech_tpu_torch.ops import ctc as tctc
from rnn_speech_tpu_torch.ops import ctc_kernel as tck

SAME_ALGO = dict(rtol=1e-5, atol=1e-5)
JAX_SPLIT = dict(rtol=5e-5, atol=5e-5)
BF16_POST = dict(rtol=0, atol=1e-2)
INDEPENDENT = dict(rtol=1e-4, atol=1e-4)


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


def _port(fn, args, g):
    logits, ll, labels, ul = args
    z = torch.tensor(logits, requires_grad=True)
    loss = fn(z, torch.as_tensor(ll), torch.as_tensor(labels), torch.as_tensor(ul))
    loss.backward(torch.as_tensor(g))
    return loss.detach().numpy(), z.grad.numpy()


def _jax(args, g, post_dtype=jnp.float32):
    logits, ll, labels, ul = args
    fn = lambda z: jctc_pallas.ctc_loss(z, jnp.asarray(ll), jnp.asarray(labels),
                                        jnp.asarray(ul), -1, post_dtype)
    with pltpu.force_tpu_interpret_mode():
        loss, vjp = jax.vjp(fn, jnp.asarray(logits))
        grad = vjp(jnp.asarray(g))[0]
    return np.asarray(loss), np.asarray(grad)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_kernels_match_jax_pallas_ctc(seed):
    args, g = _batch(seed)
    ref_loss, ref_grad = _jax(args, g)
    loss, grad = _port(tck.ctc_loss, args, g)
    np.testing.assert_allclose(loss, ref_loss, **SAME_ALGO)
    np.testing.assert_allclose(grad, ref_grad, **JAX_SPLIT)
    assert loss[3] == 0.0 and loss[4] == 0.0          # invalid and empty-input rows
    assert not grad[:, 3].any() and not grad[:, 4].any()
    assert not grad[13:, 1].any()                     # frames past the length
    assert np.isfinite(loss[2]) and loss[2] > 0       # empty label


def test_plain_kernels_match_jax_bf16_posterior_stream():
    args, g = _batch(2)
    ref_loss, ref_grad = _jax(args, g, jnp.bfloat16)
    loss, grad = _port(tck.ctc_loss, args, g)
    np.testing.assert_allclose(loss, ref_loss, **SAME_ALGO)
    np.testing.assert_allclose(grad, ref_grad, **BF16_POST)


def test_plain_kernels_match_jax_chunked_small_blocks(monkeypatch):
    """The JAX kernels time-chunked and at K = 8 (the port's K is 32):
    checkpoints and blocks fall elsewhere, the result may not move."""
    monkeypatch.setenv("RST_CTC_CHUNKED", "force")
    monkeypatch.setenv("RST_CTC_KBLOCK", "8")
    args, g = _batch(3, T=37)
    ref_loss, ref_grad = _jax(args, g)
    loss, grad = _port(tck.ctc_loss, args, g)
    np.testing.assert_allclose(loss, ref_loss, **SAME_ALGO)
    np.testing.assert_allclose(grad, ref_grad, **JAX_SPLIT)


@pytest.mark.parametrize("K", [1, 4, 32])
def test_plain_kernels_match_the_scan_ctc(monkeypatch, K):
    """The port's scan CTC (``ops/ctc.py``) at several checkpoint blocks."""
    monkeypatch.setattr(tck, "ctc_block", lambda S, V: K)
    args, g = _batch(4 + K)
    ref_loss, ref_grad = _port(tctc.ctc_loss, args, g)
    loss, grad = _port(tck.ctc_loss, args, g)
    np.testing.assert_allclose(loss, ref_loss, **SAME_ALGO)
    np.testing.assert_allclose(grad, ref_grad, **SAME_ALGO)


def test_plain_kernels_match_torch_nn_functional_ctc_loss():
    (logits, ll, labels, ul), _ = _batch(5)
    keep = (ul <= ll) & (ll > 0)
    loss, grad = _port(tck.ctc_loss, (logits, ll, labels, ul), np.ones(7, np.float32))
    z = torch.tensor(logits, requires_grad=True)
    ref = torch.nn.functional.ctc_loss(
        torch.log_softmax(z, -1), torch.as_tensor(np.maximum(labels, 0)),
        torch.as_tensor(ll), torch.as_tensor(ul), blank=logits.shape[-1] - 1,
        reduction="none", zero_infinity=True)
    ref[torch.as_tensor(keep)].sum().backward()
    np.testing.assert_allclose(loss[keep], ref.detach().numpy()[keep], **INDEPENDENT)
    np.testing.assert_allclose(grad[:, keep], z.grad.numpy()[:, keep], **INDEPENDENT)


def test_loss_only_kernel_serves_the_no_grad_loss():
    """Without a gradient the loss comes from the loss-only recursion, and
    it equals the training forward's loss exactly (the same recursion);
    the checkpoints' last row is the last alpha row."""
    (logits, ll, labels, ul), _ = _batch(6)
    args = (torch.as_tensor(logits), torch.as_tensor(ll), torch.as_tensor(labels),
            torch.as_tensor(ul))
    with torch.no_grad():
        eval_loss = tck.ctc_loss(*args)
    train_loss = tck.ctc_loss(args[0].clone().requires_grad_(True), *args[1:])
    assert torch.equal(eval_loss, train_loss.detach())
    log_probs, ext, skip_ok, tl, ul_t, _ = tck._setup(*args, -1)
    ckpts, last = tck.ctc_alpha_ckpt(log_probs, ext, skip_ok, tl, ul_t, 8)
    assert ckpts.shape == (3, 7, 13) and torch.equal(ckpts[-1], last)
    assert torch.equal(tck.ctc_alpha_lossonly(log_probs, ext, skip_ok, tl, ul_t), last)
    # States past 2·label_length + 1 stay at the -1e30 sentinel.
    assert bool((last[2, 1:] == tck.NEG_INF).all())


def test_empty_time_axis_and_all_empty_labels():
    z = torch.zeros((0, 2, 5), requires_grad=True)
    loss = tck.ctc_loss(z, torch.as_tensor([0, 0]), torch.full((2, 3), -1),
                        torch.as_tensor([0, 0]))
    loss.sum().backward()
    assert loss.tolist() == [0.0, 0.0] and z.grad.shape == z.shape
    (logits, ll, _, _), g = _batch(7)
    args = (logits, ll, np.zeros((7, 0), np.int32), np.zeros(7, np.int32))
    ref = _port(tctc.ctc_loss, args, g)
    got = _port(tck.ctc_loss, args, g)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, **SAME_ALGO)


def test_label_lists_sort_live_states_by_label():
    """The live odd (label) states of each row, grouped by label in
    ascending s; the blank's even states are not listed."""
    ext = torch.as_tensor([[4, 1, 4, 1, 4, 2, 4], [4, 3, 4, 0, 4, 0, 4]])
    offs, idx = tck.label_lists(ext, torch.as_tensor([3, 1]), 5)
    for b in range(2):
        S_b = 2 * [3, 1][b] + 1
        for v in range(5):
            got = idx[b, offs[b, v]:offs[b, v + 1]].tolist()
            want = [s for s in range(1, S_b, 2) if int(ext[b, s]) == v]
            assert got == want


def test_checkpoint_block_fits_shared_memory():
    """K = 32 at the flagship S = 1201 (154 KB of rebuilt rows), fewer
    steps where the rows would not fit, an error where none fits."""
    assert tck.ctc_block(1201, 80) == 32
    assert tck.ctc_block(3001, 80) < 32
    with pytest.raises(ValueError):
        tck.ctc_block(20001, 80)


def test_alpha_checkpoints_match_jax_on_ragged_rows(monkeypatch):
    """The checkpoint forward's plain version against the JAX training
    forward's own checkpoints (``_alpha_kernel_ckpt`` in TPU interpret
    mode, the JAX tests' CPU route), block for block at K = 8: input
    lengths from 1 to T (rows shorter than their 2U + 1 states among them),
    label lengths from 0 to U.  Only the live states s < 2·label_length + 1
    are compared (the port leaves the others at the -1e30 sentinel); the
    same float32 recursion: 1e-5."""
    monkeypatch.setenv("RST_CTC_KBLOCK", "8")
    monkeypatch.setenv("RST_CTC_CHUNKED", "0")
    rng = np.random.default_rng(12)
    T, V, U = 23, 9, 6
    ll = np.asarray([T, 1, 5, 11, T - 1, 2, 17, 9, 13, 8], np.int32)
    ul = np.asarray([0, 1, 2, 3, 4, 5, 6, 6, 3, 1], np.int32)
    B = len(ll)
    logits = rng.normal(0, 2, (T, B, V)).astype(np.float32)
    labels = rng.integers(0, V - 1, (B, U)).astype(np.int32)
    labels[np.arange(U)[None, :] >= ul[:, None]] = -1
    assert (ll < 2 * ul + 1).any() and (ll < T).any()
    with pltpu.force_tpu_interpret_mode():
        loss, res = jctc_pallas._ctc_fwd_impl(jnp.asarray(logits), jnp.asarray(ll),
                                              jnp.asarray(labels), jnp.asarray(ul), -1,
                                              True)
    ref_ck = np.asarray(res[1])
    log_probs, ext, skip_ok, tl, tu, valid = tck._setup(
        torch.as_tensor(logits), torch.as_tensor(ll), torch.as_tensor(labels),
        torch.as_tensor(ul), -1)
    ck, last = tck.ctc_alpha_ckpt(log_probs, ext, skip_ok, tl, tu, 8)
    assert ck.shape == ref_ck.shape == (3, B, 2 * U + 1)
    live = np.arange(2 * U + 1)[None, :] < 2 * ul[:, None] + 1
    for i in range(ck.shape[0]):
        np.testing.assert_allclose(ck[i].numpy()[live], ref_ck[i][live], **SAME_ALGO)
        assert (ck[i].numpy()[~live] == tck.NEG_INF).all()
    assert torch.equal(ck[-1], last)
    np.testing.assert_allclose(tck._loss(last, tu, valid)[0].numpy(), np.asarray(loss),
                               **SAME_ALGO)
