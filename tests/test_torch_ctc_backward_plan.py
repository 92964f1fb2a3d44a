"""The redesigned CTC backward kernels' plan, on the CPU: the shared-memory
layout of one K-row alpha buffer (``ctc_kernel.beta_smem_bytes``, which
``ctc_block`` sizes K by), the odd-state label lists the kernels walk
(``label_lists``: the blank's even states are summed by a tree), built
once in the loss's forward and handed to its backward, and the loss and
gradient through that wiring against the JAX package's Pallas CTC in TPU
interpret mode at ragged label lengths, 0 and U among them.

Tolerances: as ``tests/test_torch_ctc_kernel.py`` states them (the same
float32 recursion; JAX sums the posteriors per label with a two-term bf16
split matmul, 5e-5 on gradients, 1e-5 on losses); the label sums of the
kernels' order against ``scatter_add`` over all states: float32 sums of
at most a few hundred terms of magnitude <= 1 in another order, 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rnn_speech_tpu.ops import ctc_pallas as jctc_pallas
from rnn_speech_tpu_torch.ops import ctc_kernel as tck

SMEM_OPT_IN = 232448          # bytes of shared memory a block may use on the H100
SAME_ALGO = dict(rtol=1e-5, atol=1e-5)
JAX_SPLIT = dict(rtol=5e-5, atol=5e-5)


def _old_ctc_block(S, V):
    """``ctc_block`` as it stood before the redesign (two posterior rows of
    S float32): the (S, V) it accepted must still be accepted."""
    fixed = 4 * (4 * S + 4) + 4 * (2 * S + V + 1) + S
    K = 32
    while K > 1 and fixed + 4 * K * S > tck.SMEM_LIMIT:
        K //= 2
    if fixed + 4 * K * S > tck.SMEM_LIMIT:
        raise ValueError
    return K


@pytest.mark.parametrize("V", [2, 29, 80, 256])
def test_backward_shared_memory_fits_wherever_the_old_plan_did(V):
    """Every S the old plan accepted is accepted, with its K (or more), and
    the backward's buffer fits the H100's opt-in limit; past its own limit
    the plan raises."""
    S = 1
    while True:
        try:
            old = _old_ctc_block(S, V)
        except ValueError:
            break
        K = tck.ctc_block(S, V)
        assert K >= old and K in (1, 2, 4, 8, 16, 32)
        assert tck.beta_smem_bytes(S, V, K) <= min(tck.SMEM_LIMIT, SMEM_OPT_IN)
        assert tck.beta_smem_bytes(S, V, 0) < tck.beta_smem_bytes(S, V, K)
        S += 97
    top = S
    while tck.beta_smem_bytes(top, V, 1) <= tck.SMEM_LIMIT:
        top += 1
    with pytest.raises(ValueError):
        tck.ctc_block(top, V)
    assert tck.ctc_block(top - 1, V) == 1


def test_flagship_block_keeps_32_steps():
    """S = 1201 (labels of 600): K = 32 in one buffer of 154 KB, as the
    checkpoint kernel stored them before (one K-row buffer, refilled in
    the order beta frees it, instead of two)."""
    assert tck.ctc_block(1201, 80) == 32
    assert tck.beta_smem_bytes(1201, 80, 32) <= tck.SMEM_LIMIT


def _ext(seed, B=6, U=9, V=7):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, V - 1, (B, U))
    ul = np.asarray([0, 1, U, 4, U - 1, 2])[:B]
    labels[np.arange(U)[None, :] >= ul[:, None]] = -1
    ext, _ = tck._prepare(torch.as_tensor(labels), V - 1)
    return ext, torch.as_tensor(ul), V


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernel_lists_hold_each_labels_odd_states_in_order(seed):
    ext, ul, V = _ext(seed)
    offs, idx = tck.label_lists(ext, ul, V)
    for b in range(ext.shape[0]):
        live = 2 * int(ul[b]) + 1
        assert int(offs[b, V]) == int(ul[b])         # every live odd state, no even one
        for v in range(V):
            got = idx[b, offs[b, v]:offs[b, v + 1]].tolist()
            assert got == [s for s in range(1, live, 2) if int(ext[b, s]) == v]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_blank_tree_plus_label_walks_equal_the_sum_over_all_states(seed):
    """The kernels' label sums in their order (the blank: every even live
    state, summed in the thread / warp / block tree of 256 threads; the
    other labels: their odd lists in order) equal scatter_add over all
    live states."""
    ext, ul, V = _ext(seed)
    B, S = ext.shape
    post = torch.rand((B, S), generator=torch.Generator().manual_seed(seed))
    post = torch.where(tck._live_states(ul, S), post, 0.0)
    ref = torch.zeros((B, V)).scatter_add_(1, ext, post)
    offs, idx = tck.label_lists(ext, ul, V)
    blank = int(ext[0, 0])
    for b in range(B):
        part = torch.zeros(256)                      # each thread's even states in order
        for s in range(0, S, 2):
            part[s % 256] += post[b, s]
        warps = part.reshape(8, 32).sum(1)           # the shuffle tree's warp sums
        tree = sum(float(w) for w in warps)          # the eight warps in order
        for v in range(V):
            walk = sum(float(post[b, s]) for s in idx[b, offs[b, v]:offs[b, v + 1]].tolist())
            got = walk + (tree if v == blank else 0.0)
            assert abs(got - float(ref[b, v])) <= 1e-6


def test_loss_forward_saves_the_lists_its_backward_uses(monkeypatch):
    """The lists are built once in ``_CTCKernelLoss.forward`` and the
    backward hands them to the backward kernel; they equal ``label_lists``
    of the batch."""
    seen = []
    real = tck.ctc_beta_post

    def spy(*args):
        seen.append(args[-1])
        return real(*args)

    monkeypatch.setattr(tck, "ctc_beta_post", spy)
    args, g = _batch(3)
    logits, ll, labels, ul = args
    z = torch.tensor(logits, requires_grad=True)
    tck.ctc_loss(z, torch.as_tensor(ll), torch.as_tensor(labels),
                 torch.as_tensor(ul)).backward(torch.as_tensor(g))
    assert len(seen) == 1
    log_probs, ext, _, _, ul_t, _ = tck._setup(z, torch.as_tensor(ll), torch.as_tensor(labels),
                                               torch.as_tensor(ul), -1)
    want = tck.label_lists(ext, ul_t, logits.shape[-1])
    assert all(torch.equal(a, b) for a, b in zip(seen[0], want))


def _batch(seed, T=23, V=7, U=6):
    rng = np.random.default_rng(seed)
    B = 7
    logits = rng.normal(0, 2, (T, B, V)).astype(np.float32)
    ll = np.asarray([T, 13, 6, 3, 0, 17, T - 1], np.int32)
    ul = np.asarray([6, 0, 1, 5, 2, 6, 3], np.int32)       # 0, 1 and U among them
    labels = rng.integers(0, V - 1, (B, U)).astype(np.int32)
    labels[np.arange(U)[None, :] >= ul[:, None]] = -1
    return (logits, ll, labels, ul), rng.uniform(0.5, 2.0, B).astype(np.float32)


@pytest.mark.parametrize("stream", [False, True], ids=["checkpoints", "alpha stream"])
@pytest.mark.parametrize("seed", [0, 5])
def test_loss_and_gradient_match_jax_pallas_ctc(monkeypatch, seed, stream):
    """The port's CTC loss and gradient, its backward fed the forward's
    saved lists (checkpoint route and RST_CTC_ALPHA_STREAM=1), against
    ``ctc_pallas.ctc_loss`` in TPU interpret mode."""
    monkeypatch.setenv("RST_CTC_ALPHA_STREAM", "1" if stream else "0")
    (logits, ll, labels, ul), g = _batch(seed)
    fn = lambda z: jctc_pallas.ctc_loss(z, jnp.asarray(ll), jnp.asarray(labels),
                                        jnp.asarray(ul), -1, jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        ref_loss, vjp = jax.vjp(fn, jnp.asarray(logits))
        ref_grad = vjp(jnp.asarray(g))[0]
    z = torch.tensor(logits, requires_grad=True)
    loss = tck.ctc_loss(z, torch.as_tensor(ll), torch.as_tensor(labels), torch.as_tensor(ul))
    loss.backward(torch.as_tensor(g))
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(ref_loss), **SAME_ALGO)
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(ref_grad), **JAX_SPLIT)
