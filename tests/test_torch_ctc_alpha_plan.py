"""The checkpoint forward's launch geometry (``ops/ctc_kernel.py``
``alpha_ckpt_geometry``) and its bookkeeping, without a card.

The kernel (``csrc/ctc.cu`` ``ctc_alpha_ckpt``) gives each compute thread
``states`` consecutive extended states in registers, one producer warp
beside them and a ring of slots of four log-prob rows in shared memory.
The geometry is decided in Python from S and V alone: the fewest states a
thread whose warps cover S within one block, the ring's depth and the
shared bytes, and a rejection where no block can hold the recursion.

The walk below repeats, in plain PyTorch, the kernel's order of work over
the rows of a ragged batch: each row's recursion stops after its last live
step (``t_end``), checkpoints are stored at (t + 1) % K == 0 while it runs,
and the frozen row fills the checkpoints from t_end // K on and ``last``.
It uses the plain version's own step (``_alpha_step`` on the whole batch,
with ``live`` as the stop), so it must equal ``alpha_plain`` bit for bit:
an error in those indices would show as a checkpoint off by a block.
"""

import numpy as np
import pytest
import torch

from rnn_speech_tpu_torch.ops import ctc_kernel as tck
from rnn_speech_tpu_torch.ops.ctc import _alpha_init, _alpha_step


@pytest.mark.parametrize("S,states,threads", [(1, 2, 32), (3, 2, 32), (13, 2, 32),
                                              (501, 2, 256), (1201, 2, 608),
                                              (1984, 2, 992), (1985, 4, 512),
                                              (3968, 4, 992), (3969, 8, 512),
                                              (7936, 8, 992)])
def test_states_a_thread_and_threads_cover_s(S, states, threads):
    """The fewest states a thread (2, 4, 8) whose whole warps cover S in at
    most 992 compute threads; at the default step's S = 1201 (labels of up
    to 600) two states a thread in 19 warps."""
    geo = tck.alpha_ckpt_geometry(S, 80)
    assert (geo.states, geo.threads) == (states, threads)
    assert geo.threads % 32 == 0 and geo.threads * geo.states >= S
    assert geo.threads - 32 < -(-S // geo.states) <= geo.threads
    assert geo.threads + 32 <= 1024                  # the producer warp on top


@pytest.mark.parametrize("S", [1, 13, 251, 501, 1001, 1201])
def test_ring_and_shared_bytes_at_v80(S):
    """At V = 80 the ring keeps its 8 slots of 4 rows (10 KiB) and the
    block's shared memory stays about 11 KiB: the barriers, the edges, the
    ring."""
    geo = tck.alpha_ckpt_geometry(S, 80)
    assert geo.ring == tck.ALPHA_RING == 8 and tck.ALPHA_SLOT_ROWS == 4
    assert geo.smem == 16 * 8 + 16 * (geo.threads // 32) + 4 * 8 * 4 * 80
    assert geo.smem == tck.alpha_ckpt_smem_bytes(geo.threads, geo.ring, 80)
    assert geo.smem <= 11 * 1024
    if S == 1201:
        assert geo.smem == 128 + 16 * 19 + 10240


def test_ring_halves_for_wide_vocabularies_and_rejects_past_the_limit():
    """A vocabulary whose 8 slots do not fit halves the ring (at least 2
    slots); past that, and past 8 states on 992 threads, the geometry
    raises instead of launching what cannot run."""
    geo = tck.alpha_ckpt_geometry(1201, 3000)
    assert geo.ring == 4 and geo.smem <= tck.SMEM_LIMIT
    assert tck.alpha_ckpt_smem_bytes(geo.threads, 2 * geo.ring, 3000) > tck.SMEM_LIMIT
    with pytest.raises(ValueError):
        tck.alpha_ckpt_geometry(1201, 40000)
    with pytest.raises(ValueError):
        tck.alpha_ckpt_geometry(992 * 8 + 1, 80)


def _walk(log_probs, ext, skip_ok, ll, ul, K):
    """(checkpoints, last) in the kernel's order of work: each row computes
    its steps 1 .. t_end - 1 (t_end = min(T, max(logit_len, 1))), stores its
    row into checkpoint t // K where (t + 1) % K == 0, then writes its last
    computed row into checkpoints t_end // K .. NI - 1 and last."""
    T, B, _ = log_probs.shape
    S = ext.shape[1]
    NI = -(-T // K)
    states = torch.arange(S)[None, :] < (2 * ul + 1)[:, None]
    t_end = torch.clamp(ll, min=1).clamp(max=T)
    ck = torch.full((NI, B, S), float("nan"))
    a = _alpha_init(log_probs[0].gather(1, ext), states)
    if K == 1:
        ck[0] = a
    for t in range(1, T):
        run = t < t_end
        a = _alpha_step(a, log_probs[t].gather(1, ext), skip_ok, run, states)
        if (t + 1) % K == 0:
            ck[t // K, run] = a[run]
    for b in range(B):
        ck[int(t_end[b]) // K:, b] = a[b]
    return ck, a


@pytest.mark.parametrize("K", [1, 2, 4, 8, 32])
def test_kernel_order_walk_equals_the_plain_recursion(K):
    """Ragged rows: input lengths 0, 1, T, at and around block ends, and
    shorter than the row's 2U + 1 states; label lengths 0 .. U.  Every
    checkpoint and the last row equal ``alpha_plain``'s bit for bit."""
    rng = np.random.default_rng(K)
    T, V, U = 37, 11, 7
    ll = torch.as_tensor([T, 0, 1, 8, 9, 16, 31, 32, 33, 5, 12, T - 1])
    ul = torch.as_tensor([7, 0, 1, 2, 3, 4, 5, 6, 7, 6, 0, 3])
    B = len(ll)
    logits = torch.as_tensor(rng.normal(0, 2, (T, B, V)).astype(np.float32))
    labels = torch.as_tensor(rng.integers(0, V - 1, (B, U)))
    labels[torch.arange(U)[None, :] >= ul[:, None]] = -1
    log_probs, ext, skip_ok, ll, ul, _ = tck._setup(logits, ll, labels, ul, -1)
    ck, last = _walk(log_probs, ext, skip_ok, ll, ul, K)
    ref_ck, ref_last = tck.alpha_plain(log_probs, ext, skip_ok, ll, ul, K, True)
    assert torch.equal(ck, ref_ck) and torch.equal(last, ref_last)
