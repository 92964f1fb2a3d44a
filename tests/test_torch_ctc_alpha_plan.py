"""The alpha forward's launch geometry (``ops/ctc_kernel.py``
``alpha_geometry``) and its bookkeeping in its three output modes, without
a card.

The kernel (``csrc/ctc.cu`` ``ctc_alpha_fwd``) gives each compute thread
``states`` consecutive extended states in registers, one producer warp
beside them and a ring of slots of four log-prob rows in shared memory.
The geometry is decided in Python from S and V alone, the same for the
last row alone, the checkpoints and the stream: the fewest states a
thread whose warps cover S within one block, the ring's depth and the
shared bytes, and a rejection where no block can hold the recursion.

The walk below repeats, in plain PyTorch, the kernel's order of work over
the rows of a ragged batch: each row's recursion stops after its last live
step (``t_end``), output rows are stored at (t + 1) % K == 0 while it runs
(every step for the stream, never for the last row alone), the frozen row
fills the output rows from t_end // K on and ``last``, and the states of
the warps past a row's live ones are written -1e30 apart.  It uses the
plain version's own step (``_alpha_step`` on the whole batch, with ``live``
as the stop), so it must equal ``alpha_plain`` and ``alpha_stream_plain``
bit for bit: an error in those indices would show as a row off by a block
or a state left unwritten.
"""

import contextlib

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
    geo = tck.alpha_geometry(S, 80)
    assert (geo.states, geo.threads) == (states, threads)
    assert geo.threads % 32 == 0 and geo.threads * geo.states >= S
    assert geo.threads - 32 < -(-S // geo.states) <= geo.threads
    assert geo.threads + 32 <= 1024                  # the producer warp on top


@pytest.mark.parametrize("S", [1, 13, 251, 501, 1001, 1201])
def test_ring_and_shared_bytes_at_v80(S):
    """At V = 80 the ring keeps its 8 slots of 4 rows (10 KiB) and the
    block's shared memory stays about 11 KiB: the barriers, the edges, the
    ring."""
    geo = tck.alpha_geometry(S, 80)
    assert geo.ring == tck.ALPHA_RING == 8 and tck.ALPHA_SLOT_ROWS == 4
    assert geo.smem == 16 * 8 + 16 * (geo.threads // 32) + 4 * 8 * 4 * 80
    assert geo.smem == tck.alpha_smem_bytes(geo.threads, geo.ring, 80)
    assert geo.smem <= 11 * 1024
    if S == 1201:
        assert geo.smem == 128 + 16 * 19 + 10240


def test_ring_halves_for_wide_vocabularies_and_rejects_past_the_limit():
    """A vocabulary whose 8 slots do not fit halves the ring (at least 2
    slots); past that, and past 8 states on 992 threads, the geometry
    raises instead of launching what cannot run."""
    geo = tck.alpha_geometry(1201, 3000)
    assert geo.ring == 4 and geo.smem <= tck.SMEM_LIMIT
    assert tck.alpha_smem_bytes(geo.threads, 2 * geo.ring, 3000) > tck.SMEM_LIMIT
    with pytest.raises(ValueError):
        tck.alpha_geometry(1201, 40000)
    with pytest.raises(ValueError):
        tck.alpha_geometry(992 * 8 + 1, 80)


def _walk(log_probs, ext, skip_ok, ll, ul, K, P):
    """(output rows, last) in the kernel's order of work at P states a
    thread: K = 0 the last row only (no rows), K = 1 every row (the
    stream), else a checkpoint every K steps.  Each row computes its steps
    1 .. t_end - 1 (t_end = min(T, max(logit_len, 1))), its live warps
    storing their states below d0 = 32·nwa·P into output row t // K where
    (t + 1) % K == 0, then their last computed row into rows t_end // K ..
    NI - 1 and last; the warps past the row's nwa live ones write -1e30
    into states d0 .. S - 1 of every row and of last.  Unwritten entries
    stay NaN."""
    T, B, _ = log_probs.shape
    S = ext.shape[1]
    NI = -(-T // K) if K else 0
    states = torch.arange(S)[None, :] < (2 * ul + 1)[:, None]
    t_end = torch.clamp(ll, min=1).clamp(max=T)
    nwa = (-(-(2 * ul + 1).clamp(max=S) // P) + 31) // 32
    d0 = 32 * nwa * P
    out = torch.full((NI, B, S), float("nan"))
    last = torch.full((B, S), float("nan"))
    live = torch.arange(S)[None, :] < d0[:, None]          # (B, S): a live warp's state
    a = _alpha_init(log_probs[0].gather(1, ext), states)
    if K == 1:
        out[0][live] = a[live]
    for t in range(1, T):
        run = t < t_end
        a = _alpha_step(a, log_probs[t].gather(1, ext), skip_ok, run, states)
        if K and (t + 1) % K == 0:
            m = run[:, None] & live
            out[t // K][m] = a[m]
    for b in range(B):
        n = int(d0[b])
        out[int(t_end[b]) // K if K else NI:, b, :n] = a[b, :n]
        out[:, b, n:] = -1e30
        last[b, :n] = a[b, :n]
        last[b, n:] = -1e30
    return (out if K else None), last


WALK_CASES = [pytest.param("ckpt", K, id=str(K)) for K in (1, 2, 4, 8, 32)] + [
    pytest.param("last", 0, id="last"), pytest.param("stream", 1, id="stream")]


@pytest.mark.parametrize("mode,K", WALK_CASES)
def test_kernel_order_walk_equals_the_plain_recursion(mode, K):
    """The three output modes on ragged rows: input lengths 0, 1, T, at and
    around block ends, and shorter than the row's 2U + 1 states; label
    lengths 0 .. U (rows whose warps past the first hold no live state),
    at 2, 4 and 8 states a thread.  Every checkpoint, every row of the
    stream and the last row equal ``alpha_plain``'s and
    ``alpha_stream_plain``'s bit for bit, dead states included."""
    rng = np.random.default_rng(K + 7 * len(mode))
    T, V, U = 37, 11, 70
    ll = torch.as_tensor([T, 0, 1, 8, 9, 16, 31, 32, 33, 5, 12, T - 1, T, 20])
    ul = torch.as_tensor([7, 0, 1, 2, 3, 4, 5, 6, 7, 6, 0, 3, 70, 45])
    B = len(ll)
    logits = torch.as_tensor(rng.normal(0, 2, (T, B, V)).astype(np.float32))
    labels = torch.as_tensor(rng.integers(0, V - 1, (B, U)))
    labels[torch.arange(U)[None, :] >= ul[:, None]] = -1
    log_probs, ext, skip_ok, ll, ul, _ = tck._setup(logits, ll, labels, ul, -1)
    S = ext.shape[1]
    if mode == "stream":
        ref = tck.alpha_stream_plain(log_probs, ext, skip_ok, ll, ul)
    else:
        ref = tck.alpha_plain(log_probs, ext, skip_ok, ll, ul, max(K, 1), mode == "ckpt")
    for P in tck.ALPHA_STATES:
        assert 32 * (-(-(-(-S // P)) // 32)) * P >= S
        out, last = _walk(log_probs, ext, skip_ok, ll, ul, K, P)
        assert torch.equal(last, ref[1]), P
        assert out is None if mode == "last" else torch.equal(out, ref[0]), P


class _FakeEntry:
    """Stands in for ``rst_ctc_alpha_fwd``: records each launch's arguments."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("S,V", [(13, 80), (1201, 80), (1985, 80), (1201, 3000)])
def test_each_mode_launches_the_one_geometry_with_its_output(S, V, monkeypatch):
    """The launch in each output mode: the same geometry (states, threads,
    ring: the shared memory does not depend on the mode), K = 1 and no
    output rows for the last row alone, K = 1 and (T, B, S) rows for the
    stream, K and (ceil(T/K), B, S) rows for the checkpoints; the wrapper
    raises on a non-zero return."""
    entry = _FakeEntry()
    lib = type("Lib", (), {"rst_ctc_alpha_fwd": entry})()
    monkeypatch.setattr(tck, "_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("Stream", (), {"cuda_stream": 0})())
    T, B = 7, 3
    log_probs = torch.zeros((T, B, V))
    ext = torch.zeros((B, S), dtype=torch.int64)
    args = (log_probs, ext, torch.zeros((B, S), dtype=torch.bool),
            torch.full((B,), T), torch.ones((B,), dtype=torch.int64))
    geo = tck.alpha_geometry(S, V)
    K = 4
    outs = {k: tck._alpha_launch(*args, k) for k in (0, 1, K)}
    for (k, (rows, last)), call in zip(outs.items(), entry.calls):
        assert call[7:12] == (T, B, S, V, max(k, 1))
        assert call[12:15] == (geo.states, geo.threads, geo.ring)
        assert (call[5] is None) == (k == 0) and call[15] == 0
        assert last.shape == (B, S)
        assert rows is None if k == 0 else rows.shape == (-(-T // k), B, S)
    tck._alpha_launch(*args, 1, fault_step=3)
    assert entry.calls[-1][15] == 3
    monkeypatch.setattr(lib, "rst_ctc_alpha_fwd", lambda *a: 1)
    with pytest.raises(RuntimeError):
        tck._alpha_launch(*args, 0)
