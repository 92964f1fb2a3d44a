"""CTC loss on the CTC kernels: CUDA kernels, wrappers, plain versions.

Counterpart of ``rnn_speech_tpu/ops/ctc_pallas.py``, the CTC that the JAX
train step runs with ``use_pallas_ctc``.  Two kernels in ``csrc/ctc.cu``
replace its five: one alpha forward (``alpha_geometry``: states in
registers, log-prob rows ahead of the chain in a shared ring, the
recursion stopped at each row's last live step) in three output modes,
and the beta/posterior backward in two.  On the default route:

* ``ctc_alpha_ckpt`` (``_alpha_kernel_ckpt``): the alpha recursion, one
  (B, S) float32 checkpoint per K steps and the last row;
* ``ctc_alpha_lossonly`` (``_alpha_kernel_lossonly``): the last row only;
* ``ctc_beta_post`` (``_beta_post_ckpt_kernel``): each K-step block's
  alpha rows rebuilt from its checkpoint (by a second thread group, beside
  beta's pass over the block before), beta in the bstar = beta + lp form
  and the state posteriors, summed per vocabulary entry into label_post
  (T, B, V): the blank's even states by a fixed tree, the other labels by
  their lists of odd states (``label_lists``, built once in the loss's
  forward and saved for its backward);

and on the alpha-stream backward (``RST_CTC_ALPHA_STREAM=1``):

* ``ctc_alpha_stream`` (``_alpha_kernel``, ``emit_alphas=True``): every
  alpha row into a (T, B, S) float32 stream (checkpoints of one step), and
  the last row;
* ``ctc_beta_post_stream`` (``_beta_post_kernel``): beta and the
  per-label posterior sums as ``ctc_beta_post``, each alpha row read from
  the stream.

The three forwards' rows equal each other bit for bit.

``ctc_loss`` is an ``autograd.Function``: without a gradient its forward
runs the alpha forward for the last row only, with one for the
checkpoints, and its backward the fused rebuild/beta/posterior kernel (or,
with ``RST_CTC_ALPHA_STREAM=1``, the forward re-run as a stream and the
stream backward, as the JAX ``_ctc_bwd`` does); then the gradient is
exp(log_probs) - label_post, zero past each row's length and on invalid
rows, times the cotangent (``ctc_grad``).  The plain versions take their
recursion steps from ``ops/ctc.py`` (``_prepare``'s extended labels and
skip rules, the -1e30 sentinel, ``_alpha_step``/``_beta_step`` on
``_log_add3``, ``_terminal_logp``, ``ignore_longer_outputs_than_inputs``);
only the live-state restriction and the checkpoint blocks are their own.

Against the TPU kernels: the lattice log_probs[t, b, ext[b, s]] is
gathered inside the kernels (no one-hot matmul, no time chunks), the
posteriors stay float32 (the JAX step's bf16 posterior stream exists to
save TPU memory), and only each row's live states s < 2·label_length + 1
are computed; the others stay at -1e30 in the checkpoints and the last
row (they cannot reach the terminal states, and their posteriors are 0
in the TPU kernels as well).

Each wrapper takes the plain version for tensors on the CPU and launches
its kernel for tensors on a CUDA device, or raises; there is no fallback.
``<wrapper>.launches`` counts the calls that launched the kernel.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple, Optional, Tuple

import torch

from rnn_speech_tpu_torch import stages
from rnn_speech_tpu_torch.ops import _build
from rnn_speech_tpu_torch.ops.ctc import (NEG_INF, _alpha_init, _alpha_step, _beta_setup,
                                         _beta_step, _prepare, _terminal_logp, ctc_grad)

Tensor = torch.Tensor
f32 = torch.float32
K_MAX = 32                   # time steps per checkpoint block
SMEM_LIMIT = 220 * 1024      # of the H100's 227 KB a block may use
ALPHA_STATES = (2, 4, 8)     # states a thread of the alpha forward may own
ALPHA_THREADS = 1024 - 32    # its compute threads at most: a block less the producer warp
ALPHA_RING = 8               # ring slots of its producer (kSlotRows rows each)
ALPHA_SLOT_ROWS = 4          # log-prob rows a slot holds (kSlotRows in ctc.cu)


def ctc_block(S: int, V: int) -> int:
    """Steps per checkpoint block: 32, or fewer where the backward's K
    rebuilt alpha rows of S float32 would not fit in shared memory
    (``beta_smem_bytes``: one K-row buffer, which the rebuild refills in
    the order beta frees it)."""
    K = K_MAX
    while K > 1 and beta_smem_bytes(S, V, K) > SMEM_LIMIT:
        K //= 2
    if beta_smem_bytes(S, V, K) > SMEM_LIMIT:
        raise ValueError(f"S = {S} extended states exceed the CTC kernels' shared memory")
    return K


class AlphaGeometry(NamedTuple):
    """The alpha forward's launch: ``states`` consecutive states a compute
    thread, ``threads`` compute threads (whole warps; a producer warp comes
    on top), a ring of ``ring`` slots of ALPHA_SLOT_ROWS log-prob rows,
    ``smem`` bytes of shared memory."""
    states: int
    threads: int
    ring: int
    smem: int


def alpha_smem_bytes(threads: int, ring: int, V: int) -> int:
    """Shared memory of the alpha forward (``ctc.cu``'s ``alpha_fwd_smem_bytes``):
    a full and an empty mbarrier per ring slot, each warp's last two states
    at two step parities, the ring's slots of ALPHA_SLOT_ROWS V-float
    log-prob rows."""
    return 16 * ring + 16 * (threads // 32) + 4 * ring * ALPHA_SLOT_ROWS * V


def alpha_geometry(S: int, V: int) -> AlphaGeometry:
    """The alpha forward's launch for S extended states and V classes, the
    same in its three output modes: the fewest states a thread (2, 4 or 8)
    whose warps cover S within a block, and a ring of 8 slots (32 rows),
    halved until it fits the shared memory (at least 2 slots)."""
    for P in ALPHA_STATES:
        threads = 32 * -(-(-(-S // P)) // 32)
        if threads <= ALPHA_THREADS:
            break
    else:
        raise ValueError(f"S = {S} extended states exceed the alpha forward's "
                         f"{ALPHA_THREADS} threads of {P} states")
    ring = ALPHA_RING
    while ring > 2 and alpha_smem_bytes(threads, ring, V) > SMEM_LIMIT:
        ring //= 2
    smem = alpha_smem_bytes(threads, ring, V)
    if smem > SMEM_LIMIT:
        raise ValueError(f"V = {V} classes exceed the alpha forward's shared memory")
    return AlphaGeometry(P, threads, ring, smem)


def _live_states(label_lengths: Tensor, S: int) -> Tensor:
    """(B, S) bool: s < 2·label_length + 1."""
    s = torch.arange(S, device=label_lengths.device)
    return s[None, :] < (2 * label_lengths.to(torch.int64) + 1)[:, None]


def alpha_plain(log_probs: Tensor, ext: Tensor, skip_ok: Tensor, logit_lengths: Tensor,
                label_lengths: Tensor, K: int, want_ckpt: bool
                ) -> Tuple[Optional[Tensor], Tensor]:
    """(checkpoints (ceil(T/K), B, S) or None, last row (B, S)) of the
    alpha recursion, in plain PyTorch."""
    T, B, _ = log_probs.shape
    S = ext.shape[1]
    states = _live_states(label_lengths, S)
    ckpts = log_probs.new_empty((-(-T // K), B, S)) if want_ckpt else None
    alpha = _alpha_init(log_probs[0].gather(1, ext), states)
    for t in range(T):
        if t:
            alpha = _alpha_step(alpha, log_probs[t].gather(1, ext), skip_ok,
                                t < logit_lengths, states)
        if want_ckpt and ((t + 1) % K == 0 or t == T - 1):
            ckpts[t // K] = alpha
    return ckpts, alpha


def alpha_stream_plain(log_probs: Tensor, ext: Tensor, skip_ok: Tensor,
                       logit_lengths: Tensor, label_lengths: Tensor
                       ) -> Tuple[Tensor, Tensor]:
    """(alphas (T, B, S), last row (B, S)): every alpha row, in plain
    PyTorch (the checkpoints of one-step blocks)."""
    return alpha_plain(log_probs, ext, skip_ok, logit_lengths, label_lengths, 1, True)


def _beta_post(log_probs, ext, skip_ok, logit_lengths, label_lengths, logp, K,
               block_rows):
    """label_post (T, B, V) in plain PyTorch over K-step blocks in reverse,
    ``block_rows(i, t0, t1, states)`` giving block i's alpha rows."""
    T, B, V = log_probs.shape
    S = ext.shape[1]
    dev = log_probs.device
    states = _live_states(label_lengths, S)
    beta_init, skip_next2 = _beta_setup(skip_ok, label_lengths)
    label_post = log_probs.new_empty((T, B, V))
    bstar = torch.full((B, S), NEG_INF, device=dev)
    for i in reversed(range(-(-T // K))):
        t0, t1 = i * K, min((i + 1) * K, T)
        rows = block_rows(i, t0, t1, states)
        for t in reversed(range(t0, t1)):
            beta = _beta_step(bstar, skip_next2, t == logit_lengths - 1, beta_init)
            gamma = rows[t - t0] + beta - logp[:, None]
            post = torch.exp(torch.clamp(gamma, max=0.0))
            post = torch.where(states & (t < logit_lengths)[:, None], post, 0.0)
            label_post[t] = torch.zeros((B, V), device=dev).scatter_add_(1, ext, post)
            bstar = torch.where(states, beta + log_probs[t].gather(1, ext), NEG_INF)
    return label_post


def beta_post_plain(log_probs: Tensor, ext: Tensor, skip_ok: Tensor,
                    logit_lengths: Tensor, label_lengths: Tensor, logp: Tensor,
                    ckpts: Tensor, K: int) -> Tensor:
    """label_post (T, B, V): the state posteriors of each step, summed per
    vocabulary entry, in plain PyTorch (alpha rebuilt block by block from
    the checkpoints, beta carried as bstar = beta + lp)."""
    def rebuild(i, t0, t1, states):
        rows = []
        alpha = ckpts[i - 1] if i else None
        for t in range(t0, t1):
            lp_t = log_probs[t].gather(1, ext)
            alpha = (_alpha_init(lp_t, states) if t == 0 else
                     _alpha_step(alpha, lp_t, skip_ok, t < logit_lengths, states))
            rows.append(alpha)
        return rows

    return _beta_post(log_probs, ext, skip_ok, logit_lengths, label_lengths, logp, K,
                      rebuild)


def beta_post_stream_plain(log_probs: Tensor, ext: Tensor, skip_ok: Tensor,
                           logit_lengths: Tensor, label_lengths: Tensor, logp: Tensor,
                           alphas: Tensor) -> Tensor:
    """label_post (T, B, V) as ``beta_post_plain``, each step's alpha row
    read from the (T, B, S) stream."""
    return _beta_post(log_probs, ext, skip_ok, logit_lengths, label_lengths, logp, K_MAX,
                      lambda i, t0, t1, states: alphas[t0:t1])


# ------------------------------------------------------------------ kernels


def _lib():
    return _build.load("ctc")


def _cuda_inputs(log_probs, ext, skip_ok, logit_lengths, label_lengths):
    dev = log_probs.device
    T, B, V = log_probs.shape
    if log_probs.dtype != f32:
        raise TypeError(f"log_probs must be float32, got {log_probs.dtype}")
    for name, t in (("ext", ext), ("skip_ok", skip_ok), ("logit_lengths", logit_lengths),
                    ("label_lengths", label_lengths)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if T * B * V >= 2 ** 31:
        raise ValueError("log_probs exceed the kernels' int32 indexing")
    return (log_probs.contiguous(), ext.to(torch.int32).contiguous(),
            skip_ok.to(torch.uint8).contiguous(),
            logit_lengths.to(torch.int32).contiguous(),
            label_lengths.to(torch.int32).contiguous())


def _alpha_launch(log_probs, ext, skip_ok, logit_lengths, label_lengths, K, fault_step=0):
    """Launch the alpha forward (``rst_ctc_alpha_fwd``) at ``alpha_geometry``:
    K >= 1 returns (the row after each step t = iK + K - 1 or T - 1, as
    (ceil(T/K), B, S): the checkpoints, or at K = 1 every row, the
    stream; last row), K = 0 (None, last row).  ``fault_step`` > 0 is a
    planted fault for checks: that step reads the previous step's
    log-probs."""
    T, B, V = log_probs.shape
    S = ext.shape[1]
    dev = log_probs.device
    if T == 0 or K < 0:
        raise ValueError(f"the alpha forward needs T >= 1 and K >= 0, got T={T}, K={K}")
    geo = alpha_geometry(S, V)
    lp, e, sk, ll, ul = _cuda_inputs(log_probs, ext, skip_ok, logit_lengths,
                                     label_lengths)
    rows = torch.empty((-(-T // K), B, S), dtype=f32, device=dev) if K else None
    last = torch.empty((B, S), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        fn = _lib().rst_ctc_alpha_fwd
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        rc = fn(lp.data_ptr(), e.data_ptr(), sk.data_ptr(), ll.data_ptr(), ul.data_ptr(),
                rows.data_ptr() if K else None, last.data_ptr(), T, B, S, V, max(K, 1),
                geo.states, geo.threads, geo.ring, fault_step,
                _build.launch_stream(dev))
    if rc != 0:
        raise RuntimeError(f"ctc alpha forward launch failed: CUDA error {rc}")
    return rows, last


def ctc_alpha_ckpt(log_probs: Tensor, ext: Tensor, skip_ok: Tensor,
                   logit_lengths: Tensor, label_lengths: Tensor,
                   K: int) -> Tuple[Tensor, Tensor]:
    """(checkpoints (ceil(T/K), B, S), last row (B, S)) of the alpha
    recursion over (T, B, V) float32 log-probs; the kernel on a CUDA
    device, the plain version on the CPU."""
    if not log_probs.is_cuda:
        return alpha_plain(log_probs, ext, skip_ok, logit_lengths, label_lengths, K, True)
    if K < 1:
        raise ValueError(f"checkpoints need K >= 1, got {K}")
    out = _alpha_launch(log_probs, ext, skip_ok, logit_lengths, label_lengths, K)
    ctc_alpha_ckpt.launches += 1
    return out


ctc_alpha_ckpt.launches = 0


def ctc_alpha_lossonly(log_probs: Tensor, ext: Tensor, skip_ok: Tensor,
                       logit_lengths: Tensor, label_lengths: Tensor) -> Tensor:
    """The last alpha row (B, S) alone; kernel on CUDA, plain on the CPU."""
    if not log_probs.is_cuda:
        return alpha_plain(log_probs, ext, skip_ok, logit_lengths, label_lengths, 1,
                           False)[1]
    _, last = _alpha_launch(log_probs, ext, skip_ok, logit_lengths, label_lengths, 0)
    ctc_alpha_lossonly.launches += 1
    return last


ctc_alpha_lossonly.launches = 0


def label_lists(ext: Tensor, label_lengths: Tensor, V: int) -> Tuple[Tensor, Tensor]:
    """(offs (B, V+1), idx (B, S)) int32: row b's live odd (label) states
    sorted by their label, entry v's states being
    idx[b, offs[b, v]:offs[b, v+1]] in ascending s (the fixed summation
    order of the posteriors); the backward kernels sum the blank's even
    states by a tree instead.  ``_CTCKernelLoss`` builds them once in its
    forward."""
    B, S = ext.shape
    s = torch.arange(S, device=ext.device)
    states = _live_states(label_lengths, S) & (s % 2 == 1)[None, :]
    key = torch.where(states, ext.to(torch.int64), V)
    idx = torch.argsort(key * S + s[None, :], dim=1)
    counts = torch.zeros((B, V + 1), dtype=torch.int64, device=ext.device)
    counts.scatter_add_(1, key, torch.ones_like(key))
    offs = torch.cat([torch.zeros((B, 1), dtype=torch.int64, device=ext.device),
                      torch.cumsum(counts[:, :V], dim=1)], dim=1)
    return offs.to(torch.int32).contiguous(), idx.to(torch.int32).contiguous()


def beta_smem_bytes(S: int, V: int, K: int) -> int:
    """Dynamic shared memory of the backward kernels (``ctc.cu``'s
    ``beta_smem_bytes``): K rebuilt alpha rows (none for the stream), the
    bstar rows, the odd states' posteriors and the blank's warp sums in
    float32, ext, the lists and offsets in int32, the skip flags."""
    return (4 * (K * S + 2 * (S + 2) + 2 * ((S + 1) // 2) + 2 * 8)
            + 4 * (2 * S + V + 1) + S)


def _beta_launch(log_probs, ext, skip_ok, logit_lengths, label_lengths, logp, alphas,
                 n_rows, K, lists):
    """Run the beta/posterior kernel on ``alphas``: the checkpoints of K
    steps (K > 0) or the (T, B, S) stream (K = 0, n_rows = T), with the
    ``label_lists`` ``lists``."""
    T, B, V = log_probs.shape
    S = ext.shape[1]
    dev = log_probs.device
    lp, e, sk, ll, ul = _cuda_inputs(log_probs, ext, skip_ok, logit_lengths,
                                     label_lengths)
    if tuple(alphas.shape) != (n_rows, B, S) or alphas.dtype != f32:
        raise ValueError(f"the alpha rows must be ({n_rows}, {B}, {S}) float32")
    offs, idx = lists
    logp = logp.to(f32).contiguous()
    alphas = alphas.contiguous()
    out = torch.empty((T, B, V), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        head = [lp.data_ptr(), e.data_ptr(), sk.data_ptr(), ll.data_ptr(), ul.data_ptr(),
                logp.data_ptr(), alphas.data_ptr(), offs.data_ptr(), idx.data_ptr(),
                out.data_ptr(), T, B, S, V]
        stream = _build.launch_stream(dev)
        if K:
            fn = _lib().rst_ctc_beta_post
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            rc = fn(*head, K, stream)
        else:
            fn = _lib().rst_ctc_beta_post_stream
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            rc = fn(*head, stream)
    if rc != 0:
        raise RuntimeError(f"ctc beta/posterior kernel launch failed: CUDA error {rc}")
    return out


def ctc_beta_post(log_probs: Tensor, ext: Tensor, skip_ok: Tensor,
                  logit_lengths: Tensor, label_lengths: Tensor, logp: Tensor,
                  ckpts: Tensor, K: int, lists: Tuple[Tensor, Tensor]) -> Tensor:
    """label_post (T, B, V) float32 from the alpha checkpoints; the kernel
    on a CUDA device (``lists``: ``label_lists``), the plain version on the
    CPU."""
    if not log_probs.is_cuda:
        return beta_post_plain(log_probs, ext, skip_ok, logit_lengths, label_lengths,
                               logp, ckpts, K)
    out = _beta_launch(log_probs, ext, skip_ok, logit_lengths, label_lengths, logp, ckpts,
                       -(-log_probs.shape[0] // K), K, lists)
    ctc_beta_post.launches += 1
    return out


ctc_beta_post.launches = 0


def ctc_alpha_stream(log_probs: Tensor, ext: Tensor, skip_ok: Tensor,
                     logit_lengths: Tensor, label_lengths: Tensor) -> Tuple[Tensor, Tensor]:
    """(alphas (T, B, S) float32, last row (B, S)): every row of the alpha
    recursion (``_alpha_kernel`` with ``emit_alphas=True``); the kernel on
    a CUDA device, the plain version on the CPU."""
    if not log_probs.is_cuda:
        return alpha_stream_plain(log_probs, ext, skip_ok, logit_lengths, label_lengths)
    out = _alpha_launch(log_probs, ext, skip_ok, logit_lengths, label_lengths, 1)
    ctc_alpha_stream.launches += 1
    return out


ctc_alpha_stream.launches = 0


def ctc_beta_post_stream(log_probs: Tensor, ext: Tensor, skip_ok: Tensor,
                         logit_lengths: Tensor, label_lengths: Tensor, logp: Tensor,
                         alphas: Tensor, lists: Tuple[Tensor, Tensor]) -> Tensor:
    """label_post (T, B, V) float32 from the (T, B, S) alpha stream
    (``_beta_post_kernel``); the kernel on a CUDA device (``lists`` as for
    ``ctc_beta_post``), the plain version on the CPU."""
    if not log_probs.is_cuda:
        return beta_post_stream_plain(log_probs, ext, skip_ok, logit_lengths,
                                      label_lengths, logp, alphas)
    out = _beta_launch(log_probs, ext, skip_ok, logit_lengths, label_lengths, logp, alphas,
                       log_probs.shape[0], 0, lists)
    ctc_beta_post_stream.launches += 1
    return out


ctc_beta_post_stream.launches = 0


# ------------------------------------------------------------------ the loss


def _setup(logits, logit_lengths, labels, label_lengths, blank_id):
    T, B, V = logits.shape
    if blank_id < 0:
        blank_id = V + blank_id
    dev = logits.device
    logit_lengths = torch.as_tensor(logit_lengths, device=dev).to(torch.int64)
    label_lengths = torch.as_tensor(label_lengths, device=dev).to(torch.int64)
    log_probs = torch.log_softmax(logits.detach().to(f32), dim=-1).contiguous()
    ext, skip_ok = _prepare(torch.as_tensor(labels, device=dev).to(torch.int64), blank_id)
    valid = (label_lengths <= logit_lengths) & (logit_lengths > 0)
    return log_probs, ext, skip_ok, logit_lengths, label_lengths, valid


def _loss(last, label_lengths, valid):
    logp = _terminal_logp(last, label_lengths)
    return torch.where(valid, -logp, torch.zeros_like(logp)), logp


class _CTCKernelLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, logit_lengths, labels, label_lengths, blank_id):
        log_probs, ext, skip_ok, ll, ul, valid = _setup(
            logits, logit_lengths, labels, label_lengths, blank_id)
        T, B, V = log_probs.shape
        ctx.logits_dtype = logits.dtype
        if T == 0:
            ctx.residuals = None
            ctx.shape = logits.shape
            return torch.zeros((B,), dtype=f32, device=logits.device)
        K = ctc_block(ext.shape[1], V)
        ckpts, last = ctc_alpha_ckpt(log_probs, ext, skip_ok, ll, ul, K)
        loss, logp = _loss(last, ul, valid)
        # The backward kernels' label lists, built once here and saved.
        lists = label_lists(ext, ul, V)
        ctx.residuals = (log_probs, ckpts, logp, ext, skip_ok, ll, ul, valid, K, lists)
        return loss

    @staticmethod
    def backward(ctx, g):
        stages.mark("ctc_backward")
        if ctx.residuals is None:
            return (torch.zeros(ctx.shape, dtype=ctx.logits_dtype, device=g.device),
                    None, None, None, None)
        log_probs, ckpts, logp, ext, skip_ok, ll, ul, valid, K, lists = ctx.residuals
        del ctx.residuals
        if os.environ.get("RST_CTC_ALPHA_STREAM", "0") == "1":
            # The alpha-stream backward: the forward re-run as a (T, B, S)
            # stream, read by the beta pass instead of the checkpoints.
            del ckpts
            alphas, _ = ctc_alpha_stream(log_probs, ext, skip_ok, ll, ul)
            label_post = ctc_beta_post_stream(log_probs, ext, skip_ok, ll, ul, logp, alphas,
                                              lists)
            del alphas
        else:
            label_post = ctc_beta_post(log_probs, ext, skip_ok, ll, ul, logp, ckpts, K, lists)
        grad = ctc_grad(log_probs, label_post, ll, valid, g)
        return grad.to(ctx.logits_dtype), None, None, None, None


def ctc_loss(logits: Tensor, logit_lengths: Tensor, labels: Tensor,
             label_lengths: Tensor, blank_id: int = -1) -> Tensor:
    """Per-example CTC negative log-likelihood (B,) of time-major logits
    (T, B, V) through the CTC kernels; labels (B, U) padded with -1 (or
    blank).  Where no gradient is needed, the loss-only kernel runs."""
    needs_grad = torch.is_grad_enabled() and logits.requires_grad
    if needs_grad:
        return _CTCKernelLoss.apply(logits, logit_lengths, labels, label_lengths,
                                    blank_id)
    log_probs, ext, skip_ok, ll, ul, valid = _setup(
        logits, logit_lengths, labels, label_lengths, blank_id)
    if log_probs.shape[0] == 0:
        return torch.zeros((log_probs.shape[1],), dtype=f32, device=logits.device)
    last = ctc_alpha_lossonly(log_probs, ext, skip_ok, ll, ul)
    return _loss(last, ul, valid)[0]
