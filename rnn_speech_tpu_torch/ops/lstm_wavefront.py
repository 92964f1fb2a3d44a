"""Whole-stack LSTM on the (layer, time) diagonal: inference and training
kernels, their wrappers and plain versions, and the differentiable stack.

Counterpart of ``rnn_speech_tpu/ops/lstm_wavefront.py``.  Diagonal s
computes, for every layer l with 0 <= t = s - l < T, that layer's step t;
layers l >= 1 take the lower layer's carried h and apply their own
``b_l + bf16(h^{l-1})·W_x,l`` inside the step.  Each layer sees its input
one diagonal after it is produced, so the math is the layered stack's;
only the schedule differs.

* ``lstm_stack_wavefront`` (``_wavefront_kernel``): inference; layer 0
  adds the precomputed ``xp0 = x·W_x0 + b0``.  ``wavefront_eval_plan``
  sends it by shape to a persistent kernel (``csrc/lstm_wavefront_eval.cu``:
  the training forward's design, up to two 64-row groups a CTA, B <= 128,
  as at the eval batch and ``--file``) or to the per-diagonal kernel
  (``csrc/lstm_wavefront.cu``).
* ``wavefront_train`` (``_wavefront_train_kernel``): the training forward;
  layer 0's input product runs in the kernel and every step stores the
  bf16 residuals (activated gates, carried c, masked output of every
  layer).  ``wavefront_plan`` sends it by shape to a persistent kernel
  (``csrc/lstm_wavefront_persistent.cu``: one cooperative launch, every
  layer's W_h resident in shared memory, the layers paced by per-layer
  counters and rings of h in global memory; B <= 64, D = H and a grid of
  at most one CTA an SM, as at the default step) or to the per-diagonal
  kernel (``csrc/lstm_wavefront_train.cu``).
* ``wavefront_bwd`` (``_wavefront_bwd_kernel``): the reverse diagonal,
  dgates of every layer written over the gates residual, and dh0, dc0;
  with ``fuse_dwx`` also dW_x of layers 1..L-1 (the TPU kernel's
  ``fuse_dwx`` mode).  ``wavefront_bwd_plan`` sends the unfused pass by
  shape to a persistent kernel (``csrc/lstm_wavefront_bwd_persistent.cu``:
  one cooperative launch, W_hᵀ resident, a slice's K split in four gates
  whose partials meet through L2, the layers paced by per-layer counters;
  B <= 64, as at the default step) and everything else, the fused pass
  among it, to the per-diagonal kernel (``csrc/lstm_wavefront_bwd.cu``).
* ``lstm_stack_wavefront_train``: the differentiable stack
  (``_wavefront_stack_core`` and its VJP) over those two kernels and the
  weight-gradient kernel of ``ops/grad_matmul.py``.  With
  ``bwd_wavefront`` off (``RST_WAVEFRONT_BWD=0``) its backward runs layer
  by layer from the top through ``lstm_layer_train.recurrence_bwd``
  instead of the reverse diagonal (``layered_stack_bwd``), and seed-mode
  dropout becomes a mask stream from ``dropout.bernoulli_mask`` first.

Both training kernels take the JAX package's inter-layer dropout: drop
mode 0 (none), 1 (explicit (L-1, T, B, H) {0, 1} masks) or 2 (two seed
words; both kernels draw the bits of boundary l at step t from
``csrc/philox.cuh``, and the plain versions from ``ops/random_bits.py``).
Layer l >= 1 reads bf16(h^{l-1}·keep·drop_scale); the outs residual stays
undropped.  The dW_x contractions of layers 1..L-1 take one of two forms,
chosen by ``fuse_dwx_enabled`` as the JAX package chooses them: the
backward emits the dropped boundary inputs (xdrop, (L-1, T, B, H)) for one
weight-gradient pass per layer, or, in drop modes 0 and 2 once the
residuals reach 10 GiB (``RST_WAVEFRONT_FUSE_DWX`` forces either), the
reverse pass accumulates dW_x itself and no xdrop stream exists; then
``_hgrad_only`` gives each layer's dW_h and db.

Each wrapper takes the plain version for tensors on the CPU and launches
its kernel for tensors on a CUDA device, or raises; there is no fallback.
``<wrapper>.launches`` counts the calls that launched a kernel (the
per-diagonal kernels issue one CUDA launch per diagonal from one host
call); ``<wrapper>.persistent_launches`` of the three wrappers those of
their persistent kernels, read from each library's own count at the
launch site.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Tuple

import torch

from rnn_speech_tpu_torch import stages
from rnn_speech_tpu_torch.ops import _build, dropout, grad_matmul, lstm_layer_train, random_bits
from rnn_speech_tpu_torch.ops.grad_matmul import dgates_weight_grads, weight_grad
from rnn_speech_tpu_torch.ops.lstm import LayerState, dot_f32, length_mask
from rnn_speech_tpu_torch.ops.lstm_layer_train import forward_plain
from rnn_speech_tpu_torch.ops.lstm_recurrence import H100_SMS, SMEM_LIMIT, check_kernel_inputs

Tensor = torch.Tensor
f32, bf16 = torch.float32, torch.bfloat16


def lstm_stack_wavefront_plain(
    xp0: Tensor, w_h: Tensor, w_x_rest: Tensor, b_rest: Tensor, mask: Tensor,
    h0: Tensor, c0: Tensor,
) -> Tuple[Tensor, Tensor, Tensor]:
    """The diagonal walk in plain PyTorch, in the TPU kernel's order:
    within a diagonal the layers run in DESCENDING order, so layer l reads
    layer l-1's h from the previous diagonal before it is overwritten.
    Same casts as the kernel (h rounded to the weight dtype, f32 sums).
    Returns (out (T, B, H) of the top layer, hn (L, B, H), cn (L, B, H))."""
    T, B, four_h = xp0.shape
    H = four_h // 4
    L = w_h.shape[0]
    cd = w_h.dtype
    wh = w_h.to(torch.float32)
    wx = w_x_rest.to(torch.float32)
    h_s = [h0[l].to(torch.float32) for l in range(L)]
    c_s = [c0[l].to(torch.float32) for l in range(L)]
    out = xp0.new_zeros((T, B, H))
    for s in range(T + L - 1):
        for l in reversed(range(L)):
            t = s - l
            if not 0 <= t < T:
                continue
            h, c = h_s[l], c_s[l]
            rec = torch.matmul(h.to(cd).to(torch.float32), wh[l])
            if l == 0:
                gates = xp0[t] + rec
            else:
                x_in = h_s[l - 1].to(cd).to(torch.float32)
                gates = b_rest[l - 1, 0] + torch.matmul(x_in, wx[l - 1]) + rec
            i, g, f, o = gates.split(H, dim=-1)
            c_new = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            m = mask[t, 0][:, None]
            c_s[l] = m * c_new + (1.0 - m) * c
            h_s[l] = m * h_new + (1.0 - m) * h
            if l == L - 1:
                out[t] = m * h_new
    return out, torch.stack(h_s), torch.stack(c_s)


def _ptr(t):
    return None if t is None else t.data_ptr()


# The persistent forwards (csrc/lstm_wavefront_persistent.cu, training;
# csrc/lstm_wavefront_eval.cu, inference): hidden units a CTA owns (of one
# layer; the products' N = 4 x 24), batch rows (one wgmma tile), steps
# each layer's ring of h holds, the stages of the streamed-W ring (W_x,
# and W_h's chunks past the resident ones) and of the A ring (the
# kernels' kWStages and kAStages), and the bytes of one 96-column and of
# one 64-row box (64 K, bf16).
WAVEFRONT_UNITS, WAVEFRONT_ROWS, WAVEFRONT_RING = 24, 64, 8
WAVEFRONT_W_STAGES, WAVEFRONT_A_STAGES = 2, 4
_WF_BOX, _WF_ABOX = 4 * WAVEFRONT_UNITS * 64 * 2, WAVEFRONT_ROWS * 64 * 2


# The persistent inference forward (csrc/lstm_wavefront_eval.cu): the
# training forward's CTA (24 units of one layer, N = 4 x 24) and rings, with
# up to two 64-row groups a CTA, each on its own consumer warpgroup.
WAVEFRONT_EVAL_GROUPS = 2


def wavefront_eval_smem(resident: int, groups: int) -> int:
    """Dynamic shared memory of the persistent inference forward:
    ``resident`` boxes of W_h (64-wide K chunks of the CTA's 96 columns),
    the W ring's stages, the A ring's stages of 64·``groups`` rows, the
    mbarriers and the 1024-byte alignment slack (the kernel's
    ``smem_bytes``)."""
    return ((resident + WAVEFRONT_W_STAGES) * _WF_BOX
            + WAVEFRONT_A_STAGES * groups * _WF_ABOX
            + 8 * (1 + 2 * (WAVEFRONT_W_STAGES + WAVEFRONT_A_STAGES)) + 1024)


def wavefront_eval_layout(B: int, H: int, L: int, sms: int = H100_SMS):
    """The persistent inference forward's grid at (B, H, L) on a card of
    ``sms`` SMs, or None where the kernel cannot take the shape: ``slices``
    = ceil(H/24) CTAs a layer, one CTA an SM for all L layers, ``groups`` =
    ceil(B/64) row groups a CTA (B <= 128), H a multiple of 64.
    ``resident`` is as many of W_h's H/64 K chunks as fit beside the rings
    (11 of 16 at H=1024 with two groups, 14 with one; the kernel's
    ``resident_chunks``).  Returns {"slices", "grid", "groups", "resident",
    "ring", "smem"}."""
    if not 1 <= B <= WAVEFRONT_EVAL_GROUPS * WAVEFRONT_ROWS or L < 2 or H < 64 or H % 64:
        return None
    slices = -(-H // WAVEFRONT_UNITS)
    if L * slices > sms:
        return None
    groups = -(-B // WAVEFRONT_ROWS)
    resident = min(H // 64, (SMEM_LIMIT - wavefront_eval_smem(0, groups)) // _WF_BOX)
    return {"slices": slices, "grid": L * slices, "groups": groups, "resident": resident,
            "ring": WAVEFRONT_RING, "smem": wavefront_eval_smem(resident, groups)}


def wavefront_eval_plan(B: int, H: int, L: int, sms: int = H100_SMS) -> dict:
    """Which kernel runs the inference forward at (B, H, L) on a card of
    ``sms`` SMs, decided by shape alone: the persistent one where
    ``wavefront_eval_layout`` takes the shape (the eval batch's B=128 and
    ``--file``'s B=1 at 3x1024: 129 CTAs), else the per-diagonal kernel (B
    past two row groups, more CTAs than SMs).  Returns {"kernel":
    "persistent", **layout} or {"kernel": "per_diagonal"}."""
    layout = wavefront_eval_layout(B, H, L, sms)
    if layout is None:
        return {"kernel": "per_diagonal"}
    return {"kernel": "persistent", **layout}


def _library_launches(name: str, symbol: str) -> int:
    """Launches of a persistent kernel so far, as its library counts them at
    the launch site."""
    fn = getattr(_build.load(name), symbol)
    fn.argtypes, fn.restype = [], ctypes.c_longlong
    return int(fn())


def _eval_persistent_launch(xp0, w_h, w_x_rest, b_rest, mask, h0, c0, plan, skip_waits=0,
                            stamps=None):
    """The persistent inference forward on the plan's grid.  ``skip_waits``
    plants a fault (no counter waits: each layer reads its rings without
    waiting for their producers), for checks; ``stamps``, a (T, 5) int64
    tensor on the device, takes the SM clock of the top layer's first CTA
    at five points of each step (the kernel's ``Args::stamps``), for
    studies.  Returns (out, hn, cn)."""
    T, B, four_h = xp0.shape
    H, L = four_h // 4, w_h.shape[0]
    dev = xp0.device
    R, groups = plan["ring"], plan["groups"]
    with torch.cuda.device(dev):
        h, c = h0.clone(), c0.clone()
        out = torch.empty((T, B, H), dtype=f32, device=dev)
        if T == 0:
            return out, h, c
        ring_h = torch.zeros((L, R, groups * WAVEFRONT_ROWS, H), dtype=bf16, device=dev)
        ring_h[:, R - 1, :B] = h0.to(bf16)
        wh = wavefront_weights(w_h, plan["slices"])
        wx = wavefront_weights(w_x_rest, plan["slices"])
        counter = torch.zeros((L,), dtype=torch.int32, device=dev)
        fn = _build.load("lstm_wavefront_eval").rst_lstm_wavefront_eval_persistent
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        rc = fn(xp0.data_ptr(), wx.data_ptr(), wh.data_ptr(), b_rest.data_ptr(),
                mask.data_ptr(), h.data_ptr(), c.data_ptr(), out.data_ptr(), ring_h.data_ptr(),
                counter.data_ptr(), T, B, H, L, plan["slices"], groups, R, skip_waits,
                _ptr(stamps), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"persistent lstm_wavefront kernel launch failed: CUDA error {rc} "
                           f"(plan {plan})")
    return out, h, c


def _eval_per_diagonal_launch(xp0, w_h, w_x_rest, b_rest, mask, h0, c0):
    """The per-diagonal inference forward (csrc/lstm_wavefront.cu): one
    launch a diagonal, any B.  Returns (out, hn, cn)."""
    T, B, four_h = xp0.shape
    H, L = four_h // 4, w_h.shape[0]
    dev = xp0.device
    with torch.cuda.device(dev):
        Bp = -(-B // 16) * 16
        hb = torch.zeros((2, L, Bp, H), dtype=bf16, device=dev)
        hb[:, :, :B] = h0.to(bf16)[None]
        h = h0.clone()
        c = c0.clone()
        out = torch.empty((T, B, H), dtype=f32, device=dev)
        if T == 0:
            return out, h, c
        fn = _build.load("lstm_wavefront").rst_lstm_wavefront
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        rc = fn(xp0.data_ptr(), w_h.data_ptr(), w_x_rest.data_ptr(), b_rest.data_ptr(),
                mask.data_ptr(), hb.data_ptr(), h.data_ptr(), c.data_ptr(), out.data_ptr(),
                T, B, H, L, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lstm_wavefront kernel launch failed: CUDA error {rc}")
    return out, h, c


def lstm_stack_wavefront(
    xp0: Tensor,        # (T, B, 4H) f32: layer 0's x·W_x0 + b0
    w_h: Tensor,        # (L, H, 4H) compute dtype
    w_x_rest: Tensor,   # (L-1, H, 4H) compute dtype: layers 1..L-1
    b_rest: Tensor,     # (L-1, 1, 4H) f32
    mask: Tensor,       # (T, 1, B) f32 validity mask
    h0: Tensor,         # (L, B, H) f32
    c0: Tensor,         # (L, B, H) f32
) -> Tuple[Tensor, Tensor, Tensor]:
    """(out (T, B, H), hn (L, B, H), cn (L, B, H)); on a CUDA device (bf16
    weights) the kernel ``wavefront_eval_plan`` picks by shape, the
    persistent one (``persistent_launches`` adds the library's count of its
    launches) or the per-diagonal one; the plain version on the CPU."""
    T, B, four_h = xp0.shape
    H = four_h // 4
    L = w_h.shape[0]
    if w_x_rest.shape[0] != L - 1 or b_rest.shape[0] != L - 1:
        raise ValueError("w_x_rest/b_rest must cover layers 1..L-1")
    if not xp0.is_cuda:
        return lstm_stack_wavefront_plain(xp0, w_h, w_x_rest, b_rest, mask, h0, c0)
    if L < 2:
        raise ValueError("the wavefront kernel needs >= 2 layers")
    dev = xp0.device
    check_kernel_inputs([
        ("xp0", xp0, f32, (T, B, 4 * H)),
        ("w_h", w_h, bf16, (L, H, 4 * H)),
        ("w_x_rest", w_x_rest, bf16, (L - 1, H, 4 * H)),
        ("b_rest", b_rest, f32, (L - 1, 1, 4 * H)),
        ("mask", mask, f32, (T, 1, B)),
        ("h0", h0, f32, (L, B, H)),
        ("c0", c0, f32, (L, B, H)),
    ], dev, H)
    plan = wavefront_eval_plan(B, H, L, torch.cuda.get_device_properties(dev).multi_processor_count)
    if plan["kernel"] == "persistent":
        before = _library_launches("lstm_wavefront_eval", "rst_wavefront_eval_launches")
        res = _eval_persistent_launch(xp0, w_h, w_x_rest, b_rest, mask, h0, c0, plan)
        lstm_stack_wavefront.persistent_launches += _library_launches(
            "lstm_wavefront_eval", "rst_wavefront_eval_launches") - before
    else:
        res = _eval_per_diagonal_launch(xp0, w_h, w_x_rest, b_rest, mask, h0, c0)
    if T:                                            # T = 0 launches nothing
        lstm_stack_wavefront.launches += 1
    return res


lstm_stack_wavefront.launches = 0
lstm_stack_wavefront.persistent_launches = 0


def lstm_stack_wavefront_apply(
    layer_params, x: Tensor, seq_lengths: Tensor, states: List[LayerState],
    compute_dtype=torch.float32,
) -> Tuple[Tensor, List[LayerState]]:
    """The layered stack's calling shape: layer 0's input projection runs
    as one matmul outside the kernel, the weights are stacked, and the
    result is (out, [(c, h)] per layer)."""
    T = x.shape[0]
    cd = compute_dtype
    p0 = layer_params[0]
    xp0 = dot_f32(x, p0["w_x"], cd) + p0["b"].to(torch.float32)
    w_h = torch.stack([p["w_h"].to(cd) for p in layer_params])
    w_x_rest = torch.stack([p["w_x"].to(cd) for p in layer_params[1:]])
    b_rest = torch.stack(
        [p["b"].to(torch.float32).reshape(1, -1) for p in layer_params[1:]]
    )
    mask = length_mask(T, seq_lengths, x.device)
    c0 = torch.stack([c.to(torch.float32) for c, _ in states])
    h0 = torch.stack([h.to(torch.float32) for _, h in states])
    out, hn, cn = lstm_stack_wavefront(xp0, w_h, w_x_rest, b_rest, mask, h0, c0)
    return out, [(cn[l], hn[l]) for l in range(len(layer_params))]


# ------------------------------------------------------------------ training


def drop_keeps(drop_mode: int, drop_arr, keep_prob: float, shape, device):
    """The (L-1, T, B, H) float32 {0, 1} inter-layer keep bits of a drop
    mode: the explicit masks (mode 1), the generator's bits for the seed
    words (mode 2), or None (mode 0)."""
    if drop_mode == 0:
        return None
    if drop_mode == 1:
        if tuple(drop_arr.shape) != tuple(shape):
            raise ValueError(f"drop masks must have shape {tuple(shape)}, "
                             f"got {tuple(drop_arr.shape)}")
        return drop_arr.to(device=device, dtype=f32)
    if drop_mode == 2:
        return random_bits.wavefront_masks(drop_arr, *shape, keep_prob, device).to(f32)
    raise ValueError(f"drop_mode must be 0, 1 or 2, got {drop_mode}")


#: Residual footprint L·T·B·6H·itemsize at which the reverse pass fuses the
#: dW_x contractions (the JAX package's threshold, ``_wavefront_bwd``).
FUSE_DWX_BYTES = 10 << 30
#: Diagonals per accumulation window of the fused dW_x on the card.
FUSE_DWX_WINDOW = 128


def fuse_dwx_enabled(L: int, T: int, B: int, H: int, rd_itemsize: int,
                     drop_mode: int) -> bool:
    """Whether the reverse diagonal fuses the dW_x contractions: the JAX
    package's switch (``_wavefront_bwd``).  ``RST_WAVEFRONT_FUSE_DWX`` set to
    "0" or "1" forces it; otherwise it is on once the residuals
    L·T·B·6H·rd_itemsize (T the frame count at the kernel) reach
    ``FUSE_DWX_BYTES``.  Never in drop mode 1 (the explicit masks keep the
    xdrop stream) or for one layer."""
    if drop_mode == 1 or L < 2:
        return False
    forced = os.environ.get("RST_WAVEFRONT_FUSE_DWX", "")
    if forced in ("0", "1"):
        return forced == "1"
    return L * T * B * 6 * H * rd_itemsize >= FUSE_DWX_BYTES


def _check_fuse(fuse_dwx: bool, drop_mode: int, L: int, outs) -> None:
    if not fuse_dwx:
        return
    if drop_mode == 1 or L < 2:
        raise ValueError("the fused dW_x takes drop mode 0 or 2 and at least 2 layers")
    if outs is None:
        raise ValueError("the fused dW_x reads the outs residual")


def wavefront_train_plain(x: Tensor, w_x0: Tensor, w_h: Tensor, w_x_rest: Tensor,
                          b_all: Tensor, mask: Tensor, h0: Tensor, c0: Tensor,
                          res_dtype, drop_mode: int = 0, drop_arr=None,
                          drop_scale: float = 1.0, keep_prob: float = 1.0,
                          ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """The training forward in plain PyTorch, layer by layer (the same
    math as the diagonal: layer l reads the lower layer's carried h at the
    same t, times its boundary's keep·drop_scale in drop modes 1 and 2).
    Operands are rounded to the weights' dtype, sums are float32.  Returns
    (outs (L, T, B, H), gates (L, T, B, 4H), cseq (L, T, B, H)) in
    ``res_dtype`` and (hn, cn) (L, B, H) float32."""
    L, H = w_h.shape[0], w_h.shape[1]
    T, B = x.shape[:2]
    cd = w_h.dtype
    keeps = drop_keeps(drop_mode, drop_arr, keep_prob, (L - 1, T, B, H), x.device)
    res = [], [], []
    hn, cn = [], []
    x_in, w_in = x, w_x0
    for l in range(L):
        xp = b_all[l].to(f32) + torch.matmul(x_in.to(cd).to(f32), w_in.to(f32))
        out, h, c, gates, cseq, hcar = forward_plain(
            xp, w_h[l], mask, h0[l], c0[l], res_dtype, keep_gates=True, keep_h=True)
        for acc, val in zip(res, (out.to(res_dtype), gates, cseq)):
            acc.append(val)
        hn.append(h)
        cn.append(c)
        if l + 1 < L:
            x_in = hcar if keeps is None else hcar * (keeps[l] * drop_scale)
            w_in = w_x_rest[l]
    return (torch.stack(res[0]), torch.stack(res[1]), torch.stack(res[2]),
            torch.stack(hn), torch.stack(cn))


def _drop_launch_args(drop_mode, drop_arr, keep_prob, drop_scale, shape, dev):
    """(masks tensor or None, seed0, seed1, threshold, scale) for a kernel."""
    if drop_mode == 1:
        masks = drop_arr.to(bf16).contiguous()
        check_kernel_inputs([("drop_masks", masks, bf16, shape)], dev, shape[-1])
        return masks, 0, 0, 0, float(drop_scale)
    if drop_mode == 2:
        seed = [int(w) & 0xFFFFFFFF for w in drop_arr]
        return None, seed[0], seed[1], random_bits.threshold(keep_prob), float(drop_scale)
    if drop_mode != 0:
        raise ValueError(f"drop_mode must be 0, 1 or 2, got {drop_mode}")
    return None, 0, 0, 0, 1.0


def wavefront_smem(resident: int) -> int:
    """Dynamic shared memory of the persistent forward: ``resident`` boxes
    of W_h (64-wide K chunks of the CTA's 96 columns), the two rings' stages
    (one W box or one A box each), the mbarriers and the 1024-byte
    alignment slack (the kernel's ``smem_bytes``)."""
    return ((resident + WAVEFRONT_W_STAGES) * _WF_BOX + WAVEFRONT_A_STAGES * _WF_ABOX
            + 8 * (1 + 2 * (WAVEFRONT_W_STAGES + WAVEFRONT_A_STAGES)) + 1024)


def wavefront_layout(B: int, H: int, L: int, D: int, sms: int = H100_SMS):
    """The persistent forward's grid at (B, H, L, D) on a card of ``sms``
    SMs, or None where the kernel cannot take the shape: ``slices`` =
    ceil(H/24) CTAs a layer, one CTA an SM for all L layers, B <= 64 (one
    tile), D = H, H a multiple of 64.  ``resident`` is as many of W_h's
    H/64 K chunks as fit beside the rings (14 of 16 at H=1024; the kernel's
    ``resident_chunks``).  Returns {"slices", "grid", "resident", "ring",
    "smem"}."""
    if not 1 <= B <= WAVEFRONT_ROWS or L < 2 or D != H or H < 64 or H % 64:
        return None
    slices = -(-H // WAVEFRONT_UNITS)
    if L * slices > sms:
        return None
    resident = min(H // 64, (SMEM_LIMIT - wavefront_smem(0)) // _WF_BOX)
    return {"slices": slices, "grid": L * slices, "resident": resident,
            "ring": WAVEFRONT_RING, "smem": wavefront_smem(resident)}


def wavefront_plan(B: int, H: int, L: int, D: int, sms: int = H100_SMS) -> dict:
    """Which kernel runs the training forward at (B, H, L, D) on a card of
    ``sms`` SMs, decided by shape alone: the persistent one where
    ``wavefront_layout`` takes the shape (the default step's B=64 at H = D =
    1024, L = 3: 3 x 43 = 129 CTAs), else the per-diagonal kernel (the wide
    step's B=394, D != H, more CTAs than SMs).  Returns {"kernel":
    "persistent", **layout} or {"kernel": "per_diagonal"}."""
    layout = wavefront_layout(B, H, L, D, sms)
    if layout is None:
        return {"kernel": "per_diagonal"}
    return {"kernel": "persistent", **layout}


def wavefront_column_order(H: int, slices: int) -> Tensor:
    """(slices·96,) int64: the gate column each CTA's product column
    holds, CTA by CTA [i(24) | g(24) | f(24) | o(24)] of units 24u ..
    24u + 23; -1 past H (zero weights, never stored)."""
    n = torch.arange(slices * 4 * WAVEFRONT_UNITS)
    u, g, v = n // (4 * WAVEFRONT_UNITS), n // WAVEFRONT_UNITS % 4, n % WAVEFRONT_UNITS
    unit = u * WAVEFRONT_UNITS + v
    return torch.where(unit < H, g * H + unit, torch.full_like(unit, -1))


def wavefront_weights(w: Tensor, slices: int) -> Tensor:
    """Per-layer weights w (L, K, 4H) as the persistent kernel reads them:
    (L·slices·96, K), layer by layer the columns in
    ``wavefront_column_order`` (zero rows past H) as rows, K contiguous."""
    L, K, G = w.shape
    cols = wavefront_column_order(G // 4, slices).to(w.device)
    w_t = torch.cat([w.transpose(1, 2), w.new_zeros((L, 1, K))], dim=1)   # row G: zeros
    rows = torch.where(cols < 0, torch.full_like(cols, G), cols)
    return w_t[:, rows].reshape(-1, K).contiguous()


def _persistent_launch(x, w_x0, w_h, w_x_rest, b_all, mask, h0, c0, drop, plan,
                       skip_waits=0, stamps=None):
    """The persistent forward on the plan's grid.  ``drop`` is
    ``_drop_launch_args``' (masks, seed0, seed1, threshold, scale) with the
    drop mode first; ``skip_waits`` plants a fault (no counter waits: each
    layer reads its rings without waiting for their producers), for checks;
    ``stamps``, a (T, 5) int64 tensor on the device, takes the SM clock of
    the top layer's first CTA at five points of each step (the kernel's
    ``Args::stamps``), for studies.  Returns (outs, gates, cseq, hn, cn)."""
    T, B, H = x.shape
    L = w_h.shape[0]
    drop_mode, masks, seed0, seed1, thr, scale = drop
    dev = x.device
    R = plan["ring"]
    with torch.cuda.device(dev):
        h, c = h0.clone(), c0.clone()
        outs = torch.empty((L, T, B, H), dtype=bf16, device=dev)
        gates = torch.empty((L, T, B, 4 * H), dtype=bf16, device=dev)
        cseq = torch.empty((L, T, B, H), dtype=bf16, device=dev)
        if T == 0:
            return outs, gates, cseq, h, c
        ring_h = torch.zeros((L, R, WAVEFRONT_ROWS, H), dtype=bf16, device=dev)
        ring_h[:, R - 1, :B] = h0.to(bf16)
        ring_x = (torch.zeros((L - 1, R, WAVEFRONT_ROWS, H), dtype=bf16, device=dev)
                  if drop_mode else None)
        wx = wavefront_weights(torch.cat([w_x0[None], w_x_rest]), plan["slices"])
        wh = wavefront_weights(w_h, plan["slices"])
        counter = torch.zeros((L,), dtype=torch.int32, device=dev)
        fn = _build.load("lstm_wavefront_persistent").rst_lstm_wavefront_train_persistent
        fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [ctypes.c_uint] * 3
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        rc = fn(x.data_ptr(), wx.data_ptr(), wh.data_ptr(), b_all.data_ptr(), mask.data_ptr(),
                h.data_ptr(), c.data_ptr(), outs.data_ptr(), gates.data_ptr(), cseq.data_ptr(),
                ring_h.data_ptr(), _ptr(ring_x), _ptr(masks), counter.data_ptr(), T, B, H, L,
                plan["slices"], R, drop_mode, seed0, seed1, thr, scale,
                skip_waits, _ptr(stamps), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"persistent lstm_wavefront_train kernel launch failed: CUDA error "
                           f"{rc} (plan {plan})")
    return outs, gates, cseq, h, c


def persistent_launches() -> int:
    """Launches of the persistent training forward so far, as its library
    counts them at the launch site."""
    return _library_launches("lstm_wavefront_persistent", "rst_wavefront_persistent_launches")


def wavefront_train(x: Tensor, w_x0: Tensor, w_h: Tensor, w_x_rest: Tensor,
                    b_all: Tensor, mask: Tensor, h0: Tensor, c0: Tensor,
                    res_dtype, drop_mode: int = 0, drop_arr=None,
                    drop_scale: float = 1.0, keep_prob: float = 1.0,
                    ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Training forward of the whole stack.

    Inter-layer dropout: ``drop_mode`` 0 (none), 1 (``drop_arr`` holds
    (L-1, T, B, H) {0, 1} masks) or 2 (``drop_arr`` holds two uint32 seed
    words, ``keep_prob`` the keep of the bits); ``drop_scale`` multiplies
    the kept values (1/keep).

    x (T, B, D) and the weights w_x0 (D, 4H), w_h (L, H, 4H),
    w_x_rest (L-1, H, 4H) in the compute dtype; b_all (L, 4H), mask
    (T, 1, B), h0, c0 (L, B, H) float32.  Returns the residual streams
    (outs, gates, cseq) and (hn, cn) as ``wavefront_train_plain`` does;
    on a CUDA device (bf16 operands and residuals) the kernel
    ``wavefront_plan`` picks by shape, the persistent one
    (``persistent_launches`` adds the library's count of its launches) or
    the per-diagonal one; the plain version on the CPU."""
    T, B, D = x.shape
    L, H = w_h.shape[0], w_h.shape[1]
    if w_x_rest.shape[0] != L - 1 or b_all.shape[0] != L:
        raise ValueError("w_x_rest must cover layers 1..L-1 and b_all all L")
    if not x.is_cuda:
        return wavefront_train_plain(x, w_x0, w_h, w_x_rest, b_all, mask, h0, c0,
                                     res_dtype, drop_mode, drop_arr, drop_scale,
                                     keep_prob)
    if L < 2:
        raise ValueError("the wavefront kernel needs >= 2 layers")
    if res_dtype != bf16:
        raise TypeError(f"the training kernel stores bf16 residuals, got {res_dtype}")
    if D % 64:
        raise ValueError(f"the training kernel needs D % 64 == 0, got D={D}")
    dev = x.device
    check_kernel_inputs([
        ("x", x, bf16, (T, B, D)),
        ("w_x0", w_x0, bf16, (D, 4 * H)),
        ("w_h", w_h, bf16, (L, H, 4 * H)),
        ("w_x_rest", w_x_rest, bf16, (L - 1, H, 4 * H)),
        ("b_all", b_all, f32, (L, 4 * H)),
        ("mask", mask, f32, (T, 1, B)),
        ("h0", h0, f32, (L, B, H)),
        ("c0", c0, f32, (L, B, H)),
    ], dev, H)
    masks, seed0, seed1, thr, scale = _drop_launch_args(
        drop_mode, drop_arr, keep_prob, drop_scale, (L - 1, T, B, H), dev)
    plan = wavefront_plan(B, H, L, D, torch.cuda.get_device_properties(dev).multi_processor_count)
    drop = (drop_mode, masks, seed0, seed1, thr, scale)
    if plan["kernel"] == "persistent":
        before = persistent_launches()
        res = _persistent_launch(x, w_x0, w_h, w_x_rest, b_all, mask, h0, c0, drop, plan)
        wavefront_train.persistent_launches += persistent_launches() - before
    else:
        res = _per_diagonal_launch(x, w_x0, w_h, w_x_rest, b_all, mask, h0, c0, drop)
    if T:                                            # T = 0 launches nothing
        wavefront_train.launches += 1
    return res


def _per_diagonal_launch(x, w_x0, w_h, w_x_rest, b_all, mask, h0, c0, drop):
    """The per-diagonal forward (csrc/lstm_wavefront_train.cu): one launch
    a diagonal, any B.  ``drop`` as ``_persistent_launch`` takes it.
    Returns (outs, gates, cseq, hn, cn)."""
    T, B, D = x.shape
    L, H = w_h.shape[0], w_h.shape[1]
    drop_mode, masks, seed0, seed1, thr, scale = drop
    dev = x.device
    with torch.cuda.device(dev):
        Bp = -(-B // 16) * 16
        # The dropped copies the layers above read, by diagonal parity.
        xb = (torch.zeros((2, L - 1, Bp, H), dtype=bf16, device=dev)
              if drop_mode else None)
        if Bp != B:  # the cell reads whole 16-row tiles of x
            x = torch.nn.functional.pad(x, (0, 0, 0, Bp - B))
        hb = torch.zeros((2, L, Bp, H), dtype=bf16, device=dev)
        hb[:, :, :B] = h0.to(bf16)[None]
        h, c = h0.clone(), c0.clone()
        outs = torch.empty((L, T, B, H), dtype=bf16, device=dev)
        gates = torch.empty((L, T, B, 4 * H), dtype=bf16, device=dev)
        cseq = torch.empty((L, T, B, H), dtype=bf16, device=dev)
        if T == 0:
            return outs, gates, cseq, h, c
        fn = _build.load("lstm_wavefront_train").rst_lstm_wavefront_train
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p] * 2 + [ctypes.c_uint] * 3
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        rc = fn(x.data_ptr(), w_x0.data_ptr(), w_h.data_ptr(), w_x_rest.data_ptr(),
                b_all.data_ptr(), mask.data_ptr(), hb.data_ptr(), h.data_ptr(),
                c.data_ptr(), outs.data_ptr(), gates.data_ptr(), cseq.data_ptr(),
                T, B, H, D, L, drop_mode, _ptr(masks), _ptr(xb), seed0, seed1, thr,
                scale, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lstm_wavefront_train kernel launch failed: CUDA error {rc}")
    return outs, gates, cseq, h, c


wavefront_train.launches = 0
wavefront_train.persistent_launches = 0


def wavefront_bwd_plain(dout_top: Tensor, w_h: Tensor, w_x_rest: Tensor,
                        mask: Tensor, gates: Tensor, cseq: Tensor, c0: Tensor,
                        dhn: Tensor, dcn: Tensor, outs: Tensor = None,
                        drop_mode: int = 0, drop_arr=None, drop_scale: float = 1.0,
                        keep_prob: float = 1.0, fuse_dwx: bool = False):
    """The reverse diagonal in plain PyTorch, layer by layer from the top
    (the same math: layer l's upstream cotangent is the layer above's
    dgates·W_xᵀ at the same t, times boundary l's keep·drop_scale in drop
    modes 1 and 2).  dgates products round dgates to the weights' dtype
    and sum in float32.  Overwrites ``gates`` with dgates (in its dtype),
    as the kernel does; returns (dgates, dh0, dc0), and in drop modes 1
    and 2 also xdrop (L-1, T, B, H) = outs·keep·drop_scale of boundaries
    0..L-2 in the residual dtype.  With ``fuse_dwx`` (drop modes 0 and 2)
    the fourth result is dwx (L-1, H, 4H) float32 instead, dW_x of layers
    1..L-1 = Σ_t x_inᵀ·dgates over one boundary's rows at a time, both
    operands rounded to the weights' dtype (x_in = outs·keep·drop_scale,
    or outs in mode 0), and no xdrop is formed."""
    L, T, B, four_h = gates.shape
    H = four_h // 4
    wd = w_h.dtype
    _check_fuse(fuse_dwx, drop_mode, L, outs)
    keeps = drop_keeps(drop_mode, drop_arr, keep_prob, (L - 1, T, B, H), gates.device)
    xdrop = None if keeps is None or fuse_dwx else gates.new_empty((L - 1, T, B, H))
    dwx = gates.new_zeros((L - 1, H, four_h), dtype=f32) if fuse_dwx else None
    dh0, dc0 = [], []
    dout = dout_top.to(f32)
    for l in reversed(range(L)):
        wh_t = w_h[l].to(f32).t()
        dh_carry, dc_carry = dhn[l].to(f32), dcn[l].to(f32)
        dg_f32 = gates.new_empty((T, B, four_h), dtype=f32)
        for t in reversed(range(T)):
            i_a, g_a, f_a, o_a = gates[l, t].to(f32).split(H, dim=-1)
            m = mask[t, 0][:, None]
            tanh_c = torch.tanh(cseq[l, t].to(f32))
            c_prev = cseq[l, t - 1].to(f32) if t > 0 else c0[l].to(f32)
            dh_new = m * (dout[t] + dh_carry)
            do_pre = dh_new * tanh_c * o_a * (1.0 - o_a)
            dc_new = dh_new * o_a * (1.0 - tanh_c * tanh_c) + m * dc_carry
            di_pre = dc_new * g_a * i_a * (1.0 - i_a)
            dg_pre = dc_new * i_a * (1.0 - g_a * g_a)
            df_pre = dc_new * c_prev * f_a * (1.0 - f_a)
            dg = torch.cat([di_pre, dg_pre, df_pre, do_pre], dim=-1)
            dg_f32[t] = dg
            dh_carry = (1.0 - m) * dh_carry + torch.matmul(dg.to(wd).to(f32), wh_t)
            dc_carry = (1.0 - m) * dc_carry + dc_new * f_a
            gates[l, t] = dg  # after the last read of the gate views
        dh0.append(dh_carry)
        dc0.append(dc_carry)
        if l > 0:
            dg_c = dg_f32.to(wd).to(f32)
            dout = torch.matmul(dg_c, w_x_rest[l - 1].to(f32).t())
            ks = None if keeps is None else keeps[l - 1] * drop_scale
            if ks is not None:
                dout = dout * ks
            if fuse_dwx:
                x_in = outs[l - 1].to(f32) if ks is None else outs[l - 1].to(f32) * ks
                dwx[l - 1] = torch.matmul(x_in.to(wd).to(f32).reshape(-1, H).t(),
                                          dg_c.reshape(-1, four_h))
            elif ks is not None:
                xdrop[l - 1] = (outs[l - 1].to(f32) * ks).to(xdrop.dtype)
    res = (gates, torch.stack(dh0[::-1]), torch.stack(dc0[::-1]))
    if fuse_dwx:
        return res + (dwx,)
    return res if xdrop is None else res + (xdrop,)


def _bwd_buffers(L: int, T: int, B: int, H: int, drop_mode: int, fuse_dwx: bool,
                 device) -> Tuple[Tensor, Tensor, int]:
    """(xdrop, dwx, window): the kernel's outputs beside dgates, dh0 and dc0
    and its accumulation window.  Unfused: the (L-1, T, B, H) bf16 xdrop
    stream in drop modes 1 and 2 (None in mode 0), no dwx, window 0.
    Fused: the (L-1, W, B, H) bf16 ring of W = min(FUSE_DWX_WINDOW,
    T + L - 1) diagonals in mode 2 (None in mode 0), the zeroed
    (L-1, H, 4H) float32 dwx and W."""
    if not fuse_dwx:
        xdrop = (torch.empty((L - 1, T, B, H), dtype=bf16, device=device)
                 if drop_mode else None)
        return xdrop, None, 0
    W = min(FUSE_DWX_WINDOW, T + L - 1)
    ring = (torch.empty((L - 1, W, B, H), dtype=bf16, device=device)
            if drop_mode == 2 else None)
    return ring, torch.zeros((L - 1, H, 4 * H), dtype=f32, device=device), W


# The persistent reverse diagonal (csrc/lstm_wavefront_bwd_persistent.cu):
# hidden units of a slice (the products' N) and its CTAs (a K split in four,
# one gate's H columns each), and the bytes of one 96-unit box of W (64 K,
# bf16).  The A boxes are the forwards' 64-row boxes.
WAVEFRONT_BWD_UNITS, WAVEFRONT_BWD_SPLIT = 96, 4
_WB_BOX = WAVEFRONT_BWD_UNITS * 64 * 2


def wavefront_bwd_smem(resident: int) -> int:
    """Dynamic shared memory of the persistent reverse diagonal:
    ``resident`` boxes of W_h (64-wide K chunks of the CTA's gate for its
    slice's 96 units), the W ring's and the A ring's stages, the mbarriers
    and the 1024-byte alignment slack (the kernel's ``smem_bytes``)."""
    return ((resident + WAVEFRONT_W_STAGES) * _WB_BOX + WAVEFRONT_A_STAGES * _WF_ABOX
            + 8 * (1 + 2 * (WAVEFRONT_W_STAGES + WAVEFRONT_A_STAGES)) + 1024)


def wavefront_bwd_layout(B: int, H: int, L: int, sms: int = H100_SMS):
    """The persistent reverse diagonal's grid at (B, H, L) on a card of
    ``sms`` SMs, or None where the kernel cannot take the shape: ``slices``
    = ceil(H/96) slices of 96 units a layer, each four CTAs (CTA (l, u, q)
    takes gate q's H columns of K), one CTA an SM for all L layers, B <= 64
    (one tile), H a multiple of 64.  ``resident`` is as many of the gate's
    H/64 K chunks of W_h as fit beside the rings (14 of 16 at H=1024; the
    kernel's ``resident_chunks``).  Returns {"slices", "grid", "resident",
    "smem"}."""
    if not 1 <= B <= WAVEFRONT_ROWS or L < 2 or H < 64 or H % 64:
        return None
    slices = -(-H // WAVEFRONT_BWD_UNITS)
    grid = L * slices * WAVEFRONT_BWD_SPLIT
    if grid > sms:
        return None
    resident = min(H // 64, (SMEM_LIMIT - wavefront_bwd_smem(0)) // _WB_BOX)
    return {"slices": slices, "grid": grid, "resident": resident,
            "smem": wavefront_bwd_smem(resident)}


def wavefront_bwd_plan(B: int, H: int, L: int, fuse_dwx: bool = False,
                       sms: int = H100_SMS) -> dict:
    """Which kernel runs the reverse diagonal at (B, H, L) on a card of
    ``sms`` SMs, decided by shape alone: the persistent one for the unfused
    pass where ``wavefront_bwd_layout`` takes the shape (the default step's
    B=64 at 3x1024: 3 x 11 x 4 = 132 CTAs), else the per-diagonal kernel
    (the fused dW_x, B past one tile, more CTAs than SMs).  Returns
    {"kernel": "persistent", **layout} or {"kernel": "per_diagonal"}."""
    layout = None if fuse_dwx else wavefront_bwd_layout(B, H, L, sms)
    if layout is None:
        return {"kernel": "per_diagonal"}
    return {"kernel": "persistent", **layout}


def _bwd_persistent_launch(dout_top, w_h, w_x_rest, mask, gates, cseq, c0, dhn, dcn, outs,
                           drop, plan, skip_waits=0, stamps=None):
    """The persistent reverse diagonal on the plan's grid (unfused).
    ``drop`` is ``_drop_launch_args``' (masks, seed0, seed1, threshold,
    scale) with the drop mode first; ``skip_waits`` plants a fault (no layer
    counter waits: each layer reads dgates before their writers publish
    them), for checks; ``stamps``, a (T + 1, 5) int64 tensor on the device,
    takes CTA 0's SM clock at five points of each pass (the kernel's
    ``Args::stamps``), for studies.  Overwrites ``gates`` with dgates;
    returns (dgates, dh0, dc0) and in drop modes 1 and 2 xdrop."""
    L, T, B, four_h = gates.shape
    H = four_h // 4
    drop_mode, masks, seed0, seed1, thr, scale = drop
    dev = gates.device
    S = plan["slices"]
    with torch.cuda.device(dev):
        dh, dc = dhn.clone(), dcn.clone()
        xdrop = torch.empty((L - 1, T, B, H), dtype=bf16, device=dev) if drop_mode else None
        res = (gates, dh, dc) if xdrop is None else (gates, dh, dc, xdrop)
        if T == 0:
            return res
        part = torch.empty((L, S, 2, WAVEFRONT_BWD_SPLIT, 2, WAVEFRONT_ROWS,
                            WAVEFRONT_BWD_UNITS), dtype=f32, device=dev)
        counter = torch.zeros((L * (1 + S),), dtype=torch.int32, device=dev)
        fn = _build.load("lstm_wavefront_bwd_persistent").rst_lstm_wavefront_bwd_persistent
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3
                       + [ctypes.c_uint] * 3
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        rc = fn(dout_top.data_ptr(), w_h.data_ptr(), w_x_rest.data_ptr(), mask.data_ptr(),
                gates.data_ptr(), cseq.data_ptr(), c0.data_ptr(), dh.data_ptr(), dc.data_ptr(),
                part.data_ptr(), counter.data_ptr(), T, B, H, L, S, drop_mode, _ptr(masks),
                _ptr(outs if drop_mode else None), _ptr(xdrop), seed0, seed1, thr, scale,
                skip_waits, _ptr(stamps), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"persistent lstm_wavefront_bwd kernel launch failed: CUDA error "
                           f"{rc} (plan {plan})")
    return res


def _bwd_per_diagonal_launch(dout_top, w_h, w_x_rest, mask, gates, cseq, c0, dhn, dcn, outs,
                             drop, fuse_dwx=False):
    """The per-diagonal reverse diagonal (csrc/lstm_wavefront_bwd.cu): one
    launch a diagonal, any B, and the fused dW_x.  ``drop`` as
    ``_bwd_persistent_launch`` takes it.  Returns ``wavefront_bwd``'s
    results; adds its window products on the Hopper tile to
    ``wavefront_bwd.wgmma_products``."""
    L, T, B, four_h = gates.shape
    H = four_h // 4
    drop_mode, masks, seed0, seed1, thr, scale = drop
    dev = gates.device
    with torch.cuda.device(dev):
        dh, dc = dhn.clone(), dcn.clone()
        xdrop, dwx, window = _bwd_buffers(L, T, B, H, drop_mode, fuse_dwx, dev)
        if fuse_dwx:
            res = (gates, dh, dc, dwx)
        else:
            res = (gates, dh, dc) if xdrop is None else (gates, dh, dc, xdrop)
        if T == 0:
            return res
        Bp = -(-B // 16) * 16
        par = torch.zeros((2, L, Bp, 4 * H), dtype=bf16, device=dev)
        lib = _build.load("lstm_wavefront_bwd")
        fn = lib.rst_lstm_wavefront_bwd
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p] * 3 + [ctypes.c_uint] * 3
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        products = lib.rst_wgmma_products
        products.argtypes, products.restype = [], ctypes.c_longlong
        before = products()
        rc = fn(dout_top.data_ptr(), w_h.data_ptr(), w_x_rest.data_ptr(),
                mask.data_ptr(), gates.data_ptr(), cseq.data_ptr(), c0.data_ptr(),
                par.data_ptr(), dh.data_ptr(), dc.data_ptr(), T, B, H, L, drop_mode,
                _ptr(masks), _ptr(outs if drop_mode or fuse_dwx else None), _ptr(xdrop),
                seed0, seed1, thr, scale, window, _ptr(dwx),
                grad_matmul.PATH_IDS[grad_matmul.product_path([H], 4 * H, bf16)],
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lstm_wavefront_bwd kernel launch failed: CUDA error {rc}")
    wavefront_bwd.wgmma_products += products() - before
    return res


def wavefront_bwd(dout_top: Tensor, w_h: Tensor, w_x_rest: Tensor, mask: Tensor,
                  gates: Tensor, cseq: Tensor, c0: Tensor, dhn: Tensor,
                  dcn: Tensor, outs: Tensor = None, drop_mode: int = 0, drop_arr=None,
                  drop_scale: float = 1.0, keep_prob: float = 1.0,
                  fuse_dwx: bool = False):
    """Backward of the whole stack on the reverse diagonal.

    In drop modes 1 and 2 (arguments as ``wavefront_train``'s) it also
    reads ``outs`` (L, T, B, H), the forward's masked outputs, and returns
    xdrop (L-1, T, B, H) after dh0, dc0.  With ``fuse_dwx`` (drop modes 0
    and 2; it reads ``outs`` in both) it returns instead dwx (L-1, H, 4H)
    float32, dW_x of layers 1..L-1, accumulated by the pass in windows of
    ``FUSE_DWX_WINDOW`` diagonals; no xdrop stream is allocated
    (``_bwd_buffers``); the window products take the tile that
    ``grad_matmul.product_path`` picks for (H, 4H, bf16) dgates, the Hopper
    tile at H a multiple of 64.  ``wavefront_bwd.fused_launches`` counts the
    fused calls that launched the kernel, ``wavefront_bwd.wgmma_products``
    the window products they launched on the Hopper tile.

    dout_top (T, B, H): cotangent of the top layer's output; w_h, w_x_rest
    in the compute dtype; mask (T, 1, B); gates (L, T, B, 4H) and cseq
    (L, T, B, H): the forward's residuals; c0, dhn, dcn (L, B, H) float32.
    ``gates`` is overwritten with dgates.  Returns (dgates (the ``gates``
    tensor), dh0, dc0); on a CUDA device (bf16 operands and residuals) the
    kernel ``wavefront_bwd_plan`` picks by shape, the persistent one
    (``persistent_launches`` adds the library's count of its launches) or
    the per-diagonal one; the plain version on the CPU."""
    L, T, B, four_h = gates.shape
    H = four_h // 4
    if w_h.shape[0] != L or w_x_rest.shape[0] != L - 1:
        raise ValueError("w_h must cover all L layers and w_x_rest layers 1..L-1")
    if not gates.is_cuda:
        return wavefront_bwd_plain(dout_top, w_h, w_x_rest, mask, gates, cseq, c0,
                                   dhn, dcn, outs, drop_mode, drop_arr, drop_scale,
                                   keep_prob, fuse_dwx)
    if L < 2:
        raise ValueError("the wavefront kernel needs >= 2 layers")
    _check_fuse(fuse_dwx, drop_mode, L, outs)
    dev = gates.device
    check_kernel_inputs([
        ("dout_top", dout_top, bf16, (T, B, H)),
        ("w_h", w_h, bf16, (L, H, 4 * H)),
        ("w_x_rest", w_x_rest, bf16, (L - 1, H, 4 * H)),
        ("mask", mask, f32, (T, 1, B)),
        ("gates", gates, bf16, (L, T, B, 4 * H)),
        ("cseq", cseq, bf16, (L, T, B, H)),
        ("c0", c0, f32, (L, B, H)),
        ("dhn", dhn, f32, (L, B, H)),
        ("dcn", dcn, f32, (L, B, H)),
    ] + ([("outs", outs, bf16, (L, T, B, H))] if drop_mode or fuse_dwx else []), dev, H)
    drop = (drop_mode, *_drop_launch_args(drop_mode, drop_arr, keep_prob, drop_scale,
                                          (L - 1, T, B, H), dev))
    plan = wavefront_bwd_plan(B, H, L, fuse_dwx,
                              torch.cuda.get_device_properties(dev).multi_processor_count)
    args = (dout_top, w_h, w_x_rest, mask, gates, cseq, c0, dhn, dcn, outs, drop)
    if plan["kernel"] == "persistent":
        count = ("lstm_wavefront_bwd_persistent", "rst_wavefront_bwd_persistent_launches")
        before = _library_launches(*count)
        res = _bwd_persistent_launch(*args, plan)
        wavefront_bwd.persistent_launches += _library_launches(*count) - before
    else:
        res = _bwd_per_diagonal_launch(*args, fuse_dwx)
    if T:                                            # T = 0 launches nothing
        wavefront_bwd.launches += 1
        wavefront_bwd.fused_launches += int(fuse_dwx)
    return res


wavefront_bwd.launches = 0
wavefront_bwd.persistent_launches = 0
wavefront_bwd.fused_launches = 0
wavefront_bwd.wgmma_products = 0


def dwx_windows_plain(outs: Tensor, dgates: Tensor) -> Tensor:
    """dW_x of layers 1..L-1 from the outs residual: (L-1, H, 4H) float32,
    Σ_t bf16(outs_l(t))ᵀ·bf16(dgates_{l+1}(t)) with float32 sums."""
    return torch.stack([grad_matmul.weight_grad_plain(outs[l], dgates[l + 1])[0]
                        for l in range(outs.shape[0] - 1)])


def dwx_windows(outs: Tensor, dgates: Tensor, window: int = None) -> Tensor:
    """The fused reverse pass's window products alone, as drop mode 0 runs
    them (``rst_dwx_windows``): dW_x of layers 1..L-1, (L-1, H, 4H)
    float32, added window by window of ``window`` diagonals
    (``FUSE_DWX_WINDOW``) on the tile ``grad_matmul.product_path`` picks.
    For timing and tests of the window products; the plain version on
    the CPU.  outs (L, T, B, H) and dgates (L, T, B, 4H) bf16."""
    if not dgates.is_cuda:
        return dwx_windows_plain(outs, dgates)
    L, T, B, H = outs.shape
    check_kernel_inputs([("outs", outs, bf16, (L, T, B, H)),
                         ("dgates", dgates, bf16, (L, T, B, 4 * H))], dgates.device, H)
    W = min(window or FUSE_DWX_WINDOW, T + L - 1)
    dwx = torch.zeros((L - 1, H, 4 * H), dtype=f32, device=dgates.device)
    if T == 0:
        return dwx
    with torch.cuda.device(dgates.device):
        fn = _build.load("lstm_wavefront_bwd").rst_dwx_windows
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        rc = fn(outs.data_ptr(), dgates.data_ptr(), T, B, H, L, W, dwx.data_ptr(),
                grad_matmul.PATH_IDS[grad_matmul.product_path([H], 4 * H, bf16)],
                torch.cuda.current_stream(dgates.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lstm_wavefront_bwd window products failed: CUDA error {rc}")
    return dwx


def layered_stack_bwd(dout_top: Tensor, w_h: Tensor, w_x_rest: Tensor, mask: Tensor,
                      gates: Tensor, cseq: Tensor, c0: Tensor, dhn: Tensor, dcn: Tensor,
                      outs: Tensor, cd, drop_mode: int = 0, drop_arr=None,
                      drop_scale: float = 1.0):
    """Backward of the stack layer by layer from the top (the layered
    fallback of ``_wavefront_stack_bwd``): each layer's reverse runs on
    its gates and cseq residuals through ``lstm_layer_train.recurrence_bwd``
    (dgates written over ``gates[l]``), from c0 rounded to the residual
    dtype; the cotangent of the layer below is dgates_l·W_x,lᵀ (float32
    sums of compute-dtype operands), times boundary l-1's mask·drop_scale
    in drop mode 1.  Drop mode 2 is not taken: its bits must be a mask
    stream first.  Returns (dgates, dh0, dc0, xdrop) with xdrop (L-1, T,
    B, H) = outs·mask·drop_scale in the compute dtype (mode 1) or None."""
    if drop_mode not in (0, 1):
        raise ValueError(f"the layered stack backward takes drop mode 0 or 1, got "
                         f"{drop_mode}")
    L = gates.shape[0]
    rd = gates.dtype
    dh0, dc0 = [None] * L, [None] * L
    dout = dout_top.to(f32)
    for l in reversed(range(L)):
        _, dh0[l], dc0[l] = lstm_layer_train.recurrence_bwd(
            dout.contiguous(), gates[l], cseq[l], c0[l].to(rd).to(f32).contiguous(), mask,
            w_h[l].to(cd).contiguous(), dhn[l].to(f32).contiguous(),
            dcn[l].to(f32).contiguous())
        if l > 0:
            dout = dot_f32(gates[l], w_x_rest[l - 1].t(), cd)
            if drop_mode == 1:
                dout = dout * (drop_arr[l - 1].to(f32) * drop_scale)
    xdrop = None
    if drop_mode == 1:
        xdrop = torch.stack([(outs[l].to(f32) * (drop_arr[l].to(f32) * drop_scale)).to(cd)
                             for l in range(L - 1)])
    return gates, torch.stack(dh0), torch.stack(dc0), xdrop


def _hgrad_only(h_prev: Tensor, dgates: Tensor, cd) -> Tuple[Tensor, Tensor]:
    """(dW_h, db) of a layer whose dW_x came out of the fused reverse pass
    (``_hgrad_only``): the one-operand weight-gradient kernel
    (``weight_grad``) by default, the two-product plain form under
    ``RST_FUSED_WGRAD=0``."""
    if os.environ.get("RST_FUSED_WGRAD", "1") != "0":
        return weight_grad(h_prev, dgates, compute_dtype=cd)
    dg = dgates.reshape(-1, dgates.shape[-1])
    return (dot_f32(h_prev.reshape(-1, h_prev.shape[-1]).t(), dg, cd),
            dg.to(f32).sum(0))


def stack_weight_grads(x_c: Tensor, h0: Tensor, outs: Tensor, dgates: Tensor,
                       w_x0: Tensor, cd, xdrop: Tensor = None,
                       dwx: Tensor = None) -> Tuple[Tensor, ...]:
    """The weight gradients and dx of the stack from its dgates
    (``_wavefront_stack_bwd`` after the reverse kernel).

    Per layer, h_prev is the layer's output shifted one step later behind
    bf16(h0) (the shift copy), its input is x_c for layer 0 and otherwise
    the lower layer's output, or its dropped copy ``xdrop[l-1]`` when a
    drop mode is on, and one ``dgates_weight_grads`` pass gives
    (dW_h, dW_x, db).  With ``dwx`` (the fused reverse pass's dW_x of
    layers 1..L-1) those layers take dW_x from it and (dW_h, db) from
    ``_hgrad_only``.  dx = dgates_0·W_x0ᵀ stays a matmul, cast to the
    compute dtype as the JAX package casts it.  Returns (dw_x0, dw_x_rest,
    dw_h, db0, db_rest, dx)."""
    L = dgates.shape[0]
    rd = outs.dtype
    dw_h, dw_x, db = [], [], []
    for l in range(L):
        h_prev = torch.cat([h0[l].to(rd)[None], outs[l, :-1]], dim=0)
        if l > 0 and dwx is not None:
            g_h, g_b = _hgrad_only(h_prev, dgates[l], cd)
            dw_h.append(g_h)
            dw_x.append(dwx[l - 1])
            db.append(g_b)
            continue
        if l == 0:
            x_l = x_c
        else:
            x_l = outs[l - 1] if xdrop is None else xdrop[l - 1]
        g_h, g_x, g_b = dgates_weight_grads(h_prev, x_l, dgates[l], compute_dtype=cd)
        dw_h.append(g_h)
        dw_x.append(g_x)
        db.append(g_b)
    dx = dot_f32(dgates[0], w_x0.t(), cd).to(x_c.dtype)
    return dw_x[0], torch.stack(dw_x[1:]), torch.stack(dw_h), db[0], \
        torch.stack(db[1:]), dx


class _WavefrontStackTrain(torch.autograd.Function):
    """Differentiable L-layer wavefront stack with gates-mode residuals
    (``_wavefront_stack_core``/``_fwd``/``_bwd``).  ``drop`` is
    (drop_mode, drop_arr, drop_scale, keep_prob): ``drop_arr`` holds the
    (L-1, T, B, H) masks (mode 1) or the two seed words (mode 2), carried
    to the backward as they are.  ``bwd_wavefront`` picks the reverse
    diagonal or the layered backward (drop modes 0 and 1 only); on the
    reverse diagonal ``fuse_dwx_enabled`` picks the fused dW_x.  The
    backward consumes the saved gates residual (dgates overwrite it), so
    it runs once."""

    @staticmethod
    def forward(ctx, w_x0, w_x_rest, w_h, b0, b_rest, x, c0, h0, mask, cd, rd, drop,
                bwd_wavefront):
        b_all = torch.cat([b0.to(f32)[None], b_rest.to(f32)], dim=0)
        x_c = x.to(cd)
        outs, gates, cseq, hn, cn = wavefront_train(
            x_c.contiguous(), w_x0.to(cd).contiguous(), w_h.to(cd).contiguous(),
            w_x_rest.to(cd).contiguous(), b_all.contiguous(), mask,
            h0.to(f32).contiguous(), c0.to(f32).contiguous(), rd, *drop)
        ctx.save_for_backward(w_x0, w_x_rest, w_h, x_c, mask, c0, h0, outs, gates,
                              cseq)
        ctx.cd = cd
        ctx.drop = drop
        ctx.bwd_wavefront = bwd_wavefront
        ctx.consumed = False
        return outs[-1], cn, hn

    @staticmethod
    def backward(ctx, dout_top, dcn, dhn):
        if ctx.consumed:
            raise RuntimeError("the wavefront stack's backward runs once: it "
                               "overwrites its gates residual with dgates")
        ctx.consumed = True
        stages.mark("stack_backward")
        (w_x0, w_x_rest, w_h, x_c, mask, c0, h0, outs, gates,
         cseq) = ctx.saved_tensors
        cd = ctx.cd
        dwx = None
        if ctx.bwd_wavefront:
            L, T, B = gates.shape[:3]
            fuse = fuse_dwx_enabled(L, T, B, w_h.shape[1], gates.element_size(),
                                    ctx.drop[0])
            res = wavefront_bwd(
                dout_top.to(gates.dtype).contiguous(), w_h.to(cd).contiguous(),
                w_x_rest.to(cd).contiguous(), mask, gates, cseq,
                c0.to(f32).contiguous(), dhn.to(f32).contiguous(),
                dcn.to(f32).contiguous(), outs, *ctx.drop, fuse_dwx=fuse)
            dgates, dh0, dc0 = res[:3]
            xdrop = res[3] if len(res) > 3 and not fuse else None
            dwx = res[3] if fuse else None
        else:
            dgates, dh0, dc0, xdrop = layered_stack_bwd(
                dout_top, w_h, w_x_rest, mask, gates, cseq, c0, dhn, dcn, outs, cd,
                *ctx.drop[:3])
        stages.mark("weight_grads")
        dw_x0, dw_x_rest, dw_h, db0, db_rest, dx = stack_weight_grads(
            x_c, h0, outs, dgates, w_x0, cd, xdrop, dwx)
        return (dw_x0.to(w_x0.dtype), dw_x_rest.to(w_x_rest.dtype),
                dw_h.to(w_h.dtype), db0, db_rest, dx, dc0.to(c0.dtype),
                dh0.to(h0.dtype), None, None, None, None, None)


def lstm_stack_wavefront_train(layer_params, x: Tensor, seq_lengths: Tensor,
                               states: List[LayerState], drop_masks: Tensor = None,
                               drop_scale: float = 1.0, drop_seed=None,
                               drop_keep: float = 1.0, compute_dtype=f32,
                               residual_dtype=None, bwd_wavefront=None,
                               ) -> Tuple[Tensor, List[LayerState]]:
    """Differentiable wavefront stack matching the layered stack's
    gates-mode semantics, given the same inter-layer dropout masks.
    Returns (out (T, B, H) in the residual dtype, [(c, h)] per layer).
    ``residual_dtype`` defaults to bf16 for bf16 compute, else float32.

    Inter-layer dropout comes in two forms: ``drop_masks`` (L-1, T, B, H)
    {0, 1} times the static ``drop_scale`` (mode 1, the parity-testable
    form), or ``drop_seed`` (two uint32 words) with ``drop_keep`` (mode 2:
    both kernels draw the bits, no mask stream exists).

    ``bwd_wavefront`` picks the backward: the reverse diagonal (True) or
    the layered per-layer reverse (False); None reads
    ``RST_WAVEFRONT_BWD`` (on unless "0").  The layered backward consumes
    the masks outside the kernels, so seed-mode dropout becomes the mask
    stream ``dropout.bernoulli_mask(drop_seed, (L-1, T, B, H), drop_keep)``
    in bf16 with drop_scale = 1/drop_keep (mode 1) there."""
    if bwd_wavefront is None:
        bwd_wavefront = os.environ.get("RST_WAVEFRONT_BWD", "1") != "0"
    if drop_masks is not None and drop_seed is not None:
        raise ValueError("pass drop_masks or drop_seed, not both")
    T, B = x.shape[:2]
    L = len(layer_params)
    if L < 2:
        raise ValueError("the wavefront stack needs >= 2 layers")
    cd = compute_dtype
    rd = residual_dtype or (bf16 if cd == bf16 else f32)
    if drop_seed is not None and not bwd_wavefront:
        H = layer_params[0]["w_h"].shape[0]
        drop_masks, drop_scale = dropout.boundary_masks(drop_seed, (L - 1, T, B, H),
                                                        drop_keep, x.device)
        drop_seed = None
    if drop_seed is not None:
        drop = (2, tuple(int(w) for w in drop_seed), float(drop_scale), float(drop_keep))
    elif drop_masks is not None:
        drop = (1, drop_masks.detach(), float(drop_scale), 1.0)
    else:
        drop = (0, None, 1.0, 1.0)
    mask = length_mask(T, seq_lengths, x.device)
    w_x_rest = torch.stack([p["w_x"] for p in layer_params[1:]])
    b_rest = torch.stack([p["b"] for p in layer_params[1:]])
    w_h = torch.stack([p["w_h"] for p in layer_params])
    c0 = torch.stack([c for c, _ in states])
    h0 = torch.stack([h for _, h in states])
    out, cn, hn = _WavefrontStackTrain.apply(
        layer_params[0]["w_x"], w_x_rest, w_h, layer_params[0]["b"], b_rest, x,
        c0, h0, mask, cd, rd, drop, bool(bwd_wavefront))
    return out, [(cn[l], hn[l]) for l in range(L)]
