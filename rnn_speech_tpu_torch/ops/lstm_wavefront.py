"""Whole-stack LSTM inference on the (layer, time) diagonal: CUDA kernel,
wrapper, plain version.

Counterpart of ``lstm_stack_wavefront`` (``_wavefront_kernel``) and
``lstm_stack_wavefront_apply`` in ``rnn_speech_tpu/ops/lstm_wavefront.py``.
Diagonal s computes, for every layer l with 0 <= t = s - l < T, that
layer's step t.  Layer 0 adds the precomputed ``xp0 = x·W_x0 + b0``;
layers l >= 1 take the lower layer's carried h and apply their own
``b_l + bf16(h^{l-1})·W_x,l`` inside the step.  Each layer sees its
input one diagonal after it is produced, so the math is the layered
stack's; only the schedule differs.

``lstm_stack_wavefront`` takes the plain version for tensors on the CPU
and launches the kernel (``csrc/lstm_wavefront.cu``) for tensors on a
CUDA device, or raises; there is no fallback.
``lstm_stack_wavefront.launches`` counts the calls that launched the
kernel (each call issues T + L - 1 CUDA launches from one host call).
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from rnn_speech_tpu_torch.ops import _build
from rnn_speech_tpu_torch.ops.lstm import LayerState, dot_f32, length_mask
from rnn_speech_tpu_torch.ops.lstm_recurrence import check_kernel_inputs

Tensor = torch.Tensor


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


def _lib_fn():
    fn = _build.load("lstm_wavefront").rst_lstm_wavefront
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def lstm_stack_wavefront(
    xp0: Tensor,        # (T, B, 4H) f32: layer 0's x·W_x0 + b0
    w_h: Tensor,        # (L, H, 4H) compute dtype
    w_x_rest: Tensor,   # (L-1, H, 4H) compute dtype: layers 1..L-1
    b_rest: Tensor,     # (L-1, 1, 4H) f32
    mask: Tensor,       # (T, 1, B) f32 validity mask
    h0: Tensor,         # (L, B, H) f32
    c0: Tensor,         # (L, B, H) f32
) -> Tuple[Tensor, Tensor, Tensor]:
    """(out (T, B, H), hn (L, B, H), cn (L, B, H)); the kernel on a CUDA
    device (bf16 weights), the plain version on the CPU."""
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
    f32, bf16 = torch.float32, torch.bfloat16
    check_kernel_inputs([
        ("xp0", xp0, f32, (T, B, 4 * H)),
        ("w_h", w_h, bf16, (L, H, 4 * H)),
        ("w_x_rest", w_x_rest, bf16, (L - 1, H, 4 * H)),
        ("b_rest", b_rest, f32, (L - 1, 1, 4 * H)),
        ("mask", mask, f32, (T, 1, B)),
        ("h0", h0, f32, (L, B, H)),
        ("c0", c0, f32, (L, B, H)),
    ], dev, H)
    with torch.cuda.device(dev):
        Bp = -(-B // 16) * 16
        hb = torch.zeros((2, L, Bp, H), dtype=bf16, device=dev)
        hb[:, :, :B] = h0.to(bf16)[None]
        h = h0.clone()
        c = c0.clone()
        out = torch.empty((T, B, H), dtype=f32, device=dev)
        if T == 0:
            return out, h, c
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib_fn()(xp0.data_ptr(), w_h.data_ptr(), w_x_rest.data_ptr(),
                       b_rest.data_ptr(), mask.data_ptr(), hb.data_ptr(),
                       h.data_ptr(), c.data_ptr(), out.data_ptr(),
                       T, B, H, L, stream)
    if rc != 0:
        raise RuntimeError(f"lstm_wavefront kernel launch failed: CUDA error {rc}")
    lstm_stack_wavefront.launches += 1
    return out, h, c


lstm_stack_wavefront.launches = 0


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
