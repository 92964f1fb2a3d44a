"""One LSTM layer's inference recurrence: CUDA kernel, wrapper, plain version.

Counterpart of ``lstm_recurrence_pallas`` (``_recurrence_kernel``) in
``rnn_speech_tpu/ops/lstm_pallas.py``.  Given the input pre-activations
of every step, ``x_proj = x·W_x + b`` (T, B, 4H) float32, it walks the
T steps with the recurrent weights W_h (H, 4H):

    gates = x_proj[t] + bf16(h)·W_h          (f32 accumulation)
    i, g, f, o = split(gates)                (gate order i, g, f, o)
    c' = sigmoid(f + 1)·c + sigmoid(i)·tanh(g);  h' = sigmoid(o)·tanh(c')
    c, h = m·(c', h') + (1 - m)·(c, h);  out[t] = m·h'

with ``m`` the {0, 1} validity mask (T, 1, B) of the JAX layout.

``lstm_recurrence`` takes the plain version for tensors on the CPU and
launches the kernel (``csrc/lstm_recurrence.cu``) for tensors on a CUDA
device, or raises; there is no fallback.  ``lstm_recurrence.launches``
counts the calls that launched the kernel (each call issues T CUDA
launches from one host call).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from rnn_speech_tpu_torch.ops import _build

Tensor = torch.Tensor


def lstm_recurrence_plain(x_proj: Tensor, w_h: Tensor, mask: Tensor,
                          h0: Tensor, c0: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """The recurrence in plain PyTorch, with the kernel's casts: h is
    rounded to W_h's dtype before the product, which runs in float32 on
    the rounded values (exact products, f32 sums).
    Returns (out (T, B, H), hn (B, H), cn (B, H)), all float32."""
    T, B, four_h = x_proj.shape
    H = four_h // 4
    w = w_h.to(torch.float32)
    h = h0.to(torch.float32)
    c = c0.to(torch.float32)
    outs = []
    for t in range(T):
        gates = x_proj[t] + torch.matmul(h.to(w_h.dtype).to(torch.float32), w)
        i, g, f, o = gates.split(H, dim=-1)
        c_new = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        m = mask[t, 0][:, None]
        c = m * c_new + (1.0 - m) * c
        h = m * h_new + (1.0 - m) * h
        outs.append(m * h_new)
    out = torch.stack(outs) if outs else x_proj.new_zeros((0, B, H))
    return out, h, c


def _lib_fn():
    fn = _build.load("lstm_recurrence").rst_lstm_recurrence
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check_kernel_inputs(named, device, H: int) -> None:
    """Raise unless every (name, tensor, dtype, shape) lies on ``device``,
    has that dtype and shape, is contiguous and 32-byte aligned (the WMMA
    tile loads), and H is a multiple of 64 (the staged K chunk)."""
    if H % 64:
        raise ValueError(f"the LSTM kernels need H % 64 == 0, got H={H}")
    for name, t, dtype, shape in named:
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 32:
            raise ValueError(f"{name} must be 32-byte aligned")


def lstm_recurrence(x_proj: Tensor, w_h: Tensor, mask: Tensor,
                    h0: Tensor, c0: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """(out (T, B, H), hn, cn) of one layer; the kernel on a CUDA device
    (bf16 W_h, float32 everything else), the plain version on the CPU."""
    if not x_proj.is_cuda:
        return lstm_recurrence_plain(x_proj, w_h, mask, h0, c0)
    T, B, four_h = x_proj.shape
    H = four_h // 4
    dev = x_proj.device
    f32 = torch.float32
    check_kernel_inputs([
        ("x_proj", x_proj, f32, (T, B, 4 * H)),
        ("w_h", w_h, torch.bfloat16, (H, 4 * H)),
        ("mask", mask, f32, (T, 1, B)),
        ("h0", h0, f32, (B, H)),
        ("c0", c0, f32, (B, H)),
    ], dev, H)
    with torch.cuda.device(dev):
        Bp = -(-B // 16) * 16
        hb = torch.zeros((2, Bp, H), dtype=torch.bfloat16, device=dev)
        hb[0, :B] = h0.to(torch.bfloat16)
        h = h0.clone()
        c = c0.clone()
        out = torch.empty((T, B, H), dtype=f32, device=dev)
        if T == 0:
            return out, h, c
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib_fn()(x_proj.data_ptr(), w_h.data_ptr(), mask.data_ptr(),
                       hb.data_ptr(), h.data_ptr(), c.data_ptr(),
                       out.data_ptr(), T, B, H, stream)
    if rc != 0:
        raise RuntimeError(f"lstm_recurrence kernel launch failed: CUDA error {rc}")
    lstm_recurrence.launches += 1
    return out, h, c


lstm_recurrence.launches = 0
