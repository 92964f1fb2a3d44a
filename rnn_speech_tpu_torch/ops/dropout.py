"""Fused dropout: CUDA kernel, wrapper, plain version, and the dropout site.

Counterpart of ``rnn_speech_tpu/ops/dropout_pallas.py`` (``_dropout_kernel``
through ``dropout_pallas``) and of ``_dropout_site`` in
``rnn_speech_tpu/ops/lstm.py``.  ``dropout(x, seed, keeps)`` computes
x·mask/(∏ keep) in one pass over x for one or two keep probabilities; two
keeps are two independent masks, ANDed (the stacked output + input sites
between two LSTM layers).  Keeps equal to 1 are dropped; with none left,
x itself is returned.  The scale is rounded to x's dtype before the
product, as the TPU kernel rounds it.

The gradient (``_Dropout``) saves only the two seed words: the backward
runs the same kernel on the cotangent, which has x's shape, so it draws
the forward's bits again (``ops/random_bits.py`` states the counter
layout; ``csrc/philox.cuh`` holds the generator).

``bernoulli_mask(seed, shape, keep, dtype)`` (``_mask_kernel`` through
``bernoulli_mask_pallas``) writes a {0, 1} mask that several consumers
share: the wavefront's inter-layer masks on the layered-backward and
materialized-mask training routes.  Its bits are the dropout kernel's
for the first keep on the same flat index.

``dropout_kernel`` and ``bernoulli_mask`` take their plain versions for
the CPU and launch their kernels (``csrc/dropout.cu``) on a CUDA device,
or raise; there is no fallback.  ``<wrapper>.launches`` counts the calls
that launched the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from rnn_speech_tpu_torch.ops import _build, random_bits

Tensor = torch.Tensor
Seed = Tuple[int, int]


def _keeps(keeps: Sequence[float]) -> Tuple[float, ...]:
    out = tuple(float(k) for k in keeps if float(k) < 1.0)
    if len(out) > 2:
        raise ValueError(f"at most two stacked keep probabilities, got {out}")
    for k in out:
        random_bits.threshold(k)          # raises outside (0, 1)
    return out


def _scale(keeps: Tuple[float, ...]) -> float:
    s = 1.0
    for k in keeps:
        s = s / k
    return s


def dropout_plain(x: Tensor, seed: Seed, keeps: Sequence[float]) -> Tensor:
    """x·mask·scale in plain PyTorch, the kernel's bits and roundings."""
    keeps = _keeps(keeps)
    if not keeps:
        return x
    mask = random_bits.dropout_mask(seed, x.shape, keeps, x.device)
    scale = torch.tensor(_scale(keeps), dtype=x.dtype, device=x.device)
    return torch.where(mask, x * scale, torch.zeros((), dtype=x.dtype, device=x.device))


def dropout_kernel(x: Tensor, seed: Seed, keeps: Sequence[float]) -> Tensor:
    """x·mask·scale (no autograd); the kernel on a CUDA device (float32 or
    bf16), the plain version on the CPU."""
    keeps = _keeps(keeps)
    if not keeps:
        return x
    if not x.is_cuda:
        return dropout_plain(x, seed, keeps)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the dropout kernel takes float32 or bfloat16, got {x.dtype}")
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("the dropout kernel needs a 16-byte aligned tensor")
    dev = x.device
    out = torch.empty_like(x)
    scale = float(torch.tensor(_scale(keeps), dtype=x.dtype))
    thr = [random_bits.threshold(k) for k in keeps] + [0]
    with torch.cuda.device(dev):
        fn = _build.load("dropout").rst_dropout
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_float, ctypes.c_int, ctypes.c_uint, ctypes.c_uint,
                       ctypes.c_uint, ctypes.c_uint, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        rc = fn(x.data_ptr(), out.data_ptr(), x.numel(), int(x.dtype == torch.float32),
                scale, len(keeps), seed[0], seed[1], thr[0], thr[1], sms,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dropout kernel launch failed: CUDA error {rc}")
    dropout_kernel.launches += 1
    return out


dropout_kernel.launches = 0


def bernoulli_mask_plain(seed: Seed, shape, keep: float, dtype=torch.bfloat16,
                         device="cpu") -> Tensor:
    """The {0, 1} Bernoulli(keep) mask of ``shape`` in ``dtype``, in plain
    PyTorch: the dropout kernel's bits of its first keep on the flat index
    (``random_bits.dropout_mask``)."""
    return random_bits.dropout_mask(seed, shape, [keep], device).to(dtype)


def bernoulli_mask(seed: Seed, shape, keep: float, dtype=torch.bfloat16,
                   device="cpu") -> Tensor:
    """{0, 1} Bernoulli(keep) mask of ``shape`` (``bernoulli_mask_pallas``):
    the kernel for a CUDA ``device`` (float32 or bf16), the plain version
    on the CPU.  It reads nothing; ``bernoulli_mask.launches`` counts the
    calls that launched the kernel."""
    device = torch.device(device)
    if device.type != "cuda":
        return bernoulli_mask_plain(seed, shape, keep, dtype, device)
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the mask kernel writes float32 or bfloat16, got {dtype}")
    thr = random_bits.threshold(keep)
    out = torch.empty(tuple(int(d) for d in shape), dtype=dtype, device=device)
    with torch.cuda.device(device):
        fn = _build.load("dropout").rst_bernoulli_mask
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint,
                       ctypes.c_uint, ctypes.c_uint, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        rc = fn(out.data_ptr(), out.numel(), int(dtype == torch.float32),
                int(seed[0]) & 0xFFFFFFFF, int(seed[1]) & 0xFFFFFFFF, thr, sms,
                torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mask kernel launch failed: CUDA error {rc}")
    bernoulli_mask.launches += 1
    return out


bernoulli_mask.launches = 0


def boundary_masks(seed: Seed, shape, keep: float, device="cpu") -> Tuple[Tensor, float]:
    """The wavefront's materialized inter-layer dropout from a site's seed
    words: the (L-1, T, B, H) bf16 ``bernoulli_mask`` stream and its
    drop_scale 1/keep (drop mode 1)."""
    masks = bernoulli_mask(tuple(int(w) for w in seed), shape, keep, torch.bfloat16, device)
    return masks, 1.0 / float(keep)


class _Dropout(torch.autograd.Function):
    """Dropout whose backward regenerates the mask from the seed words
    (``_dropout_core`` and its VJP)."""

    @staticmethod
    def forward(ctx, x, seed, keeps):
        ctx.seed, ctx.keeps = seed, keeps
        return dropout_kernel(x, seed, keeps)

    @staticmethod
    def backward(ctx, g):
        return dropout_kernel(g.contiguous(), ctx.seed, ctx.keeps), None, None


def dropout(x: Tensor, seed: Seed, keeps: Sequence[float]) -> Tensor:
    """Differentiable fused dropout; x itself when every keep is 1."""
    keeps = _keeps(keeps)
    if not keeps:
        return x
    return _Dropout.apply(x, tuple(int(s) for s in seed), keeps)


def dropout_site(rng: Optional[torch.Generator], x: Tensor,
                 keeps: Sequence[float]) -> Tensor:
    """One dropout site (``_dropout_site`` on the fused route): one seed
    draw from ``rng`` per site that drops, where JAX splits its key."""
    keeps = _keeps(keeps)
    if rng is None or not keeps:
        return x
    return dropout(x, random_bits.seed_words(rng), keeps)
