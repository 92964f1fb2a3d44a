"""The fbank frontend's spectrogram stages as one kernel: CUDA kernel,
wrapper and plain version.

Counterpart of ``rnn_speech_tpu/ops/frontend_pallas.py`` (``_fbank_kernel``
through ``fbank_banks_pallas``), which ``DeviceFrontend("fbank",
use_kernel=True)`` runs in place of the matmul path:

    banks[b, t] = 10·log10(eps-floored(mel · |DFT(frame_t · window)|² / n_fft))

for the pre-emphasised, padding-zeroed signal ``pre`` (B, S) float32, frame
t being the L_eff = min(frame_length, n_fft) samples from t·step (rfft's
truncation: the basis rows past n_fft are zero).  ``basis`` is
``DeviceFrontend``'s (frame_length, 2·bins) windowed DFT basis [cos |
-sin], ``mel`` its (bins, n_mels) filterbank.

``fbank_banks_plain`` is the JAX package's matmul path (the default
frontend's): the DFT summed over K shifted (rows, step) views of the
signal, so no (B, T, frame_length) framed copy is built, then power, the
mel product and the log.  ``fbank_banks`` takes it for tensors on the CPU
and launches the kernel (``csrc/fbank.cu``) for tensors on a CUDA device,
or raises; there is no fallback.  ``fbank_banks.launches`` counts the calls
that launched the kernel.  Both compute in full float32 (no TF32).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from rnn_speech_tpu_torch.ops import _build

Tensor = torch.Tensor
EPS = float(np.finfo(np.float64).eps)   # the floor of a bank that is exactly 0
SMEM_LIMIT = 227 * 1024                 # bytes of shared memory a block may use
_RING = 8192                            # floats of the kernel's basis ring


def fbank_banks_plain(pre: Tensor, basis: Tensor, mel: Tensor, step: int, n_frames: int,
                      n_fft: int) -> Tensor:
    """(B, n_frames, n_mels) log-mel banks in plain PyTorch."""
    B = pre.shape[0]
    length = basis.shape[0]
    K = -(-length // step)
    need = (n_frames + K) * step
    if pre.shape[1] < need:
        pre = torch.nn.functional.pad(pre, (0, need - pre.shape[1]))
    view = pre[:, :need].reshape(B, n_frames + K, step)
    spec = None
    for k in range(K):
        hi = min((k + 1) * step, length)
        part = torch.matmul(view[:, k:k + n_frames, :hi - k * step], basis[k * step:hi])
        spec = part if spec is None else spec + part
    bins = n_fft // 2 + 1
    power = (spec[..., :bins] ** 2 + spec[..., bins:] ** 2) / n_fft
    banks = torch.matmul(power, mel)
    banks = torch.where(banks == 0.0, torch.full((), EPS, device=pre.device), banks)
    return 10.0 * torch.log10(banks)


def fbank_banks(pre: Tensor, basis: Tensor, mel: Tensor, step: int, n_frames: int,
                n_fft: int) -> Tensor:
    """(B, n_frames, n_mels) float32 log-mel banks; the kernel on a CUDA
    device, the plain version on the CPU."""
    if not pre.is_cuda:
        return fbank_banks_plain(pre, basis, mel, step, n_frames, n_fft)
    B, n_samples = pre.shape
    bins, n_mels = mel.shape
    l_eff = min(basis.shape[0], n_fft)
    dev = pre.device
    for name, t, shape in (("pre", pre, (B, n_samples)),
                           ("basis", basis, (basis.shape[0], 2 * bins)),
                           ("mel", mel, (n_fft // 2 + 1, n_mels))):
        if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be float32 {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if step % 4:
        raise ValueError(f"the fbank kernel reads frames in 16-byte pieces: step % 4 "
                         f"must be 0, got step={step}")
    if l_eff * 2 * (bins % 64) > _RING:
        raise ValueError(f"{bins % 64} bins past the kernel's 64-bin chunks exceed its ring")
    lib = _build.load("fbank")
    lib.rst_fbank_smem.argtypes = [ctypes.c_int] * 4
    lib.rst_fbank_smem.restype = ctypes.c_longlong
    smem = lib.rst_fbank_smem(step, l_eff, bins, n_mels)
    if smem > SMEM_LIMIT:
        raise ValueError(f"the fbank kernel needs {smem} bytes of shared memory at "
                         f"step={step}, L_eff={l_eff}, {bins} bins")
    out = torch.empty((B, n_frames, n_mels), dtype=torch.float32, device=dev)
    if B == 0 or n_frames == 0:
        return out
    if n_samples == 0:                      # frames of zeros still have banks
        pre = pre.new_zeros((B, 4))
    pre = pre.contiguous()
    with torch.cuda.device(dev):
        fn = lib.rst_fbank
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        rc = fn(pre.data_ptr(), basis.contiguous().data_ptr(), mel.contiguous().data_ptr(),
                out.data_ptr(), B, pre.shape[1], step, l_eff, 2 * bins, bins, n_mels,
                n_frames, n_fft, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fbank kernel launch failed: CUDA error {rc}")
    fbank_banks.launches += 1
    return out


fbank_banks.launches = 0
