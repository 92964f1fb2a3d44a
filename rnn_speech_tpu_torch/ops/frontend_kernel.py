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
-sin], ``mel`` its (bins, n_mels) filterbank.  The kernel computes the same
function as a real FFT of n_fft = 512 points with the window (column 0 of
the basis: cos 0 = 1) and sums each mel filter over its non-zero bins
only; its host tables (``kernel_tables``: ``fft_tables``, ``mel_ranges``,
``fft_window``) are computed here in float64 and rounded to float32.

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
FFT_SIZE = 512                          # the kernel's n_fft (the fbank frontend's)


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


def fft_tables(n_fft: int = FFT_SIZE):
    """The kernel's FFT tables for a real FFT of n_fft points as an n_fft/2
    point complex FFT in radix-4 Stockham passes: ``twiddles`` (passes, in
    order, of p < n/4 for n = n_fft/2, n/4, ..., 4; each (w, w², w³), w =
    e^(-2πip/n)) as a (Σ n/4, 3) complex64 array, and ``split`` (n_fft/2 +
    1,) complex64, e^(-2πik/n_fft).  Computed in float64, rounded once."""
    half = n_fft // 2
    rows, n = [], half
    while n > 1:
        w = np.exp(-2j * np.pi * np.arange(n // 4) / n)
        rows.append(np.stack([w, w ** 2, w ** 3], axis=1))
        n //= 4
    split = np.exp(-2j * np.pi * np.arange(half + 1) / n_fft)
    return np.concatenate(rows).astype(np.complex64), split.astype(np.complex64)


def mel_ranges(mel: np.ndarray):
    """(lo, hi) int32 (n_mels,): filter m's non-zero bins of the (bins,
    n_mels) matrix lie in [lo[m], hi[m]) (lo = hi for a filter of zeros)."""
    nz = np.asarray(mel) != 0
    any_nz = nz.any(axis=0)
    lo = np.where(any_nz, nz.argmax(axis=0), 0)
    hi = np.where(any_nz, nz.shape[0] - nz[::-1].argmax(axis=0), 0)
    return lo.astype(np.int32), hi.astype(np.int32)


def fft_window(basis: Tensor, n_fft: int) -> Tensor:
    """The analysis window of a windowed DFT basis (column 0: cos 0 = 1) on
    its first L_eff = min(rows, n_fft) samples, zero-padded to n_fft."""
    l_eff = min(basis.shape[0], n_fft)
    return torch.nn.functional.pad(basis[:l_eff, 0], (0, n_fft - l_eff)).contiguous()


def kernel_tables(basis: Tensor, mel: Tensor, n_fft: int):
    """The kernel's tables for this basis and mel matrix, on their device:
    (window, twiddles, split, mel lo, mel hi).  ``DeviceFrontend`` builds
    them once; ``fbank_banks`` builds them per call when given none."""
    dev = basis.device
    tw, split = fft_tables(n_fft)
    lo, hi = mel_ranges(mel.detach().cpu().numpy())
    as_f32 = lambda c: torch.from_numpy(c.view(np.float32).copy()).to(dev)
    return (fft_window(basis, n_fft), as_f32(tw), as_f32(split), torch.from_numpy(lo).to(dev),
            torch.from_numpy(hi).to(dev))


def fbank_banks(pre: Tensor, basis: Tensor, mel: Tensor, step: int, n_frames: int,
                n_fft: int, tables=None) -> Tensor:
    """(B, n_frames, n_mels) float32 log-mel banks; the kernel on a CUDA
    device, the plain version on the CPU.  The kernel reads only the
    basis's window (column 0), so the basis must be a windowed n_fft-point
    DFT as ``DeviceFrontend``'s; ``tables`` are ``kernel_tables``' for this
    basis and mel matrix (built here when None)."""
    if not pre.is_cuda:
        return fbank_banks_plain(pre, basis, mel, step, n_frames, n_fft)
    B, n_samples = pre.shape
    bins, n_mels = mel.shape
    dev = pre.device
    for name, t, shape in (("pre", pre, (B, n_samples)),
                           ("basis", basis, (basis.shape[0], 2 * bins)),
                           ("mel", mel, (n_fft // 2 + 1, n_mels))):
        if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be float32 {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if n_fft != FFT_SIZE:
        raise ValueError(f"the fbank kernel runs a {FFT_SIZE}-point FFT, got n_fft={n_fft}")
    if step % 4:
        raise ValueError(f"the fbank kernel reads frames in 16-byte pieces: step % 4 "
                         f"must be 0, got step={step}")
    lib = _build.load("fbank")
    lib.rst_fbank_smem.argtypes = [ctypes.c_int]
    lib.rst_fbank_smem.restype = ctypes.c_longlong
    smem = lib.rst_fbank_smem(step)
    if smem > SMEM_LIMIT:
        raise ValueError(f"the fbank kernel needs {smem} bytes of shared memory at "
                         f"step={step}")
    out = torch.empty((B, n_frames, n_mels), dtype=torch.float32, device=dev)
    if B == 0 or n_frames == 0:
        return out
    if n_samples == 0:                      # frames of zeros still have banks
        pre = pre.new_zeros((B, 4))
    pre = pre.contiguous()
    with torch.cuda.device(dev):
        window, tw, split, lo, hi = tables or kernel_tables(basis, mel, n_fft)
        mel = mel.contiguous()
        fn = lib.rst_fbank
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        rc = fn(pre.data_ptr(), window.data_ptr(), tw.data_ptr(), split.data_ptr(),
                mel.data_ptr(), lo.data_ptr(), hi.data_ptr(), out.data_ptr(), B, pre.shape[1],
                step, n_mels, n_frames, _build.launch_stream(dev))
    if rc != 0:
        raise RuntimeError(f"fbank kernel launch failed: CUDA error {rc}")
    fbank_banks.launches += 1
    return out


fbank_banks.launches = 0
