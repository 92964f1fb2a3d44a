"""PyTorch port of ``rnn_speech_tpu`` for NVIDIA Hopper GPUs.

The package mirrors the JAX package's layout and names, so each module
here has a counterpart there.  It imports ``torch`` and never ``jax``,
and keeps its own copies of the host-only code it needs.

Every entry point runs on a CUDA device unless the caller asks for the
CPU with ``device="cpu"``; without a GPU and without that request it
raises instead of running quietly on the CPU.  The hand-written CUDA
kernels (``csrc/``) are built at first use by ``ops/_build.py``.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless ``device`` says
    otherwise.  Raises when CUDA is asked for (or implied) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"Unsupported device {device!r}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "rnn_speech_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' (or --device cpu) to run the "
            "plain PyTorch path on the CPU"
        )
    return dev
