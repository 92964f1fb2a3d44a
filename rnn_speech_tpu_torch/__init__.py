"""PyTorch port of ``rnn_speech_tpu`` for NVIDIA Hopper GPUs.

The package mirrors the JAX package's layout and names, so each module
here has a counterpart there.  It imports ``torch`` and never ``jax``,
and keeps its own copies of the host-only code it needs.

Every entry point runs on a CUDA device unless the caller asks for the
CPU with ``device="cpu"``; without a GPU and without that request it
raises instead of running quietly on the CPU.  The hand-written CUDA
kernels (``csrc/``) are built at first use by ``ops/_build.py``.
The package itself imports ``torch`` only when a device is resolved, so
the host-only modules (audio IO, corpus readers, the input pipeline's
decode workers) start without it.
"""

from __future__ import annotations

__all__ = ["resolve_device", "to_device"]


def resolve_device(device=None):
    """The ``torch.device`` an entry point runs on: ``cuda`` unless
    ``device`` says otherwise.  Raises when CUDA is asked for (or implied)
    and absent."""
    import torch

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


def to_device(array, dev):
    """A host array on ``dev``: on CUDA through pinned memory without
    blocking the host, so the work already queued keeps running."""
    import numpy as np
    import torch

    t = torch.from_numpy(np.ascontiguousarray(array))
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)
