"""Checkpoint restore: flat-npz parameter bundles + a latest-pointer file.

The restore half of ``rnn_speech_tpu/train/checkpoint.py``, in the same
format, so a bundle saved by the JAX package restores here: a single
``.npz`` whose keys are slash-joined parameter paths (``lstm/0/w_h``),
``__step__`` and ``__learning_rate__`` beside them, and a ``checkpoint``
JSON pointer naming the latest bundle.  Saving comes with the port's
checkpoint slice.

Half-precision bundles store bfloat16 as raw uint16 bits and list those
keys under ``__bf16_keys__``.  The bits decode here without ``ml_dtypes``:
a bfloat16 is the top half of a float32, so shifting the 16 bits up into a
uint32 and viewing it as float32 is exact.
"""

from __future__ import annotations

import json
import logging
import os
import re
from typing import Dict, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

POINTER_FILE = "checkpoint"
PREFIX = "acousticmodel"
BF16_KEYS = "__bf16_keys__"


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """uint16 bfloat16 bit patterns -> the exactly equal float32 values."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(np.float32)


def _decode_bf16(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    keys = flat.pop(BF16_KEYS, None)
    if keys is not None:
        for key in np.asarray(keys).tolist():
            flat[key] = bf16_bits_to_f32(flat[key])
    return flat


def latest_path(checkpoint_dir: str) -> Optional[str]:
    """The bundle the pointer names, else the highest-step bundle, else
    None (a corrupt pointer falls through to the directory scan)."""
    pointer = os.path.join(checkpoint_dir, POINTER_FILE)
    if os.path.exists(pointer):
        try:
            with open(pointer) as fh:
                name = json.load(fh).get("latest")
        except (json.JSONDecodeError, OSError):
            name = None
        if name:
            path = os.path.join(checkpoint_dir, name)
            if os.path.exists(path):
                return path
    if not os.path.isdir(checkpoint_dir):
        return None
    best, best_step = None, -1
    for entry in os.listdir(checkpoint_dir):
        m = re.fullmatch(rf"{PREFIX}-(\d+)\.npz", entry)
        if m and int(m.group(1)) > best_step:
            best, best_step = entry, int(m.group(1))
    return os.path.join(checkpoint_dir, best) if best else None


def restore_flat(
    checkpoint_dir: str,
) -> Optional[Tuple[Dict[str, np.ndarray], int, float]]:
    """Load the latest bundle -> (flat {path: float32 array}, step, lr), or
    None when the directory holds no bundle."""
    path = latest_path(checkpoint_dir)
    if path is None:
        logger.info("No checkpoint under %s.", checkpoint_dir)
        return None
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    flat = _decode_bf16(flat)
    step = int(flat.pop("__step__"))
    lr = float(flat.pop("__learning_rate__"))
    flat = {k: np.asarray(v, np.float32) for k, v in flat.items()}
    logger.info("Restored model parameters from %s (global_step %d)", path, step)
    return flat, step, lr


def restore(checkpoint_dir: str, params_template):
    """Load the latest bundle into the structure, dtype and device of
    ``params_template`` (the port's parameter dict) -> (params, step, lr),
    or None.  Raises on a missing key or a shape mismatch."""
    from rnn_speech_tpu_torch import params as params_mod

    got = restore_flat(checkpoint_dir)
    if got is None:
        return None
    flat, step, lr = got
    template = params_mod.flatten(params_template)
    out = {}
    for key, leaf in template.items():
        if key not in flat:
            raise KeyError(f"Checkpoint missing parameter {key!r}")
        value = flat[key]
        if tuple(value.shape) != tuple(leaf.shape):
            raise ValueError(
                f"Checkpoint shape mismatch for {key!r}: "
                f"{value.shape} vs model {tuple(leaf.shape)}"
            )
        out[key] = value
    params = params_mod.from_flat(out, device=next(iter(template.values())).device)
    return params, step, lr
