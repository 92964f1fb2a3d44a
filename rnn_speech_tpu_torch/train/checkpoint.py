"""Checkpoints: flat-npz parameter bundles + a latest-pointer file.

The port's own copy of ``rnn_speech_tpu/train/checkpoint.py``, in the
same format, so a bundle saved by either package restores in the other: a
single ``.npz`` whose keys are slash-joined parameter paths
(``lstm/0/w_h``, the keys of ``params.flatten``), ``__step__`` and
``__learning_rate__`` beside them, and a ``checkpoint`` JSON pointer naming
the latest bundle.  What persists is the parameters, the step and the
learning rate; not the Adam slots or the recurrent state, so a restart
resumes the schedule and re-warms Adam, as in the JAX package.

Half-precision bundles store bfloat16 as raw uint16 bits and list those
keys under ``__bf16_keys__``.  The bits convert here without
``ml_dtypes``: a bfloat16 is the top half of a float32, so decoding shifts
the 16 bits up into a uint32 and views it as float32 (exact), and encoding
rounds the float32 bits to nearest even, NaN to the quiet NaN of its sign
(``f32_to_bf16_bits``, bit for bit what ``ml_dtypes`` gives).
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


def f32_to_bf16_bits(values: np.ndarray) -> np.ndarray:
    """float32 values -> uint16 bfloat16 bit patterns, rounded to nearest
    even; infinities stay infinite, NaN becomes 0x7FC0 or 0xFFC0 by sign."""
    f = np.ascontiguousarray(values, np.float32)
    bits = f.view(np.uint32)
    rounded = ((bits + np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1))) >> 16)
    quiet_nan = np.where(bits >> 31 == 1, np.uint32(0xFFC0), np.uint32(0x7FC0))
    return np.where(np.isnan(f), quiet_nan, rounded).astype(np.uint16)


def _encode_bf16(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Round float arrays to bfloat16, stored as uint16 bit patterns."""
    out, bf16_keys = {}, []
    for key, value in flat.items():
        if not key.startswith("__") and value.dtype in (np.float32, np.float64):
            out[key] = f32_to_bf16_bits(np.asarray(value, np.float32))
            bf16_keys.append(key)
        else:
            out[key] = value
    if bf16_keys:
        out[BF16_KEYS] = np.asarray(bf16_keys)
    return out


def _decode_bf16(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    keys = flat.pop(BF16_KEYS, None)
    if keys is not None:
        for key in np.asarray(keys).tolist():
            flat[key] = bf16_bits_to_f32(flat[key])
    return flat


def _host_flat(params) -> Dict[str, np.ndarray]:
    """The port's parameter dict -> {slash path: numpy array} on the host."""
    from rnn_speech_tpu_torch import params as params_mod

    return {key: leaf.detach().cpu().numpy()
            for key, leaf in params_mod.flatten(params).items()}


def _write_npz(path: str, flat: Dict[str, np.ndarray]) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **flat)
    os.replace(tmp, path)


def _write_pointer(checkpoint_dir: str, name: str) -> None:
    pointer = os.path.join(checkpoint_dir, POINTER_FILE)
    pointer_tmp = pointer + ".tmp"
    with open(pointer_tmp, "w") as fh:
        json.dump({"latest": name}, fh)
    os.replace(pointer_tmp, pointer)


def save(checkpoint_dir: str, params, step: int, learning_rate: float,
         keep: int = 5, weights_dtype: str = "float32") -> str:
    """Write ``acousticmodel-<step>.npz`` and update the pointer file, each
    through a temporary file and an atomic rename.

    Retains only the ``keep`` highest-step bundles (``keep <= 0`` keeps
    all).  ``weights_dtype="bfloat16"`` halves the bundle; restore upcasts
    into the float32 template."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    flat = _host_flat(params)
    if weights_dtype == "bfloat16":
        flat = _encode_bf16(flat)
    elif weights_dtype != "float32":
        raise ValueError(f"Unsupported weights_dtype {weights_dtype!r}")
    flat["__step__"] = np.asarray(int(step), np.int64)
    flat["__learning_rate__"] = np.asarray(float(learning_rate), np.float64)
    name = f"{PREFIX}-{int(step)}.npz"
    path = os.path.join(checkpoint_dir, name)
    _write_npz(path, flat)
    _write_pointer(checkpoint_dir, name)
    if keep > 0:
        steps = []
        for entry in os.listdir(checkpoint_dir):
            m = re.fullmatch(rf"{PREFIX}-(\d+)\.npz", entry)
            if m:
                steps.append(int(m.group(1)))
        for old_step in sorted(steps)[:-keep]:
            if old_step == int(step):
                continue
            try:
                os.remove(os.path.join(checkpoint_dir, f"{PREFIX}-{old_step}.npz"))
                logger.info("Pruned old checkpoint %s-%d.npz (keeping newest %d)",
                            PREFIX, old_step, keep)
            except OSError:   # concurrent cleanup/readers: best effort
                pass
    logger.info("Checkpoint saved: %s", path)
    return path


def convert_bundle(src_path: str, dst_dir: str, weights_dtype: str = "bfloat16") -> str:
    """Re-encode one bundle file into ``dst_dir`` (same name + pointer);
    a float32 target round-trips a bfloat16 bundle losslessly."""
    with np.load(src_path) as data:
        flat = _decode_bf16({k: data[k] for k in data.files})
    meta = {k: flat.pop(k) for k in ("__step__", "__learning_rate__")}
    if weights_dtype == "bfloat16":
        flat = _encode_bf16(flat)
    elif weights_dtype != "float32":
        raise ValueError(f"Unsupported weights_dtype {weights_dtype!r}")
    flat.update(meta)
    os.makedirs(dst_dir, exist_ok=True)
    name = os.path.basename(src_path)
    dst = os.path.join(dst_dir, name)
    _write_npz(dst, flat)
    _write_pointer(dst_dir, name)
    return dst


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
