"""Parameter bridge between the JAX pytree and the port's tensors.

The port keeps the JAX package's parameter structure as plain nested
dictionaries of tensors (``models/acoustic.py`` there):

    {"input":  {"w": (D, H), "b": (H,)},
     "lstm":   [{"w_x": (in, 4H), "w_h": (H, 4H), "b": (4H,)}, ...],
     "output": {"w": (H, V), "b": (V,)}}

with gate columns in (i, g, f, o) order.  Flat keys are the slash-joined
paths the npz bundles use (``lstm/0/w_h``).
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from rnn_speech_tpu_torch import resolve_device


def flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Nested dict/list -> {slash path: leaf}, in the pytree's key order
    (dict keys sorted, list entries by index)."""
    if isinstance(tree, dict):
        out = {}
        for key in sorted(tree):
            out.update(flatten(tree[key], f"{prefix}{key}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for idx, value in enumerate(tree):
            out.update(flatten(value, f"{prefix}{idx}/"))
        return out
    return {prefix[:-1]: tree}


def from_flat(flat: Dict[str, Any], device=None) -> Dict[str, Any]:
    """{slash path: array} -> the nested parameter dict of float32 tensors
    on ``device`` ("lstm/<l>/..." becomes a list ordered by layer)."""
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = torch.as_tensor(
            np.array(value, np.float32), device=device
        )
    if "lstm" in tree:
        layers = tree["lstm"]
        tree["lstm"] = [layers[str(i)] for i in range(len(layers))]
    return tree


def params_from_jax(tree: Any, device=None) -> Dict[str, Any]:
    """The JAX parameter pytree, given as numpy arrays, -> the port's
    tensors (float32, same structure).  ``device`` defaults to cuda."""
    return from_flat(flatten(tree), device=resolve_device(device))


def params_to_jax(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's tensors -> the JAX pytree layout as float32 numpy arrays
    (``jax.tree.map(jnp.asarray, ...)`` makes it a JAX pytree)."""
    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return node.detach().to("cpu", torch.float32).numpy()

    return conv(params)


def load_bundle(path: str, device=None) -> Dict[str, Any]:
    """Load the latest acoustic bundle under ``path`` (a bundle root such as
    ``trained_models/english-syllables`` or its ``acoustic`` directory)
    -> parameter dict on ``device`` (default cuda)."""
    from rnn_speech_tpu_torch.train import checkpoint

    dev = resolve_device(device)
    if os.path.isdir(os.path.join(path, "acoustic")):
        path = os.path.join(path, "acoustic")
    got = checkpoint.restore_flat(path)
    if got is None:
        raise FileNotFoundError(f"No acoustic bundle under {path!r}")
    return from_flat(got[0], device=dev)
