"""Parameter bridge between the JAX pytree and the port's tensors.

The port keeps the JAX package's parameter structure as plain nested
dictionaries of tensors (``models/acoustic.py`` there):

    {"input":  {"w": (D, H), "b": (H,)},
     "lstm":   [{"w_x": (in, 4H), "w_h": (H, 4H), "b": (4H,)}, ...],
     "output": {"w": (H, V), "b": (V,)}}

with gate columns in (i, g, f, o) order.  Flat keys are the slash-joined
paths the npz bundles use (``lstm/0/w_h``).

The whole train state of ``train/step.py`` (params, Adam ``m``/``v``/``t``,
recurrent states, step, learning rate) crosses in both directions as
numpy arrays with ``train_state_from_jax``/``train_state_to_jax``,
bit for bit and dtype for dtype.
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


def _tree_to_torch(tree: Any, device) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to_torch(v, device) for v in tree)
    return torch.as_tensor(np.array(tree), device=device)


def _tree_to_numpy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to_numpy(v) for v in tree)
    return tree.detach().cpu().numpy()


def train_state_from_jax(state: Dict[str, Any], device=None) -> Dict[str, Any]:
    """The JAX package's TrainState, given as numpy arrays (same nesting:
    ``{"params", "opt": {"m", "v", "t"}, "states": [(c, h), ...], "step",
    "lr"}``), -> the port's, every array's dtype and bits kept.
    ``device`` defaults to cuda."""
    return _tree_to_torch(state, resolve_device(device))


def train_state_to_jax(state: Dict[str, Any]) -> Dict[str, Any]:
    """The port's train state -> numpy arrays in the JAX TrainState layout
    (``jax.tree.map(jnp.asarray, ...)`` makes it a JAX pytree)."""
    return _tree_to_numpy(state)


def load_bundle(path: str, device=None, part: str = "acoustic") -> Dict[str, Any]:
    """Load the latest bundle of a model under ``path`` (a bundle root such
    as ``trained_models/english-syllables``, or its ``acoustic`` or
    ``language`` directory) -> parameter dict on ``device`` (default
    cuda).  ``part`` names the model: "acoustic" or "language" (the char
    LM, the same tree: ``input/``, ``lstm/<l>/``, ``output/``)."""
    from rnn_speech_tpu_torch.train import checkpoint

    if part not in ("acoustic", "language"):
        raise ValueError(f"part must be 'acoustic' or 'language', got {part!r}")
    dev = resolve_device(device)
    if os.path.isdir(os.path.join(path, part)):
        path = os.path.join(path, part)
    got = checkpoint.restore_flat(path)
    if got is None:
        raise FileNotFoundError(f"No {part} bundle under {path!r}")
    return from_flat(got[0], device=dev)
