"""Sharded train and eval steps over a ("data", "model") mesh of ranks.

Counterpart of ``rnn_speech_tpu/parallel/sharding.py``.  Layout:
  * batch rows -> shard over data x model (rank r holds shard r; each
    rank's pipeline builds only its own rows);
  * recurrent state rows -> shard like the batch (each rank keeps its own);
  * parameters and Adam slots -> replicated, except the LSTM gate
    matrices' 4H output dimension (``w_x``, ``w_h``) and their 4H biases,
    which shard over "model" where the size divides.

Pure data parallel (model 1): each rank accumulates the gradients of its
rows (``step.accumulate_grads``, unchanged), then ONE all-reduce over
"data" sums them (the gradient tree flattened into one buffer a dtype),
and every rank applies the same clip + Adam to its replicated parameters.
No ``DistributedDataParallel``: the step already sums gradients
explicitly, and the JAX step does one explicit ``psum``.

Model axis (model > 1, FSDP-style): the sharded leaves and their Adam
slots live sharded at rest; each step all-gathers the weights over
"model", runs the unchanged step on the rank's rows, reduce-scatters the
sharded leaves' gradients back over "model" (the rest all-reduced over
"model"), then the one all-reduce over "data".  The clip's global norm
adds the sharded leaves' squared sums over "model".

Dropout is decorrelated by rank (``shard_generator``), and the metric sums
and counts are all-reduced before dividing, so means are exact however
the padding rows fall.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from rnn_speech_tpu_torch import to_device
from rnn_speech_tpu_torch.train import optim
from rnn_speech_tpu_torch.train import step as step_mod

Tensor = torch.Tensor
_MIX = 0x9E3779B97F4A7C15     # splitmix64's increment
_MASK64 = (1 << 64) - 1


# ------------------------------------------------------------------ specs

def param_spec(keys, shape, model_size: int) -> Optional[int]:
    """The dimension of one parameter (``keys``: its path in the tree) that
    shards over "model", or None when it stays replicated: the last (4H)
    dimension of the LSTM leaves ``w_x``, ``w_h`` and ``b``, where it
    divides by the model size."""
    if model_size <= 1 or "lstm" not in keys:
        return None
    if keys[-1] in ("w_x", "w_h") and shape[-1] % model_size == 0:
        return len(shape) - 1
    if keys[-1] == "b" and len(shape) == 1 and shape[0] % model_size == 0:
        return 0
    return None


def _map_with_path(fn: Callable, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, tree[k], path + (str(k),)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree))
    return fn(path, tree)


def param_specs(params, model_size: int):
    """``param_spec`` of every leaf of a full-shape parameter tree."""
    return _map_with_path(lambda path, leaf: param_spec(path, leaf.shape, model_size),
                          params)


def shard_leaf(x: Tensor, dim: Optional[int], mesh) -> Tensor:
    """This rank's model-axis shard of a full-shape leaf."""
    if dim is None:
        return x
    return x.chunk(mesh.model_size, dim)[mesh.coords[1]].contiguous()


def shard_state(state: step_mod.TrainState, mesh, specs) -> step_mod.TrainState:
    """A state whose parameters and Adam slots are full-shape (the same on
    every rank) -> this rank's shards; its recurrent state (this rank's
    rows), step, learning rate and Adam count unchanged."""
    shard = lambda x, d: shard_leaf(x, d, mesh)
    opt = state["opt"]
    return {**state,
            "params": optim.tree_map(shard, state["params"], specs),
            "opt": {**opt, "m": optim.tree_map(shard, opt["m"], specs),
                    "v": optim.tree_map(shard, opt["v"], specs)}}


# ------------------------------------------------------------ collectives

@contextlib.contextmanager
def _old_names():
    """Quiet the deprecation of ``all_gather_into_tensor`` and
    ``reduce_scatter_tensor`` in newer torch: their successors
    (``*_single``) are missing from the torch 2.11 the card runs."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        yield


def gather_params(params, specs, mesh):
    """All-gather the model-sharded leaves to full shape (FSDP's weight
    gather; every rank of the model group must call it).
    ``all_gather_into_tensor`` concatenates on dim 0, so shards of the last
    dimension are put back with ``cat(..., dim=-1)``."""
    if mesh.model_size <= 1:
        return params

    def gather(x, dim):
        if dim is None:
            return x
        out = torch.empty((mesh.model_size * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        with _old_names():
            dist.all_gather_into_tensor(out, x.contiguous(), group=mesh.model_group)
        return torch.cat(out.chunk(mesh.model_size, 0), dim=dim) if dim else out

    return optim.tree_map(gather, params, specs)


def all_reduce_flat(tensors: List[Tensor], group) -> List[Tensor]:
    """Sum each tensor over ``group`` with one all-reduce a dtype: the
    tensors flattened into one buffer, reduced, and split back."""
    out: List[Optional[Tensor]] = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out


def scatter_grads(grads, specs, mesh):
    """Full-shape gradients of this rank's rows -> the summed gradients of
    the mesh, in the parameters' layout: reduce-scatter of the sharded
    leaves and all-reduce of the rest over "model", then the one all-reduce
    over "data"."""
    leaves, dims = optim.tree_leaves(grads), optim.tree_leaves(specs)
    m = mesh.model_size
    if m > 1:
        rest = [i for i, d in enumerate(dims) if d is None]
        summed = all_reduce_flat([leaves[i] for i in rest], mesh.model_group)
        for i, g in zip(rest, summed):
            leaves[i] = g
        for i, d in enumerate(dims):
            if d is None:
                continue
            g = leaves[i]
            inp = torch.cat(g.chunk(m, d), dim=0).contiguous() if d else g.contiguous()
            out = torch.empty_like(g.chunk(m, d)[0], memory_format=torch.contiguous_format)
            with _old_names():
                dist.reduce_scatter_tensor(out, inp, group=mesh.model_group)
            leaves[i] = out
    if mesh.data_size > 1:
        leaves = all_reduce_flat(leaves, mesh.data_group)   # THE gradient all-reduce
    it = iter(leaves)
    return optim.tree_map(lambda _: next(it), grads)


def sharded_grad_norm(grads, specs, mesh) -> Tensor:
    """The clip's global norm of a model-sharded gradient tree: each
    sharded leaf's squared sum added over "model", each replicated leaf's
    counted once, summed in the tree's leaf order."""
    leaves, dims = optim.tree_leaves(grads), optim.tree_leaves(specs)
    sq = [torch.sum(torch.square(g.to(torch.float32))) for g in leaves]
    sharded = [i for i, d in enumerate(dims) if d is not None]
    if sharded:
        total = torch.stack([sq[i] for i in sharded])
        dist.all_reduce(total, group=mesh.model_group)
        for i, s in zip(sharded, total.unbind()):
            sq[i] = s
    return torch.sqrt(sum(sq))


def shard_generator(rng: torch.Generator, shard_index: int) -> torch.Generator:
    """The dropout generator of batch shard ``shard_index`` (the port's
    ``fold_in``): shard 0 draws from ``rng`` itself, so a 1x1 mesh draws
    exactly the unsharded step's seed words; shard s > 0 draws one 63-bit
    word from ``rng`` and seeds its own generator with it mixed with s."""
    if shard_index == 0:
        return rng
    word = int(torch.randint(0, 2 ** 63 - 1, (1,), generator=rng, dtype=torch.int64))
    z = (word + shard_index * _MIX) & _MASK64                   # splitmix64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return torch.Generator().manual_seed((z ^ (z >> 31)) & (2 ** 63 - 1))


def sharded_grads(scfg, params, specs, mesh, states, batch: Dict[str, Tensor],
                  rng: torch.Generator):
    """The mesh's half of a sharded train step: gather the weights, run the
    unchanged microbatch accumulation on this rank's rows, then reduce the
    gradients over the mesh.  Returns (states, grads, mean_loss,
    mean_error_rate, grad_norm or None when the local norm is exact)."""
    full = gather_params(params, specs, mesh)
    states, grads, loss_sum, err_sum, cnt = step_mod.accumulate_grads(
        scfg, full, states, batch, shard_generator(rng, mesh.shard_index))
    grads = scatter_grads(grads, specs, mesh)
    grad_norm = sharded_grad_norm(grads, specs, mesh) if mesh.model_size > 1 else None
    # Sums and real-microbatch counts summed over every rank before
    # dividing: exact means however the padding rows fall.
    sums = torch.stack([loss_sum, err_sum, cnt])
    dist.all_reduce(sums)
    loss_sum, err_sum, cnt = sums.unbind()
    denom = torch.clamp(cnt, min=1.0)
    return states, grads, loss_sum / denom, err_sum / denom, grad_norm


# ----------------------------------------------------------- construction

def shard_width(width: int, mesh) -> int:
    """The rows of one batch shard of a global batch ``width`` rows wide;
    ``ValueError`` (the JAX package's) when the width does not divide the
    mesh's batch shards."""
    shards = mesh.batch_shards
    if width % shards:
        raise ValueError(
            f"Global batch width {width} must divide evenly across "
            f"the {shards} batch shards of mesh {dict(mesh.shape)} "
            f"(rows shard over data x model); adjust batch_size / "
            f"mini_batch_size or the mesh axes")
    return width // shards


def make_sharded_step(mesh, scfg, state: step_mod.TrainState
                      ) -> Tuple[step_mod.TrainState, Callable, Callable, Callable]:
    """Returns (sharded_state, put_batch, train_fn, eval_fn).

    ``state``'s parameters and Adam slots are full-shape and the same on
    every rank (the same seeds or the same restored checkpoint); its
    recurrent state holds this rank's rows.  ``put_batch(batch)`` moves the
    rank's own rows (what its pipeline built, ``shard_width`` of the global
    batch) from the host to its device.  ``train_fn(scfg, state, batch,
    rng, reset_state)`` and ``eval_fn(scfg, state, batch)`` are
    collectives: every rank calls them in the same order."""
    specs = param_specs(state["params"], mesh.model_size)
    state = shard_state(state, mesh, specs)
    dev = state["lr"].device

    def put_batch(batch):
        return {k: to_device(v, dev) for k, v in batch.items()}

    def train_fn(scfg, state, batch, rng, reset_state):
        states, grads, loss, err, grad_norm = sharded_grads(
            scfg, state["params"], specs, mesh, state["states"], batch, rng)
        return step_mod.apply_grads(scfg, state, states, grads, loss, err, reset_state,
                                    grad_norm=grad_norm)

    def eval_fn(scfg, state, batch):
        full = {**state, "params": gather_params(state["params"], specs, mesh)}
        return step_mod.eval_step(scfg, full, batch, group=dist.group.WORLD)

    return state, put_batch, train_fn, eval_fn
