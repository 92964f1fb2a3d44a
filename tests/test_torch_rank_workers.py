"""Rank bodies for the port's multi-rank tests (``spawn_ranks`` targets).

Each function runs in a spawned gloo rank on the CPU and returns plain
numpy/Python results to the test process, which holds them against the
JAX package.  The module imports torch and the port only, never JAX:
every spawned child imports it afresh.  It holds no tests itself.
"""

import contextlib
import dataclasses
import io

import torch

from rnn_speech_tpu_torch import params as tparams
from rnn_speech_tpu_torch.models import acoustic
from rnn_speech_tpu_torch.parallel import lockstep
from rnn_speech_tpu_torch.parallel import mesh as mesh_mod
from rnn_speech_tpu_torch.parallel import sharding
from rnn_speech_tpu_torch.train import optim
from rnn_speech_tpu_torch.train import step

LR = 0.01


def tiny_step_config():
    """The parallel tests' model: 2 layers of 16, 8 features, 6 labels,
    float32, keep probabilities 1 (as ``tests/test_parallel.py``)."""
    return step.StepConfig(
        model=acoustic.AcousticConfig(num_layers=2, hidden_size=16, input_dim=8,
                                      num_labels=6),
        input_keep_prob=1.0, output_keep_prob=1.0)


def _numpy_tree(tree):
    return optim.tree_map(lambda t: t.detach().to(torch.float32).numpy(), tree)


def sharded_step(rank, world, device, data, model, state_np, batch):
    """The sharded step on a (data, model) mesh from the JAX state
    ``state_np`` (numpy, global rows) and the global ``batch``: the
    reduced gradients, one step's parameters and metrics, a second step's
    count, the eval step before and after, and the dispatch bound of
    uneven ranks (rank r's own bound 3r + 1)."""
    cfg = tiny_step_config()
    mesh = mesh_mod.make_mesh(data, model)
    state = tparams.train_state_from_jax(state_np, device=device)
    rows, s = sharding.shard_width(batch["labels"].shape[1], mesh), mesh.shard_index
    state["states"] = [(c[s * rows:(s + 1) * rows], h[s * rows:(s + 1) * rows])
                       for c, h in state["states"]]
    specs = sharding.param_specs(state["params"], model)
    sstate, put_batch, train_fn, eval_fn = sharding.make_sharded_step(mesh, cfg, state)
    dbatch = put_batch({k: v[:, s * rows:(s + 1) * rows] for k, v in batch.items()})
    _, grads, loss, _, norm = sharding.sharded_grads(
        cfg, sstate["params"], specs, mesh, sstate["states"], dbatch,
        torch.Generator().manual_seed(7))
    eval0 = eval_fn(cfg, sstate, dbatch)
    st2, metrics = train_fn(cfg, sstate, dbatch, torch.Generator().manual_seed(7), False)
    st3, _ = train_fn(cfg, st2, dbatch, torch.Generator().manual_seed(8), True)
    eval3 = eval_fn(cfg, st3, dbatch)
    return {
        "shard_index": s, "coords": mesh.coords,
        "grads": _numpy_tree(sharding.gather_params(grads, specs, mesh)),
        "grad_loss": float(loss),
        "params": _numpy_tree(sharding.gather_params(st2["params"], specs, mesh)),
        "param_shapes": [tuple(p.shape) for p in optim.tree_leaves(st2["params"])],
        "metrics": {k: float(v) for k, v in metrics.items()},
        "step": int(st3["step"]),
        "eval0": {k: float(v) for k, v in eval0.items()},
        "eval3": {k: float(v) for k, v in eval3.items()},
        "bound": lockstep.pod_dispatch_bound(3 * rank + 1),
    }


def one_by_one_dropout(rank, world, device, keeps, state_np, batch):
    """On a 1x1 mesh with dropout: the sharded step and the unsharded
    ``train_step`` from generators of one seed (the parameters and metrics
    of each, as numpy)."""
    cfg = dataclasses.replace(tiny_step_config(), input_keep_prob=keeps[0],
                              output_keep_prob=keeps[1])
    mesh = mesh_mod.make_mesh(1, 1)
    out = {}
    state = tparams.train_state_from_jax(state_np, device=device)
    ref, ref_m = step.train_step(cfg, state, {k: torch.as_tensor(v) for k, v in batch.items()},
                                 torch.Generator().manual_seed(11), False)
    sstate, put_batch, train_fn, _ = sharding.make_sharded_step(
        mesh, cfg, tparams.train_state_from_jax(state_np, device=device))
    got, got_m = train_fn(cfg, sstate, put_batch(batch), torch.Generator().manual_seed(11),
                          False)
    for name, (st, m) in (("unsharded", (ref, ref_m)), ("sharded", (got, got_m))):
        out[name] = {"params": _numpy_tree(st["params"]),
                     "metrics": {k: float(v) for k, v in m.items()}}
    return out


def train_loop(rank, world, device, ini, model, max_steps):
    """``loop.train_acoustic`` on the mesh (0, ``model``) over the ini's
    corpora (sorted by name): each step's loss and error, and the sum of
    the absolute values of this rank's final parameters (its shards)."""
    from rnn_speech_tpu_torch import corpus
    from rnn_speech_tpu_torch.charmap import get_char_map
    from rnn_speech_tpu_torch.config import load_config
    from rnn_speech_tpu_torch.train import loop

    config = load_config(ini)
    data = sorted(corpus.DataProcessor(config.training_dataset_dirs).get_dataset())
    test = sorted(corpus.DataProcessor(config.test_dataset_dirs).get_dataset())
    mesh = mesh_mod.make_mesh(0, model) if world > 1 or model > 1 else None
    hooked = []
    state = loop.train_acoustic(
        config, data, test, get_char_map("english"), max_steps=max_steps, mesh=mesh,
        device=device, step_hook=lambda n, m: hooked.append(
            [n, float(m["mean_loss"]), float(m["mean_error_rate"])]))
    return {"steps": hooked,
            "params_sum": float(sum(p.abs().sum() for p in optim.tree_leaves(state["params"])))}


def cli_runs(rank, world, device, runs):
    """``cli.main(argv)`` for each argv of ``runs`` in turn in this rank
    (its group already up): the exit code and what it printed, or the
    exception it raised."""
    from rnn_speech_tpu_torch import cli

    out = []
    for argv in runs:
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                rc = cli.main(argv)
            out.append({"rc": rc, "out": buf.getvalue()})
        except Exception as exc:  # noqa: BLE001 - the test reads it
            out.append({"error": f"{type(exc).__name__}: {exc}"})
    return out


def fail_on_rank_one(rank, world, device):
    """Rank 1 raises; rank 0 waits in a collective that never completes."""
    if rank == 1:
        raise ValueError("planted")
    torch.distributed.barrier()
    return rank
