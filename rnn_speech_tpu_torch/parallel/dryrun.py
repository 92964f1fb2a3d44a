"""A dry run of the mesh layouts.

Counterpart of ``__graft_entry__.dryrun_multichip``: ``dryrun_multichip(n)``
spawns ``n`` ranks, one a card under NCCL (the default; it raises when
there are fewer than ``n`` cards) or, with ``device="cpu"``, ``n`` gloo
ranks on the CPU.  On the (n, 1) and (n/2, 2) meshes each builds the
sharded step at tiny shapes (2 layers of 64, bfloat16, batch 8, 12
frames, 2 microbatches) and runs one train step and one eval step; each
must give a finite loss and leave the step count at 1.

    python -m rnn_speech_tpu_torch.parallel.dryrun [N] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Dict, List

import numpy as np

MB, B, T, D, LABELS, LABEL_WIDTH = 2, 8, 12, 8, 6, 5
HIDDEN = 64             # the smallest width the LSTM kernels take


def tiny_batch(seed: int = 0) -> Dict[str, np.ndarray]:
    """A (MB, B, ...) batch of features and labels from a numpy seed."""
    rng = np.random.default_rng(seed)
    labels = np.full((MB, B, LABEL_WIDTH), -1, np.int32)
    lengths = rng.integers(1, LABEL_WIDTH, (MB, B)).astype(np.int32)
    for m in range(MB):
        for b in range(B):
            labels[m, b, : lengths[m, b]] = rng.integers(0, 4, lengths[m, b])
    return {"features": rng.normal(0, 0.5, (MB, B, T, D)).astype(np.float32),
            "frame_lengths": np.full((MB, B), T, np.int32),
            "labels": labels, "label_lengths": lengths}


def _layouts(n: int):
    return [(n, 1)] + ([(n // 2, 2)] if n % 2 == 0 and n >= 2 else [])


def _rank(rank: int, world: int, device, batch) -> List[dict]:
    import torch

    from rnn_speech_tpu_torch.models import acoustic
    from rnn_speech_tpu_torch.parallel import mesh as mesh_mod
    from rnn_speech_tpu_torch.parallel import sharding
    from rnn_speech_tpu_torch.train import step

    cfg = step.StepConfig(
        model=acoustic.AcousticConfig(num_layers=2, hidden_size=HIDDEN, input_dim=D,
                                      num_labels=LABELS, compute_dtype=torch.bfloat16,
                                      use_kernels=device.type == "cuda"),
        input_keep_prob=1.0, output_keep_prob=1.0)
    out = []
    for data, model in _layouts(world):
        mesh = mesh_mod.make_mesh(data, model)
        rows, s = sharding.shard_width(B, mesh), mesh.shard_index
        state = step.init_train_state(torch.Generator().manual_seed(0), cfg.model,
                                      rows, 0.01, device)
        state, put_batch, train_fn, eval_fn = sharding.make_sharded_step(mesh, cfg, state)
        device_batch = put_batch({k: v[:, s * rows:(s + 1) * rows] for k, v in batch.items()})
        state, metrics = train_fn(cfg, state, device_batch, torch.Generator().manual_seed(7),
                                  False)
        em = eval_fn(cfg, state, device_batch)
        out.append({"mesh": (data, model), "loss": float(metrics["mean_loss"]),
                    "eval_loss": float(em["mean_loss"]), "step": int(state["step"])})
    return out


def dryrun_multichip(n: int = 4, device=None, timeout: float = 240.0) -> List[dict]:
    """Run both layouts on ``n`` ranks on ``device`` (default cuda: NCCL,
    one rank a card; "cpu": gloo); returns rank 0's records and raises if
    any loss is not finite or a step count is not 1."""
    import torch

    from rnn_speech_tpu_torch import resolve_device
    from rnn_speech_tpu_torch.parallel import launch

    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n:
        raise ValueError(f"a dry run of {n} ranks on cuda needs {n} cards, have "
                         f"{torch.cuda.device_count()}; pass device='cpu' for gloo ranks")
    per_rank = launch.spawn_ranks(_rank, n, launch.backend_for(dev), dev.type,
                                  args=(tiny_batch(),), timeout=timeout)
    for records in per_rank:
        for rec in records:
            if not (np.isfinite(rec["loss"]) and np.isfinite(rec["eval_loss"])
                    and rec["step"] == 1):
                raise RuntimeError(f"dry run failed on mesh {rec['mesh']}: {rec}")
    if any(r != per_rank[0] for r in per_rank[1:]):
        raise RuntimeError(f"ranks disagree: {per_rank}")
    return per_rank[0]


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n", type=int, nargs="?", default=4, help="ranks (default 4)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="cuda: one NCCL rank a card (default); cpu: gloo ranks")
    args = parser.parse_args()
    print(dryrun_multichip(args.n, args.device))
