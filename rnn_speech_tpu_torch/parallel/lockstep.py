"""Lockstep dispatch of a multi-rank evaluation pass.

Counterpart of ``rnn_speech_tpu/parallel/lockstep.py``.  The sharded eval
step all-reduces its metric sums, so every rank must run the same number
of steps.  Ranks' data shards can be uneven, so the count is agreed
before the first step (one ``all_reduce(MAX)`` of each rank's upper bound
on batches: file count / batch size, before skips), an exhausted rank
keeps feeding all-padding batches, and a closing ``all_reduce(MAX)`` of
the real counts drops the trailing steps that were padding on every rank.
A per-batch "anyone still going?" collective would put a blocking host
sync between every dispatch.
"""

from __future__ import annotations

from typing import List, Sequence


def collective_device(group=None):
    """Where a group's host values travel: the current card under NCCL,
    the CPU under gloo."""
    import torch
    import torch.distributed as dist

    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_values(values: Sequence[float], op: str = "sum", group=None,
                      integer: bool = False) -> List:
    """Host numbers reduced over ``group`` by ``op`` ("sum", "max", "min"),
    in float64 (int64 with ``integer``)."""
    import torch
    import torch.distributed as dist

    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}
    t = torch.tensor(list(values), dtype=torch.int64 if integer else torch.float64,
                     device=collective_device(group))
    dist.all_reduce(t, op=ops[op], group=group)
    return t.tolist()


def pod_dispatch_bound(local_bound: int, group=None) -> int:
    """The largest of the ranks' dispatch bounds.  Every rank calls it
    before the first dispatch of the loop it governs."""
    return int(all_reduce_values([local_bound], "max", group, integer=True)[0])
