"""Process-group bring-up: one process a GPU.

Counterpart of the JAX CLI's multi-host bring-up (``RST_MULTIHOST`` in
``rnn_speech_tpu/cli.py``).  A rank's group starts from its environment
(``init_from_env``):

  * under ``python -m torch.distributed.run`` (``torchrun``): ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``;
  * under ``RST_MULTIHOST=1``: ``RST_COORD_ADDR`` (host:port of rank 0),
    ``RST_NUM_PROCESSES`` and ``RST_PROCESS_ID``; bad values are fatal
    (``SystemExit``), as in the JAX CLI: a process that quietly trained
    alone would train on the whole dataset and overwrite a shared
    checkpoint directory.

The rank's device is ``cuda:LOCAL_RANK``, made current before anything
touches the card, and the backend follows the device: NCCL on CUDA, gloo
on the CPU.  ``spawn_ranks`` starts ``world`` ranks of a function on this
machine (tests, the dry run, the smoke test).
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence, Tuple

COORD_VARS = ("RST_NUM_PROCESSES", "RST_PROCESS_ID")


def backend_for(device) -> str:
    """The collective backend of ``device``'s tensors."""
    import torch

    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def world_and_rank() -> Tuple[int, int]:
    """(world size, rank) of the process group; (1, 0) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _rank_device(device, local_rank: int):
    """The rank's device: ``cuda:local_rank`` for a CUDA ``device`` (made
    current), else ``device`` unchanged."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    dev = torch.device("cuda", local_rank)
    torch.cuda.set_device(dev)
    return dev


def _coordinator_topology() -> Tuple[str, int, int]:
    """(address, world, rank) from ``RST_COORD_ADDR``, ``RST_NUM_PROCESSES``
    and ``RST_PROCESS_ID``; ``SystemExit`` with the JAX CLI's message when
    one is not a non-negative integer."""
    values = {}
    for var in COORD_VARS:
        raw = os.environ.get(var)
        if raw is None or not raw.strip().isdigit():
            raise SystemExit(
                "RST_COORD_ADDR is set, so {0} must be a "
                "non-negative integer (got {1!r}). Explicit "
                "coordinator topology needs all three of "
                "RST_COORD_ADDR, RST_NUM_PROCESSES, RST_PROCESS_ID."
                .format(var, raw))
        values[var] = int(raw)
    world, rank = values["RST_NUM_PROCESSES"], values["RST_PROCESS_ID"]
    if rank >= world:
        raise SystemExit(f"RST_PROCESS_ID {rank} must be below RST_NUM_PROCESSES {world}")
    return os.environ["RST_COORD_ADDR"], world, rank


def init_from_env(device=None):
    """Start this process's group from its environment, if it names one;
    returns (the rank's device, whether this call started the group).

    A group that is already up (a caller started it) is kept.  Without
    ``RST_MULTIHOST`` and without ``WORLD_SIZE`` no group starts and
    ``device`` comes back as it was."""
    import torch
    import torch.distributed as dist

    from rnn_speech_tpu_torch import resolve_device

    dev = resolve_device(device)
    if dist.is_initialized():
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev, False
    if os.environ.get("RST_MULTIHOST") and os.environ.get("RST_COORD_ADDR"):
        addr, world, rank = _coordinator_topology()
        local = int(os.environ.get("LOCAL_RANK", rank % max(torch.cuda.device_count(), 1)))
        init_method = f"tcp://{addr}"
    elif os.environ.get("WORLD_SIZE"):
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        local = int(os.environ.get("LOCAL_RANK", 0))
        init_method = "env://"
    elif os.environ.get("RST_MULTIHOST"):
        raise SystemExit(
            "RST_MULTIHOST=1 needs RST_COORD_ADDR, RST_NUM_PROCESSES and "
            "RST_PROCESS_ID, or the variables python -m torch.distributed.run sets")
    else:
        return dev, False
    dev = _rank_device(dev, local)
    dist.init_process_group(backend_for(dev), init_method=init_method,
                            world_size=world, rank=rank)
    return dev, True


def _rank_main(fn, rank, world, backend, device, init_file, out_path, args):
    """One spawned rank: make its device current, join the group, run
    ``fn(rank, world, device, *args)`` and write its result or traceback."""
    import torch
    import torch.distributed as dist

    status: Tuple[str, Any]
    try:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = _rank_device(dev, rank % torch.cuda.device_count())
        elif dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method="file://" + init_file,
                                world_size=world, rank=rank)
        try:
            status = ("ok", fn(rank, world, dev, *args))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the parent
        status = ("error", traceback.format_exc())
    with open(out_path, "wb") as fh:
        pickle.dump(status, fh)
    if status[0] != "ok":
        raise SystemExit(1)


def spawn_ranks(fn: Callable, world: int, backend: str, device, args: Sequence = (),
                timeout: float = 300.0) -> List[Any]:
    """Run ``fn(rank, world, device, *args)`` in ``world`` spawned processes
    joined in one ``backend`` group; returns the ranks' results in rank order.

    The group meets through a ``file://`` rendezvous in a temporary
    directory (no port to clash).  ``fn`` must be importable by name from a
    module that imports no JAX: each child imports it afresh.  A rank that
    fails fails the call with its traceback, and the other ranks are
    stopped; ranks still running after ``timeout`` seconds are killed and
    the call raises.  ``device`` "cuda" puts rank r on card r % count."""
    import multiprocessing.connection

    import torch.multiprocessing as tmp_mp

    ctx = tmp_mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="rst_ranks_") as tmp:
        init = os.path.join(tmp, "rendezvous")
        outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(world)]
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, backend, str(device), init, outs[r],
                                   tuple(args)))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        failed = False
        while not failed and any(p.is_alive() for p in procs):
            left = deadline - time.monotonic()
            if left <= 0:
                break
            multiprocessing.connection.wait([p.sentinel for p in procs if p.is_alive()],
                                            timeout=min(left, 1.0))
            failed = any(p.exitcode not in (None, 0) for p in procs)
        if failed:      # the others may wait on it in a collective: a short grace
            grace = time.monotonic() + 10.0
            while any(p.is_alive() for p in procs) and time.monotonic() < grace:
                time.sleep(0.1)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        results, errors = [], []
        for r, path in enumerate(outs):
            if not os.path.exists(path):
                errors.append(f"rank {r}: exit code {procs[r].exitcode}, no result"
                              + (" (killed: still running)" if r in hung else ""))
                continue
            with open(path, "rb") as fh:
                kind, value = pickle.load(fh)
            if kind != "ok":
                errors.append(f"rank {r}:\n{value}")
            results.append(value)
        if errors or hung:
            raise RuntimeError(f"{len(errors)} of {world} ranks failed "
                               f"(timeout {timeout} s):\n" + "\n".join(errors))
        return results
