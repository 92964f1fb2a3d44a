"""The ("data", "model") mesh of ranks.

Counterpart of ``rnn_speech_tpu/parallel/mesh.py``: ``data`` shards the
batch rows (one gradient all-reduce a step); ``model`` shards the LSTM
gate matrices' 4H output dimension FSDP-style (``parallel/sharding.py``),
with the batch rows sharded over data x model jointly.  Rank r sits at
(r // model, r % model), so its batch shard is r.

The arithmetic is the JAX package's: ``data=0`` means world // model, and
a mesh larger than the world raises ``ValueError``.  One deliberate
deviation: a mesh smaller than the world raises too, because every rank
runs the same collectives and must belong to the mesh (JAX leaves the
devices outside a smaller mesh idle).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

AXES = ("data", "model")


def mesh_shape(data: int = 0, model: int = 1, world: int = 1) -> Tuple[int, int]:
    """(data, model) over ``world`` ranks; data=0 means "all remaining"."""
    model = max(model, 1)
    if data <= 0:
        data = max(1, world // model)
    need = data * model
    if need > world:
        raise ValueError(
            f"Mesh {data}x{model} needs {need} ranks, have {world}: start one process "
            f"a GPU with python -m torch.distributed.run --nproc_per_node {need} "
            f"-m rnn_speech_tpu_torch.cli ...")
    if need < world:
        raise ValueError(
            f"Mesh {data}x{model} covers {need} of the {world} ranks; every rank must "
            f"belong to the mesh (--mesh_data 0 spans them)")
    return data, model


@dataclass
class Mesh:
    """A ("data", "model") grid of the group's ranks: the
    ``DeviceMesh``, its two axes' groups and this rank's coordinates."""
    device_mesh: Any
    shape: Dict[str, int]
    data_group: Any
    model_group: Any
    coords: Tuple[int, int]

    @property
    def data_size(self) -> int:
        return self.shape["data"]

    @property
    def model_size(self) -> int:
        return self.shape["model"]

    @property
    def batch_shards(self) -> int:
        return self.data_size * self.model_size

    @property
    def shard_index(self) -> int:
        """This rank's batch shard: rows shard over data x model, data major."""
        return self.coords[0] * self.model_size + self.coords[1]


def make_mesh(data: int = 0, model: int = 1) -> Mesh:
    """The (data, model) mesh over the process group's ranks (the group
    must be up: ``launch.init_from_env`` or ``launch.spawn_ranks``).  Its
    ``DeviceMesh`` lives on the collectives' device: cuda under NCCL, cpu
    under gloo (whose groups take CUDA tensors too)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise ValueError("make_mesh needs a process group: start the ranks with "
                         "python -m torch.distributed.run or RST_MULTIHOST")
    data, model = mesh_shape(data, model, dist.get_world_size())
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(device_type, (data, model), mesh_dim_names=AXES)
    coords = tuple(dm.get_coordinate())
    return Mesh(device_mesh=dm, shape={"data": data, "model": model},
                data_group=dm.get_group("data"), model_group=dm.get_group("model"),
                coords=coords)
