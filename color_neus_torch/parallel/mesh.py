"""The process group and a process's place on the ray axis: port of
color_neus_tpu/parallel/mesh.py.

JAX lays a 1-D 'dp' mesh over its devices; the port runs one process a
card, and a process's place on that axis is its rank in the default
torch.distributed group. init joins the group torchrun describes in the
environment; Mesh is what the trainer reads of it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from color_neus_torch import resolve_device

RAY_AXIS = "dp"
_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@dataclass(frozen=True)
class Mesh:
    """This process's place on the ray axis: its rank of `world` ranks, and
    the group's backend."""
    rank: int
    world: int
    backend: str

    @property
    def capturable(self) -> bool:
        """Whether the group's collectives can run inside a captured CUDA
        graph: NCCL's can, gloo's (through the host) cannot."""
        return self.backend == "nccl"


def init(backend: str | None = None, device=None) -> torch.device:
    """Join the default process group from the environment torchrun sets
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and return
    this rank's device: cuda:LOCAL_RANK unless `device` names a card's
    index or the CPU. The backend is NCCL on CUDA and gloo on the CPU
    unless named (gloo also moves CUDA tensors, through the host)."""
    missing = [k for k in _ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"a distributed run reads {', '.join(_ENV)} from the environment "
                           f"(torchrun sets them); missing {', '.join(missing)}")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world,
                            device_id=dev if backend == "nccl" else None)
    return dev


def shutdown() -> None:
    """Leave the default group, if this process joined one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _joined() -> bool:
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    """Ranks in the default group; 1 outside one."""
    return dist.get_world_size() if _joined() else 1


def rank() -> int:
    """This process's rank; 0 outside a group."""
    return dist.get_rank() if _joined() else 0


def is_rank0() -> bool:
    """Rank 0 of the default group, or the only process."""
    return rank() == 0


def make_mesh() -> Mesh:
    """The ray axis over every rank of the default group."""
    if not _joined():
        raise RuntimeError("make_mesh needs the process group: call parallel.init first")
    return Mesh(rank(), world(), dist.get_backend())


def _flag_device() -> torch.device:
    """Where a small collective's tensor lives: NCCL reduces CUDA tensors only."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier() -> None:
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def broadcast_object(obj):
    """Rank 0's `obj` on every rank (a picklable value)."""
    box = [obj]
    dist.broadcast_object_list(box, src=0, device=_flag_device())
    return box[0]


def any_rank(flag: bool) -> bool:
    """Whether `flag` is set on any rank: one all_reduce(MAX), a host read."""
    t = torch.tensor([int(flag)], dtype=torch.int32, device=_flag_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())
