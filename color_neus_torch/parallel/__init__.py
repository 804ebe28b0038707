"""Data parallelism: port of color_neus_tpu/parallel/.

The parameters (~1.4M) are replicated and the ray batch is sharded over
the ranks of one torch.distributed group, one process a card (torchrun),
NCCL between cards or gloo on the CPU. Every rank draws the same global
batch, renders its shard, gathers the per-ray loss partials and computes
the same global loss; the gradients are summed across ranks before the
per-leaf clip, so every replica takes the same step.
"""

from color_neus_torch.parallel.mesh import (
    Mesh, any_rank, barrier, broadcast_object, init, is_rank0, make_mesh, rank, shutdown,
    world,
)
from color_neus_torch.parallel.sharding import allreduce_grads, gather_rays, ray_shard, with_mesh
