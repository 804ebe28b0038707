"""Ray-axis sharding of the training step: port of
color_neus_tpu/parallel/sharding.py.

JAX constrains the sampled rays to the ray axis and lets XLA partition
the per-ray work and psum the gradient of the global loss. The port does
the same by hand: every rank draws the same global batch and keeps its
rows (ray_shard), renders them, gathers the per-ray loss partials
(gather_rays) and computes the same global loss from them; the gathered
tensor's backward hands each rank the gradient of its own rows, so each
rank's parameter gradients are its shard's share of the global loss's,
and allreduce_grads sums them.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch import nn


def ray_shard(x, rank: int, world: int):
    """Rows [rank R / world, (rank + 1) R / world) of a [R, ...] tensor
    (None passes through); raises when R is not a multiple of world."""
    if x is None:
        return None
    n = x.shape[0]
    if n % world:
        raise ValueError(f"{n} rays do not split evenly over {world} ranks")
    k = n // world
    return x[rank * k:(rank + 1) * k]


def with_mesh(cfg, mesh):
    """A copy of a TrainerConfig with its ray axis set; raises when
    cfg.n_rays is not a multiple of the ranks (make_sharded_train_step's
    check)."""
    if mesh is not None and cfg.n_rays % mesh.world:
        raise ValueError(f"n_rays={cfg.n_rays} not divisible by {mesh.world} ranks")
    return dataclasses.replace(cfg, mesh=mesh)


class _GatherRays(torch.autograd.Function):
    """Forward: every rank's [n, ...] rows stacked in rank order, on every
    rank. Backward: the rows of this rank's input only. Every rank computes
    the same global loss from the gathered tensor, so summing the incoming
    gradient across ranks (as torch.distributed.nn.functional.all_gather's
    backward does) would scale each shard's gradient by the world size."""

    @staticmethod
    def forward(ctx, x, rank, world):
        n = x.shape[0]
        ctx.rows = slice(rank * n, (rank + 1) * n)
        # gloo moves CUDA tensors by all_reduce and broadcast only, so the
        # gather is a sum of each rank's rows in an otherwise zero buffer:
        # exact, x + 0 = x
        out = x.new_zeros((world * n, *x.shape[1:]))
        out[ctx.rows] = x
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rows], None, None


def gather_rays(x: torch.Tensor, mesh) -> torch.Tensor:
    """Each rank's rows of x along the ray axis, in rank order, on every
    rank, with the gradient of this rank's rows in the backward; x itself
    without a mesh."""
    if mesh is None:
        return x
    return _GatherRays.apply(x, mesh.rank, mesh.world)


@torch.no_grad()
def allreduce_grads(params: nn.Module) -> None:
    """Sum every trainable leaf's .grad across ranks with one all_reduce of
    a flat buffer. A leaf without a gradient counts as zeros and receives
    the sum, so every rank's optimizer sees the same leaves; a leaf no rank
    gave a gradient (a frozen camera) receives zeros, and a zero gradient
    from zero moments moves no optimizer's parameter."""
    leaves = [p for p in params.parameters() if p.requires_grad]
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in leaves])
    dist.all_reduce(flat)
    for p, g in zip(leaves, flat.split([p.numel() for p in leaves])):
        p.grad = g.view_as(p)
