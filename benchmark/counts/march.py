"""The fused ray march of one training step (forward and backward of the
render core on every sample): operations and bytes.

Operations: 2 x the multiply-adds of counts.networks.point_macs on every
point. Bytes: each input read once and each output written once at f32:
the weights, the rays, the z values and the per-ray outputs, the weight
grads. No stash, no recompute, no padding, no epilogue: every share stays
a lower bound of the work.
"""

from __future__ import annotations

from benchmark.counts import networks

PER_RAY_OUT = 16     # the per-ray loss partials the march returns


def flops(r: dict, n_rays: int, n_points_per_ray: int) -> float:
    m = networks.point_macs(r)
    return 2.0 * n_rays * n_points_per_ray * (m["forward"] + m["backward"])


def bytes_moved(r: dict, n_rays: int, n_points_per_ray: int) -> float:
    w = networks.weight_count(r)
    rays = n_rays * (6 + n_points_per_ray + PER_RAY_OUT)
    return 4.0 * (2 * w + rays)
