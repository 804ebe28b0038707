"""march_ms_per_step: Device ms a training step of the fused march: every `ray_march_*`
kernel of whichever entries run, forward and backward, and the
`point_pipeline_reduce` kernel that sums the backward's weight-grad
partials.

Layer: march kernels (ops/kernels/ray_march). Unit: ms. Moves: train_rays_per_s.
Returns None where the trace holds nothing to read.
"""


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    s = ctx["summary"].seconds_of(is_march)
    return 1e3 * s / ctx["steps"] if s > 0 else None


def is_march(name: str) -> bool:
    return name.startswith("ray_march_") or name.startswith("point_pipeline_reduce")
