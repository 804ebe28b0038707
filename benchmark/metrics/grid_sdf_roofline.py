"""grid_sdf_roofline: The grid SDF kernel's share of its roofline, in %: the least time of the
SDF value at the points a sparse grid needs (the coarse corners and the
points of the blocks the surface crosses under the reference SDF, counted
by the benchmark: benchmark.scene.surface_blocks) / the device seconds of
the `sdf_rays_*` kernels an extraction.

Layer: grid SDF kernel (ops/kernels/sdf_mlp, csrc/sdf_rays.cu). Unit: %. Moves: extract_s.
Returns None where the trace holds nothing to read.
"""


def read(ctx):
    if ctx.get("kind") != "extract" or not ctx.get("peak"):
        return None
    s = ctx["summary"].seconds_of(lambda n: n.startswith("sdf_rays_")) / ctx["extractions"]
    if s <= 0:
        return None
    c, p = ctx["counts"]["grid"], ctx["peak"]
    return 100.0 * max(c["flops"] / p["flops"], c["bytes"] / p["bytes_per_s"]) / s
