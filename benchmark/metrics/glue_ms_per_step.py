"""glue_ms_per_step: Device ms a training step of every device operation that is neither the
march's nor the sweeps': the pixel draw, rays, the hierarchy's merge and
inverse cdf, the loss, the clip and Adam, copies and fills.

Layer: render glue (models/neus, ops/rays, trainer loss, clip, Adam). Unit: ms. Moves: train_rays_per_s.
Returns None where the trace holds nothing to read.
"""


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    s = ctx["summary"].seconds_of(
        lambda n: not (n.startswith(("ray_march_", "point_pipeline_reduce", "sdf_rays_"))))
    return 1e3 * s / ctx["steps"]
