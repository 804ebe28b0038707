"""sweep_roofline: The hierarchy's placement sweeps' share of their roofline, in %: the
least time of counts/sweep.py's work / the device seconds a step of the
`sdf_rays_*` kernels.

Layer: sweep kernel (ops/kernels/sdf_rays). Unit: %. Moves: train_rays_per_s.
Returns None where the trace holds nothing to read.
"""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx.get("peak"):
        return None
    s = ctx["summary"].seconds_of(lambda n: n.startswith("sdf_rays_")) / ctx["steps"]
    if s <= 0:
        return None
    c, p = ctx["counts"]["sweep"], ctx["peak"]
    return 100.0 * max(c["flops"] / p["flops"], c["bytes"] / p["bytes_per_s"]) / s
