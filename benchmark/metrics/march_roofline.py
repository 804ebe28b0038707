"""march_roofline: The march's share of its roofline, in %: the least time of its work
(the larger of counts/march.py's operations over the bf16 dense peak and
its bytes over the HBM bandwidth) / its device seconds a step.

Layer: march kernels (ops/kernels/ray_march). Unit: %. Moves: train_rays_per_s.
Returns None where the trace holds nothing to read.
"""

from benchmark.metrics.march_ms_per_step import is_march


def read(ctx):
    if ctx.get("kind") != "train" or not ctx.get("peak"):
        return None
    s = ctx["summary"].seconds_of(is_march) / ctx["steps"]
    if s <= 0:
        return None
    c, p = ctx["counts"]["march"], ctx["peak"]
    return 100.0 * max(c["flops"] / p["flops"], c["bytes"] / p["bytes_per_s"]) / s

