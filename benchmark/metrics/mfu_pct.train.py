"""mfu_pct.train: The whole training step's share of the chip's bf16 dense peak, in %:
the benchmark's own operations of a step (the march's and the sweeps'
products at the configuration's widths, counts/) x the steps traced /
the traced window's seconds / the peak.

Layer: step (models/trainer). Unit: %. Moves: train_rays_per_s.
Returns None where the trace holds nothing to read.
"""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx.get("peak"):
        return None
    c = ctx["counts"]
    flops = (c["march"]["flops"] + c["sweep"]["flops"]) * ctx["steps"]
    return 100.0 * flops / ctx["window_s"] / ctx["peak"]["flops"]
