"""mfu_pct.extract: The whole extraction's share of the chip's bf16 dense peak, in %: the
benchmark's own operations of an extraction (the grid SDF at the points a
sparse grid needs, the vertex colours; drivers/extract.py) x the
extractions traced / the traced window's seconds / the peak. The whole
extraction's share bounds grid_sdf_roofline's where a later change takes
the grid kernel off the path and leaves that share silent.

Layer: extraction (evaluate / TrainLoop.validate_mesh). Unit: %. Moves: extract_s.
Returns None where the trace holds nothing to read.
"""


def read(ctx):
    if ctx.get("kind") != "extract" or not ctx.get("peak"):
        return None
    c = ctx["counts"]
    flops = (c["grid"]["flops"] + c["colors"]["flops"]) * ctx["extractions"]
    return 100.0 * flops / ctx["window_s"] / ctx["peak"]["flops"]
