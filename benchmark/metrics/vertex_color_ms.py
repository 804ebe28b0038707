"""vertex_color_ms: Device ms an extraction of the vertex colours' point-pipeline forward
kernel (`point_pipeline_fwd_kernel*`).

Layer: vertex colours (ops/mesh.extract_vertex_colors, point pipeline). Unit: ms. Moves: extract_s.
Returns None where the trace holds nothing to read.
"""


def read(ctx):
    if ctx.get("kind") != "extract":
        return None
    s = ctx["summary"].seconds_of(lambda n: n.startswith("point_pipeline_fwd_kernel"))
    return 1e3 * s / ctx["extractions"] if s > 0 else None
