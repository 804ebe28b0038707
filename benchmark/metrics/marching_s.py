"""marching_s: Host seconds of the marching a traced extraction: the program's own span
`stats["march_s"]` of ops/mesh.extract_geometry_sparse, averaged.

Layer: marching (ops/mesh, ops/marching_cubes, host). Unit: s. Moves: extract_s.
Returns None where the trace holds nothing to read.
"""


def read(ctx):
    if ctx.get("kind") != "extract":
        return None
    xs = [s["march_s"] for s in ctx["stats"] if "march_s" in s]
    return sum(xs) / len(xs) if xs else None
