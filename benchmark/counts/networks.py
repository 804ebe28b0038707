"""The networks' widths, read from a configuration file's MODEL.RENDERER,
and the multiply-adds of their products at those real, unpadded widths.

Every count here is the algorithm's: what a point needs, whatever a
kernel computes twice, pads or stores. A layer is (inputs, outputs).
"""

from __future__ import annotations


def pe_dim(d: int, freqs: int) -> int:
    """Width of the positional encoding [x, sin 2^k x, cos 2^k x ...]."""
    return d * (1 + 2 * freqs) if freqs > 0 else d


def sdf_layers(r: dict) -> list:
    """The SDF net's layers: the layer before a skip gives d_hidden - d0
    outputs, so that the concatenation with the encoded input is
    d_hidden wide."""
    s = r["SDF"]
    d0 = pe_dim(s["D_IN"], s["MULTIRES"])
    dims = [d0] + [s["D_HIDDEN"]] * s["N_LAYERS"] + [s["D_OUT"]]
    skip = set(s["SKIP_IN"])
    out = []
    for i in range(len(dims) - 1):
        d_out = dims[i + 1] - d0 if (i + 1) in skip else dims[i + 1]
        out.append((dims[i], d_out))
    return out


def color_layers(r: dict) -> list:
    c = r["COLOR"]
    d = c["D_IN"] + c["D_FEATURE"]
    if c["MULTIRES_VIEW"] > 0:
        d += pe_dim(3, c["MULTIRES_VIEW"]) - 3
    dims = [d] + [c["D_HIDDEN"]] * c["N_LAYERS"] + [c["D_OUT"]]
    return list(zip(dims[:-1], dims[1:]))


def relight_layers(r: dict) -> list:
    """[] without a relight net (NeuS)."""
    if r.get("TYPE") != "Color_NeuS":
        return []
    g = r["RELIGHT"]
    d_in = g["D_IN"] + (3 if g["INCLUDE_GRAD"] else 0)
    if g["MULTIRES_VIEW"] > 0:
        d_in += pe_dim(3, g["MULTIRES_VIEW"]) - 3
    out = [(d_in, g["D_HIDDEN"])]
    n, y = g["N_LAYERS"], g["Y_IN_LAYER"]
    for i in range(n):
        if i == y - 1:
            out.append((g["D_HIDDEN"] + 3, g["D_OUT"] if y == n else g["D_HIDDEN"]))
        elif i == n - 1:
            out.append((g["D_HIDDEN"], g["D_OUT"]))
        else:
            out.append((g["D_HIDDEN"], g["D_HIDDEN"]))
    return out


def macs(layers) -> int:
    return sum(i * o for i, o in layers)


def sdf_value_macs(r: dict) -> int:
    """One point's SDF value alone: every layer but the last whole, the
    last layer's sdf row only (a placement sweep, a grid point)."""
    layers = sdf_layers(r)
    return macs(layers[:-1]) + layers[-1][0]


def input_cotangent_cols(r: dict) -> tuple:
    """(colour, relight) input columns whose cotangent the backward needs:
    the normal and the SDF features into the colour net (the point and
    the view direction are no functions of a weight), the normal into the
    relight net's first layer."""
    c = r["COLOR"]
    col = 3 + c["D_FEATURE"]
    rel = 3 if relight_layers(r) and r["RELIGHT"]["INCLUDE_GRAD"] else 0
    return col, rel


def point_macs(r: dict) -> dict:
    """Multiply-adds of one training point, by part.

    forward: the SDF net, its input gradient (the reverse sweep: the sdf
      row of the last layer, then every other layer's transposed
      product), the colour and relight nets.
    backward: the colour and relight nets' weight grads and the input
      cotangents that lead to a weight (the first layers only to the
      columns listed by input_cotangent_cols); the SDF net's tangent
      stream (the adjoint of the reverse sweep: a forward pass of the
      gradient's cotangent, sdf row last), one reverse pass carrying both
      streams' cotangents down to layer 1 (layer 0's input is no
      function of a weight), and the weight grads of both uses of each
      SDF weight (the forward's and the reverse sweep's, the last layer's
      sweep use a single row)."""
    sdf = sdf_layers(r)
    col, rel = color_layers(r), relight_layers(r)
    col_cols, rel_cols = input_cotangent_cols(r)
    sweep = macs(sdf[:-1]) + sdf[-1][0]
    fwd = macs(sdf) + sweep + macs(col) + macs(rel)
    col_bwd = macs(col) + col_cols * col[0][1] + macs(col[1:])
    rel_bwd = 0
    if rel:
        rel_bwd = macs(rel) + rel_cols * rel[0][1] + macs(rel[1:])
    sdf_bwd = sweep + (macs(sdf) - sdf[0][0] * sdf[0][1]) + macs(sdf) + sweep
    return {"forward": fwd, "backward": col_bwd + rel_bwd + sdf_bwd,
            "sdf_forward": macs(sdf), "sweep": sweep, "color": macs(col),
            "relight": macs(rel), "sdf_backward": sdf_bwd, "color_backward": col_bwd,
            "relight_backward": rel_bwd}


def weight_count(r: dict) -> int:
    """Scalars of the networks' weights and biases (the weight norm's g
    counted with its row)."""
    layers = sdf_layers(r) + color_layers(r) + relight_layers(r)
    return sum(i * o + o for i, o in layers)
