"""The networks of NeuS and Color-NeuS in plain PyTorch, from the leaves
(benchmark.scene.make_leaves' names) and a configuration file's
MODEL.RENDERER, written from the published equations (reference
lib/models/renderers/fields.py): weight norm, softplus(beta = 100), the
skip with 1 / sqrt(2), the x scale / sdf / scale trick, the colour modes,
the relight residual in inverse-sigmoid space. Nothing of the program is
imported.

`quant`, when given, rounds both operands of every product (the control:
the reference in a lower precision); None is plain f32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def pe(x: torch.Tensor, freqs: int) -> torch.Tensor:
    """[x, sin(2^0 x), cos(2^0 x), sin(2^1 x), ...], frequency-major."""
    if freqs <= 0:
        return x
    outs = [x]
    for k in range(freqs):
        outs += [torch.sin(x * 2.0 ** k), torch.cos(x * 2.0 ** k)]
    return torch.cat(outs, dim=-1)


def dense(leaves: dict, name: str):
    """(w [out, in], b [out]) of a layer, weight-normed or plain."""
    if f"{name}.v" in leaves:
        v = leaves[f"{name}.v"]
        w = v * (leaves[f"{name}.g"] / torch.linalg.norm(v, dim=1).clamp_min(1e-12))[:, None]
        return w, leaves[f"{name}.b"]
    return leaves[f"{name}.w"], leaves[f"{name}.b"]


def linear(leaves, name, x, quant=None):
    w, b = dense(leaves, name)
    if quant is not None:
        x, w = quant(x), quant(w)
    return x @ w.T + b


def sdf_net(leaves, r: dict, x, quant=None):
    """x [N, 3] -> [N, d_out], channel 0 the sdf."""
    s = r["SDF"]
    inp = pe(x * s["SCALE"], s["MULTIRES"])
    h = inp
    n_lin = s["N_LAYERS"] + 1
    for l in range(n_lin):
        if l in s["SKIP_IN"]:
            h = torch.cat([h, inp], dim=-1) / math.sqrt(2.0)
        h = linear(leaves, f"renderer.sdf.lin{l}", h, quant)
        if l < n_lin - 1:
            h = F.softplus(h, beta=100)
    return torch.cat([h[:, :1] / s["SCALE"], h[:, 1:]], dim=-1)


def sdf_with_grad(leaves, r, x, quant=None):
    """(sdf [N, 1], features [N, d_out - 1], d sdf / dx [N, 3]), the
    gradient itself differentiable (create_graph)."""
    with torch.enable_grad():
        if not x.requires_grad:
            x = x.detach().requires_grad_(True)
        out = sdf_net(leaves, r, x, quant)
        grad, = torch.autograd.grad(out[:, 0].sum(), x, create_graph=True)
    return out[:, :1], out[:, 1:], grad


def color_net(leaves, r, pts, normals, dirs, feat, quant=None):
    c = r["COLOR"]
    if c["MULTIRES_VIEW"] > 0:
        dirs = pe(dirs, c["MULTIRES_VIEW"])
    mode = c["MODE"]
    if mode == "idr":
        h = torch.cat([pts, dirs, normals, feat], dim=-1)
    elif mode == "no_view_dir":
        h = torch.cat([pts, normals, feat], dim=-1)
    elif mode == "no_normal":
        h = torch.cat([pts, dirs, feat], dim=-1)
    else:
        raise ValueError(f"colour mode {mode}")
    n_lin = c["N_LAYERS"] + 1
    for l in range(n_lin):
        h = linear(leaves, f"renderer.color.lin{l}", h, quant)
        if l < n_lin - 1:
            h = torch.relu(h)
    return torch.sigmoid(h) if c["SQUEEZE_OUT"] else h


def relight_net(leaves, r, rgb, pts, dirs, grads, quant=None):
    """(relit rgb [N, 3], residual [N, 3]) (reference fields.py:289-368)."""
    g = r["RELIGHT"]
    if g["MULTIRES_VIEW"] > 0:
        dirs = pe(dirs, g["MULTIRES_VIEW"])
    feats = [pts, dirs] + ([grads] if g["INCLUDE_GRAD"] else [])
    h = linear(leaves, "renderer.relight.in_layer", torch.cat(feats, dim=-1), quant)
    for i in range(g["N_LAYERS"]):
        h = torch.relu(h)
        if i == g["Y_IN_LAYER"] - 1:
            h = torch.cat([rgb, h], dim=-1)
        h = linear(leaves, f"renderer.relight.mlp{i}", h, quant)
    if g["INV_SIGMOID"]:
        x = rgb.clamp(0.0, 1.0)
        logit = torch.log(x.clamp_min(1e-5) / (1.0 - x).clamp_min(1e-5))
        return torch.sigmoid(logit + h), h
    return (rgb + torch.sigmoid(h) - 0.5).clamp(0.0, 1.0), h


def fp8_quant(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale that maps its
    largest magnitude to 448 (what an fp8 product with a scale per operand
    reads), the gradient passed straight through."""
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = 448.0 / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
    return x + (q - x).detach()
