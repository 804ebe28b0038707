"""The inputs a cell hands to the program and to the reference alike, made
on the device from --seed: the scene (cameras, images and masks at the
traffic file's scale) and the networks' first weights.

The scene: `views` cameras on rings above a seeded sphere, looking at the
centre of the unit sphere, each image the sphere rendered analytically
(a smooth colour field, Lambertian shading under a seeded light) over a
smooth background, the mask its silhouette. Every seed gives the same
sizes; only the values move.

The weights: the SDF net's geometric init (reference fields.py:52-70)
and torch's default uniform init of the colour and relight nets, each
weight-normed layer's g its rows' norms, drawn in one call per
distribution; the focal coefficients of the scene's intrinsics and the
identity pose delta. Names are the program's parameter names
(`renderer.sdf.lin0.v`), the tree the JAX package's params mirror.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.counts import networks
from benchmark.reference import nets

CAM_RADIUS = 2.6       # DTU's cameras sit ~2.5 radii of the object sphere away


def _rot_look_at(pos: torch.Tensor) -> torch.Tensor:
    """c2w rotations [n, 3, 3] (columns x right, y down, z forward) of
    cameras at pos [n, 3] looking at the origin."""
    z = -pos / torch.linalg.norm(pos, dim=-1, keepdim=True)
    up = torch.tensor([0.0, 0.0, 1.0], device=pos.device).expand_as(z)
    x = torch.linalg.cross(z, up)
    x = x / torch.linalg.norm(x, dim=-1, keepdim=True)
    y = torch.linalg.cross(z, x)
    return torch.stack([x, y, z], dim=-1)


def camera_poses(n: int, g: torch.Generator, device) -> torch.Tensor:
    """c2w [n, 4, 4] on seven rings from 15 to 65 degrees of elevation,
    azimuths jittered by the seed."""
    rings = 7
    k = torch.arange(n, device=device, dtype=torch.float32)
    ring = torch.remainder(k, rings)
    elev = torch.deg2rad(15.0 + ring * (50.0 / (rings - 1)))
    jitter = torch.rand(n, generator=g, device=device) - 0.5
    azim = 2 * math.pi * (k + 0.5 * jitter) / n
    pos = CAM_RADIUS * torch.stack([torch.cos(elev) * torch.cos(azim),
                                    torch.cos(elev) * torch.sin(azim), torch.sin(elev)], -1)
    c2w = torch.eye(4, device=device).repeat(n, 1, 1)
    c2w[:, :3, :3] = _rot_look_at(pos)
    c2w[:, :3, 3] = pos
    return c2w


@torch.no_grad()
def render_views(c2w: torch.Tensor, focal, H: int, W: int, g: torch.Generator):
    """(images [n, H, W, 3], masks [n, H, W]) in f32 of the seeded sphere."""
    dev = c2w.device
    p = torch.rand(10, generator=g, device=dev)
    centre = (p[:3] - 0.5) * 0.1
    radius = 0.5 + 0.1 * p[3]
    phase = p[4:7] * 2 * math.pi
    light = torch.stack([p[7] - 0.5, p[8] - 0.5, torch.ones((), device=dev)])
    light = light / torch.linalg.norm(light)
    ys, xs = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                            torch.arange(W, device=dev, dtype=torch.float32), indexing="ij")
    dirs = torch.stack([(xs - 0.5 * W) / focal[0], (ys - 0.5 * H) / focal[1],
                        torch.ones_like(xs)], dim=-1)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    images = torch.empty((c2w.shape[0], H, W, 3), device=dev)
    masks = torch.empty((c2w.shape[0], H, W), device=dev)
    for i in range(c2w.shape[0]):
        rd = dirs @ c2w[i, :3, :3].T
        oc = c2w[i, :3, 3] - centre
        b = torch.sum(rd * oc, dim=-1)
        disc = b * b - (torch.dot(oc, oc) - radius * radius)
        hit = disc > 0
        t = -b - torch.sqrt(torch.clamp_min(disc, 0.0))
        pts = c2w[i, :3, 3] + t[..., None] * rd
        nrm = (pts - centre) / radius
        albedo = 0.5 + 0.4 * torch.sin(4.0 * pts + phase)
        shade = 0.25 + 0.75 * torch.clamp_min(torch.sum(nrm * light, dim=-1), 0.0)
        back = 0.3 + 0.2 * torch.sin(3.0 * rd + phase.flip(0))
        images[i] = torch.where(hit[..., None], albedo * shade[..., None], back)
        masks[i] = hit.to(torch.float32)
    return images, masks


def make_scene(spec: dict, seed: int, device):
    """{c2w, focal (fx, fy), H, W, images, masks} of a traffic file's
    `scene` block from the seed."""
    g = torch.Generator(device=device).manual_seed(_seed63(seed, 1))
    H, W, n = spec["height"], spec["width"], spec["views"]
    focal = tuple(float(f) for f in spec["focal"])
    c2w = camera_poses(n, g, device)
    images, masks = render_views(c2w, focal, H, W, g)
    return {"c2w": c2w, "focal": focal, "H": H, "W": W, "images": images, "masks": masks}


def _seed63(seed: int, stream: int) -> int:
    """A 63-bit seed of one stream of --seed (any whole number)."""
    return (int(seed) * 1_000_003 + stream * 0x9E3779B97F4A7C15) % (1 << 63)


def step_seed(seed: int) -> int:
    """The seed of the training steps' generator (pixels, perturbation)."""
    return _seed63(seed, 3)


def make_leaves(r: dict, H: int, W: int, focal, n_views: int, seed: int, device) -> dict:
    """{program parameter name: f32 tensor} of the first weights: the
    renderer's and the cameras' (focal coefficients, identity pose)."""
    out = renderer_leaves(r, seed, device)
    # focal order 2: the coefficients sqrt(f / dim), rounded to f32
    out["focal.fx"] = torch.tensor(math.sqrt(focal[0] / W), dtype=torch.float32, device=device)
    out["focal.fy"] = torch.tensor(math.sqrt(focal[1] / H), dtype=torch.float32, device=device)
    out["pose.r"] = torch.tensor([[1.0, 0, 0, 0, 1, 0]], device=device).repeat(n_views, 1)
    out["pose.t"] = torch.zeros((n_views, 3), device=device)
    return out


def renderer_leaves(r: dict, seed: int, device) -> dict:
    """The renderer's first weights (`renderer.*` names)."""
    g = torch.Generator(device=device).manual_seed(_seed63(seed, 2))
    sdf = networks.sdf_layers(r)
    s = r["SDF"]
    d0 = sdf[0][0]
    normal = torch.randn(sum(i * o for i, o in sdf), generator=g, device=device)
    col, rel = networks.color_layers(r), networks.relight_layers(r)
    uni = torch.rand(sum(i * o + o for i, o in col + rel), generator=g, device=device) * 2 - 1
    out = {}
    pos = 0
    n_lin = len(sdf)
    for l, (d_in, d_out) in enumerate(sdf):
        z = normal[pos:pos + d_in * d_out].reshape(d_out, d_in)
        pos += d_in * d_out
        b = torch.zeros(d_out, device=device)
        if l == n_lin - 1:
            mean = math.sqrt(math.pi) / math.sqrt(d_in)
            w = mean + 1e-4 * z
            b.fill_(-s["BIAS"])
            if s["INSIDE_OUTSIDE"]:
                w, b = -w + 2e-4 * z, -b
        else:
            w = math.sqrt(2) / math.sqrt(d_out) * z
            if l == 0:
                w[:, 3:] = 0.0
            elif l in s["SKIP_IN"]:
                w[:, -(d0 - 3):] = 0.0
        _weight_norm(out, f"renderer.sdf.lin{l}", w, b)
    pos = 0
    for prefix, layers, names, wn in (
            ("renderer.color", col, [f"lin{i}" for i in range(len(col))],
             r["COLOR"]["WEIGHT_NORM"]),
            ("renderer.relight", rel, ["in_layer"] + [f"mlp{i}" for i in range(len(rel) - 1)],
             False)):
        for name, (d_in, d_out) in zip(names, layers):
            bound = 1.0 / math.sqrt(d_in)
            w = bound * uni[pos:pos + d_in * d_out].reshape(d_out, d_in)
            pos += d_in * d_out
            b = bound * uni[pos:pos + d_out].clone()
            pos += d_out
            if wn:
                _weight_norm(out, f"{prefix}.{name}", w, b)
            else:
                out[f"{prefix}.{name}.w"], out[f"{prefix}.{name}.b"] = w.contiguous(), b
    out["renderer.variance.variance"] = torch.tensor(r["DEVIATION"]["INIT_VAL"],
                                                     dtype=torch.float32, device=device)
    return out


@torch.no_grad()
def coarse_field(leaves: dict, r: dict, bmin, bmax, res: int, stride: int = 8):
    """(the reference SDF at the corners of the lattice's blocks of
    `stride`^3 cells [nb + 1]^3, the corners' points [(nb + 1)^3, 3], a
    block's diagonal): the lattice is the extraction's (`res` points a
    side over [bmin, bmax]), read one point in `stride` a side."""
    nb = res // stride
    h = (np.asarray(bmax, np.float32) - np.asarray(bmin, np.float32)) / np.float32(res - 1)
    dev = leaves["renderer.variance.variance"].device
    axes = [torch.arange(nb + 1, dtype=torch.float32, device=dev) * float(h[i] * stride)
            + float(bmin[i]) for i in range(3)]
    pts = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    sdf = torch.cat([nets.sdf_net(leaves, r, pts[i:i + (1 << 17)])[:, 0]
                     for i in range(0, pts.shape[0], 1 << 17)]).reshape(nb + 1, nb + 1, nb + 1)
    return sdf, pts, float(np.linalg.norm(h * stride))


def _corners(field: torch.Tensor) -> torch.Tensor:
    nb = field.shape[0] - 1
    return torch.stack([field[i:i + nb, j:j + nb, k:k + nb]
                        for i in (0, 1) for j in (0, 1) for k in (0, 1)])


@torch.no_grad()
def level_surface(leaves: dict, r: dict, radius: float, bmin, bmax, res: int,
                  stride: int = 8) -> None:
    """Shift the SDF net's output bias (in place) so that as many blocks
    of `stride`^3 lattice cells lie near the zero level set as near a
    sphere of `radius`: a block is near when the SDF at one of its corners
    is within the block's diagonal of 0, or its corners differ in sign.
    The geometric init's surface otherwise sits where the seed's hidden
    layers put it (radius 0.14-0.18 at the published widths), and the
    near blocks, the work of a sparse extraction, move with the seed by
    +-10%."""
    sdf, pts, diag = coarse_field(leaves, r, bmin, bmax, res, stride)

    def near(field: torch.Tensor) -> int:
        cs = _corners(field)
        lo, hi = cs.amin(0), cs.amax(0)
        return int(((cs.abs().amin(0) <= diag) | ((lo < 0) & (hi > 0))).sum())

    target = near(torch.linalg.norm(pts, dim=-1).reshape(sdf.shape) - radius)
    lo, hi = -1.0, 1.0      # sdf - d: a larger d, a larger surface
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if near(sdf - mid) < target else (lo, mid)
    last = f"renderer.sdf.lin{len(networks.sdf_layers(r)) - 1}.b"
    leaves[last][0] -= hi * r["SDF"]["SCALE"]


@torch.no_grad()
def surface_blocks(leaves: dict, r: dict, bmin, bmax, res: int, threshold: float,
                   stride: int = 8) -> int:
    """The blocks of `stride`^3 lattice cells whose corners the level
    u = -sdf = threshold separates, under the reference SDF: blocks the
    surface certainly crosses, the least a sparse extraction evaluates."""
    cs = _corners(-coarse_field(leaves, r, bmin, bmax, res, stride)[0])
    return int(((cs.amin(0) <= threshold) & (cs.amax(0) > threshold)).sum())


def _weight_norm(out: dict, prefix: str, w: torch.Tensor, b: torch.Tensor) -> None:
    out[f"{prefix}.v"] = w.contiguous()
    out[f"{prefix}.g"] = torch.linalg.norm(w, dim=1)
    out[f"{prefix}.b"] = b
