"""The judge of a coloured mesh: the reference SDF and colour net in plain
PyTorch f32 (TF32 off), evaluated where the program's answers say the
surface is, and along lattice lines the reference draws itself.

  vertex_sdf  the largest |sdf + threshold| at the program's vertices, in
              grid steps h: a vertex interpolated from a sound grid lies
              on the level set to rounding;
  coverage    the lattice's x-edges that the reference's SDF crosses on
              `lines` lines drawn from the seed: each crossing (linear
              between the two lattice values, as a marcher places it) has
              a program vertex; the largest distance to the nearest one,
              in h, reads a missing or moved part of the surface;
  color_gap   the largest gap, over every vertex, between the program's
              colour and the reference's colour net on the SDF's gradient
              as the normal and its negation as the view direction
              (reference NeuS.py:44-64);
  bad_tris    triangles with an index outside the vertices or an edge
              longer than a lattice cell's diagonal (a marched triangle
              lies in one cell): exact, limit 0. An index twice is no
              fault: where a crossing lies within f32 rounding of a
              lattice point (a few in a million at res 512), two of a
              cell's vertices round onto it and weld into one;
  area_gap    the mesh's area seen along x (the sum of its triangles'
              |x component of the area vector|, which counts each layer
              of the surface) against the reference's: its crossings of
              the lattice's x-lines at every AREA_STRIDE-th y and z, each
              standing for a AREA_STRIDE h square; relative;
  empty       1 when the program returned no mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import nets
from benchmark.reference.train import pin_f32

BLOCK = 1 << 17
AREA_STRIDE = 4


def lattice_axes(bmin, bmax, res: int, device):
    """The lattice's axes as np.linspace in f32 (the grid the program
    marches)."""
    return [torch.as_tensor(np.linspace(np.float32(bmin[i]), np.float32(bmax[i]), res,
                                        dtype=np.float32), device=device) for i in range(3)]


def sdf_at(leaves, r, pts, quant=None):
    with torch.no_grad():
        return torch.cat([nets.sdf_net(leaves, r, pts[i:i + BLOCK], quant)[:, 0]
                          for i in range(0, pts.shape[0], BLOCK)])


def colors_at(leaves, r, pts, quant=None):
    out = []
    for i in range(0, pts.shape[0], BLOCK):
        p = pts[i:i + BLOCK]
        _, feat, grad = nets.sdf_with_grad(leaves, r, p, quant)
        out.append(nets.color_net(leaves, r, p, grad, -grad, feat, quant).detach())
    return torch.cat(out)


def crossings(leaves, r, axes, threshold: float, lines: int, g, quant=None):
    """The points where u = -sdf crosses `threshold` on x-edges of
    `lines` lattice lines (y, z drawn from g)."""
    res = axes[0].shape[0]
    jk = torch.randint(0, res, (lines, 2), generator=g, device=axes[0].device)
    pts = torch.stack([axes[0][None, :].expand(lines, res),
                       axes[1][jk[:, 0]][:, None].expand(lines, res),
                       axes[2][jk[:, 1]][:, None].expand(lines, res)], -1)
    u = -sdf_at(leaves, r, pts.reshape(-1, 3), quant).reshape(lines, res)
    above = u > threshold
    hit = above[:, 1:] != above[:, :-1]
    li, xi = torch.nonzero(hit, as_tuple=True)
    u0, u1 = u[li, xi], u[li, xi + 1]
    t = (threshold - u0) / (u1 - u0)
    x = axes[0][xi] + t * (axes[0][xi + 1] - axes[0][xi])
    return torch.stack([x, pts[li, 0, 1], pts[li, 0, 2]], -1)


def nearest(points, verts, chunk: int = 64):
    """Distance of each point to its nearest vertex."""
    out = []
    for i in range(0, points.shape[0], chunk):
        out.append(torch.cdist(points[i:i + chunk], verts).amin(dim=1))
    return torch.cat(out) if out else points.new_zeros(0)


def bad_triangles(v, tris, diag: float) -> int:
    """Triangles with an index outside v or an edge longer than `diag`
    (a relative 1e-3 of slack for the f32 vertices)."""
    t = torch.as_tensor(np.asarray(tris, np.int64), device=v.device).reshape(-1, 3)
    outside = ((t < 0) | (t >= v.shape[0])).any(1)
    p = v.double()[t.clamp(0, max(v.shape[0] - 1, 0))]
    edge = torch.stack([torch.linalg.norm(p[:, a] - p[:, b], dim=-1)
                        for a, b in ((0, 1), (1, 2), (2, 0))]).amax(0)
    return int((outside | (edge > diag * (1 + 1e-3))).sum())


def mesh_area_x(v, tris) -> float:
    """The sum over triangles of |the x component of the area vector|."""
    t = torch.as_tensor(np.asarray(tris, np.int64), device=v.device).reshape(-1, 3)
    t = t.clamp(0, max(v.shape[0] - 1, 0))
    p = v.double()[t]
    a = torch.linalg.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    return float(a[:, 0].abs().sum()) / 2


def reference_area_x(leaves, r, axes, threshold: float, quant=None) -> float:
    """The reference surface's area seen along x: its crossings of the
    lattice's x-lines at every AREA_STRIDE-th y and z, times the square
    each line stands for."""
    res = axes[0].shape[0]
    ys = axes[1][AREA_STRIDE // 2::AREA_STRIDE]
    zs = axes[2][AREA_STRIDE // 2::AREA_STRIDE]
    crossings = 0
    for y in ys:
        pts = torch.stack([axes[0][None, :].expand(zs.shape[0], res),
                           y.expand(zs.shape[0], res),
                           zs[:, None].expand(zs.shape[0], res)], -1)
        u = -sdf_at(leaves, r, pts.reshape(-1, 3), quant).reshape(zs.shape[0], res)
        above = u > threshold
        crossings += int((above[:, 1:] != above[:, :-1]).sum())
    dy = float(axes[1][1] - axes[1][0]) * AREA_STRIDE
    dz = float(axes[2][1] - axes[2][0]) * AREA_STRIDE
    return crossings * dy * dz


def judge(leaves, r, verts, tris, colors, bmin, bmax, res: int, threshold: float,
          lines: int, seed_gen, device, quant=None) -> dict:
    """{number: value} of one extraction's answers (numpy arrays)."""
    pin_f32()
    step = (np.asarray(bmax, np.float64) - np.asarray(bmin, np.float64)) / (res - 1)
    h = float(np.max(step))
    if len(verts) == 0:
        return {"vertex_sdf": 0.0, "coverage": 0.0, "color_gap": 0.0, "bad_tris": 0.0,
                "area_gap": 1.0, "empty": 1.0}
    v = torch.as_tensor(np.asarray(verts, np.float32), device=device)
    c = torch.as_tensor(np.asarray(colors, np.float32), device=device)
    vertex_sdf = float((sdf_at(leaves, r, v, quant) + threshold).abs().max()) / h
    color_gap = float((colors_at(leaves, r, v, quant) - c).abs().max())
    axes = lattice_axes(bmin, bmax, res, device)
    cross = crossings(leaves, r, axes, threshold, lines, seed_gen, quant)
    coverage = float(nearest(cross, v).max()) / h if cross.shape[0] else 0.0
    bad = bad_triangles(v, tris, float(np.linalg.norm(step)))
    ref_area = reference_area_x(leaves, r, axes, threshold, quant)
    area_gap = abs(mesh_area_x(v, tris) - ref_area) / ref_area if ref_area > 0 else 1.0
    return {"vertex_sdf": vertex_sdf, "coverage": coverage, "color_gap": color_gap,
            "bad_tris": float(bad), "area_gap": area_gap, "empty": 0.0}
