"""Mesh-extraction wall time at MET_RES^3: the port of
tools/mesh_extraction_timing.py.

Color-NeuS (no_view_dir) on its geometric init (a generator seeded 3),
the bbox [-1.01, 1.01]^3; at res 128 first (the kernels' first launches
and the host marcher's first call land there), then at MET_RES (default
512):

  * grid_eval_s: evaluate_sdf_grid (row 2, EXTRACT_PRECISION MET_PREC:
    f32 | f32x3 | bf16), every chunk copied to the host;
  * marching_s: marching_cubes on the whole grid (the host);
  * vertex_colors_s: extract_vertex_colors of its vertices (row 5);
  * overlapped_grid_plus_marching_s: extract_geometry dense with
    overlap=True (x-slabs marched in a thread while the card evaluates);
  * sparse_grid_plus_marching_s, sparse_steady_s: the coarse-to-fine
    extraction twice (JAX's second call is its steady state after a
    compile; here both run the same code);
  * the vertex counts of the three meshes;
  * f32_reference (MET_PREC other than f32): the f32 grid's seconds, the
    largest |sdf| difference of the measured arm from it, one voxel's size
    and the difference in voxels.

    python -m color_neus_torch.tools.mesh_extraction_timing           # on the card
    MET_PREC=f32x3 python -m color_neus_torch.tools.mesh_extraction_timing
    MET_RES=32 python -m color_neus_torch.tools.mesh_extraction_timing --device cpu

Host clock, each step ending on the host (the grid is a numpy array).
Below res 128 the first pass runs at MET_RES. Prints one JSON line with
JAX's keys and the card's name and power limit.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from color_neus_torch import pin_precision
from color_neus_torch.models.configs import ColorConfig, RendererConfig
from color_neus_torch.models.neus import init_renderer
from color_neus_torch.ops import mesh as M
from color_neus_torch.ops.marching_cubes import marching_cubes
from color_neus_torch.tools import parse_device, platform_name, print_report

BMIN = np.full(3, -1.01, np.float32)
BMAX = np.full(3, 1.01, np.float32)


def geometric_renderer(device, **over):
    """(params, rcfg): Color-NeuS no_view_dir on its geometric init, a
    generator seeded 3 (JAX's PRNGKey(3))."""
    rcfg = RendererConfig(kind="color_neus",
                          color=ColorConfig(mode="no_view_dir", d_in=6, multires_view=0), **over)
    g = torch.Generator(device=device).manual_seed(3)
    return init_renderer(rcfg, g, device), rcfg


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def run(res: int, prec: str, device) -> dict:
    pin_precision()
    params, rcfg = geometric_renderer(device, extract_precision=prec)
    rep = {"what": f"mesh extraction wall time, extract_precision={prec}",
           "platform": platform_name(device)}
    u_ref = None
    first = min(128, res)
    for r in (first, res) if res != first else (res,):
        _sync(device)
        t0 = time.perf_counter()
        u = M.evaluate_sdf_grid(params, rcfg, BMIN, BMAX, r)
        t1 = time.perf_counter()
        verts, _tris = marching_cubes(u, 0.0)
        t2 = time.perf_counter()
        # grid index -> world coordinates (the evaluate entry's convention)
        vw = (verts / (r - 1.0) * (BMAX - BMIN) + BMIN).astype(np.float32)
        colors = M.extract_vertex_colors(params, rcfg, vw)
        t3 = time.perf_counter()
        v2, _ = M.extract_geometry(params, rcfg, BMIN, BMAX, r, overlap=True, sparse=False)
        t4 = time.perf_counter()
        v3, _ = M.extract_geometry(params, rcfg, BMIN, BMAX, r, sparse=True)
        t5 = time.perf_counter()
        v3, _ = M.extract_geometry(params, rcfg, BMIN, BMAX, r, sparse=True)
        t6 = time.perf_counter()
        rep[f"res{r}"] = {
            "grid_eval_s": round(t1 - t0, 3),
            "marching_s": round(t2 - t1, 3),
            "vertex_colors_s": round(t3 - t2, 3),
            "overlapped_grid_plus_marching_s": round(t4 - t3, 3),
            "sparse_grid_plus_marching_s": round(t5 - t4, 3),
            "sparse_steady_s": round(t6 - t5, 3),
            "n_verts": int(len(verts)),
            "n_verts_overlapped": int(len(v2)),
            "n_verts_sparse": int(len(v3)),
        }
        if not np.isfinite(colors).all():
            raise RuntimeError(f"non-finite vertex colours at res {r}")
        if r == res:
            u_ref = u
    if prec != "f32":
        rcfg_f32 = dataclasses.replace(rcfg, extract_precision="f32")
        t0 = time.perf_counter()
        u_f32 = M.evaluate_sdf_grid(params, rcfg_f32, BMIN, BMAX, res)
        t1 = time.perf_counter()
        err, voxel = float(np.abs(u_ref - u_f32).max()), float((BMAX[0] - BMIN[0]) / (res - 1))
        rep["f32_reference"] = {"grid_eval_s": round(t1 - t0, 3),
                                "max_abs_sdf_err_vs_f32": err, "voxel": voxel,
                                "err_in_voxels": err / voxel}
    rep[f"res{first}"]["note"] = "includes the first launches"
    return rep


def main(argv=None) -> dict:
    device = parse_device(argv, "mesh-extraction wall time")
    return print_report(run(int(os.environ.get("MET_RES", 512)),
                            os.environ.get("MET_PREC", "f32"), device), device)


if __name__ == "__main__":
    main()
