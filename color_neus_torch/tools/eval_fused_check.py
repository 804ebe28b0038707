"""Equality gate of the evaluation path's kernels: the port of
tools/tpu_eval_fused_check.py.

On the card (or the CPU with --device cpu, where the kernels' plain twins
run instead):

  * extract_vertex_colors through the point-pipeline kernel (row 5,
    fused_core auto) against the fields path (fused_core off), in both
    colour modes: no_view_dir (Color-NeuS, one pass) and idr (NeuS with
    d_in 9 and multires_view 4: a first pass gives the gradient whose
    negation is the view direction), on EFC_VERTS points (default 5000,
    RandomState(0) x 0.3); the kernel's bf16 products against f32 on a
    sigmoid's output: within 5e-2, JAX's bound;
  * evaluate_sdf_grid through row 2 in f32 against the fields path's
    sdf_value (f32 products, TF32 off) at EFC_RES^3 (default 64): within
    1e-4, JAX's bound (both f32, the summation orders differ).

Both renderers on their geometric init (a generator seeded 3).

    python -m color_neus_torch.tools.eval_fused_check           # on the card
    EFC_RES=16 python -m color_neus_torch.tools.eval_fused_check --device cpu

Prints one JSON line {"pass": bool, "platform", "checks": {...}} (JAX's)
and the card's name and power limit.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from color_neus_torch import pin_precision
from color_neus_torch.models import fields
from color_neus_torch.models.configs import ColorConfig, RendererConfig
from color_neus_torch.models.neus import init_renderer
from color_neus_torch.ops import mesh as M
from color_neus_torch.tools import parse_device, platform_name, print_report
from color_neus_torch.tools.mesh_extraction_timing import BMAX, BMIN, geometric_renderer

ATOL_COLOURS = 5e-2
ATOL_GRID = 1e-4


def run(res: int, n_verts: int, device) -> dict:
    pin_precision()
    rep = {"platform": platform_name(device), "checks": {}}
    ok = True
    verts = (np.random.RandomState(0).randn(n_verts, 3) * 0.3).astype(np.float32)
    for mode, d_in, mrv in (("no_view_dir", 6, 0), ("idr", 9, 4)):
        rcfg = RendererConfig(kind="color_neus" if mode == "no_view_dir" else "neus",
                              color=ColorConfig(mode=mode, d_in=d_in, multires_view=mrv))
        params = init_renderer(rcfg, torch.Generator(device=device).manual_seed(3), device)
        fused = M.extract_vertex_colors(params, rcfg, verts)
        off = M.extract_vertex_colors(params, dataclasses.replace(rcfg, fused_core="off"),
                                      verts)
        err = float(np.abs(fused - off).max())
        rep["checks"][f"vertex_colors_{mode}_max_abs_err"] = err
        ok &= err < ATOL_COLOURS and bool(np.isfinite(fused).all())

    params, rcfg = geometric_renderer(device)
    grid_f = M.evaluate_sdf_grid(params, rcfg, BMIN, BMAX, res)

    def plain_chunk(p):
        return -fields.sdf_value(params["sdf"], rcfg.sdf, p)[:, 0]

    grid_x = M.evaluate_sdf_grid(params, rcfg, BMIN, BMAX, res, sdf_chunk_fn=plain_chunk)
    err = float(np.abs(grid_f - grid_x).max())
    rep["checks"]["sdf_grid_max_abs_err"] = err
    ok &= err < ATOL_GRID
    rep["pass"] = bool(ok)
    return rep


def main(argv=None) -> dict:
    device = parse_device(argv, "equality gate of the evaluation path's kernels")
    return print_report(run(int(os.environ.get("EFC_RES", 64)),
                            int(os.environ.get("EFC_VERTS", 5000)), device), device)


if __name__ == "__main__":
    main()
