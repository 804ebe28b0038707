"""The extraction traffic: the coloured mesh of the seed's weights, as
TrainLoop.validate_mesh makes it (color_neus_torch.ops.mesh
extract_geometry, then extract_vertex_colors), without the PLY writes,
back to back.

A traffic file of this kind holds:
  kind               "extract"
  resolution         the lattice's points a side (512: evaluate -rr 512)
  bbox               [[x, y, z] min, [x, y, z] max] of the lattice
  threshold          the level of u = -sdf the marcher extracts
  surface_radius     the sphere whose near blocks the seed's surface is
                     levelled to (benchmark.scene.level_surface), so that
                     every seed gives an extraction of the same size
  lines              lattice lines the judge draws for `coverage`
  trace_extractions  extractions under the profiler in a --trace 1 run
  limits             {number: limit} of benchmark.reference.extract.judge
                     and `repeat_mismatch`

Set-up builds the renderer's parameters from the benchmark's leaves,
counts the blocks the surface crosses under the reference SDF (the
grid's least work, benchmark.scene.surface_blocks) and runs one
extraction (it builds the kernels). The window runs extractions
until --seconds have passed; each one's answers are digested, and the
last one is judged once the window has closed: `repeat_mismatch` counts
the window's extractions whose vertices, triangles or colours differ from
the judged one's bit for bit.
"""

from __future__ import annotations

import gc
import hashlib
import time

import numpy as np
import torch

from benchmark import scene as S
from benchmark.counts import networks
from benchmark.reference import extract as ref_extract


class Program:
    """The port's renderer parameters and its extraction entry."""

    def __init__(self, cfg: dict, leaves: dict, device, overrides: dict | None = None):
        from color_neus_torch import pin_precision
        from color_neus_torch.models import neus
        from color_neus_torch.models.configs import renderer_config_from_cfg
        pin_precision()
        r = dict(cfg["MODEL"]["RENDERER"], **(overrides or {}))
        self.rcfg = renderer_config_from_cfg(r)
        self.params = neus.init_renderer(self.rcfg, torch.Generator(device=device).manual_seed(0),
                                         device)
        named = {f"renderer.{k}": p for k, p in self.params.named_parameters()}
        mine = {k: v for k, v in leaves.items() if k.startswith("renderer.")}
        if set(named) != set(mine) or any(named[k].shape != mine[k].shape for k in named):
            raise RuntimeError("the program's parameters are not the benchmark's leaves: "
                               f"{sorted(set(named) ^ set(mine))}")
        with torch.no_grad():
            for k, p in named.items():
                p.copy_(mine[k])

    def extract(self, res: int, bmin, bmax, threshold: float):
        """(vertices, triangles, colours, stats) of one extraction."""
        from color_neus_torch.ops import mesh as M
        stats: dict = {}
        verts, tris = M.extract_geometry(self.params, self.rcfg, bmin, bmax, res, threshold,
                                         stats=stats)
        colors = (M.extract_vertex_colors(self.params, self.rcfg, verts) if len(verts)
                  else np.zeros((0, 3), np.float32))
        return verts, tris, colors, stats


def make_leaves(cell, seed: int, device) -> dict:
    """The renderer's first weights of an extraction cell from the seed."""
    r = cell.config["MODEL"]["RENDERER"]
    leaves = S.renderer_leaves(r, seed, device)
    t = cell.traffic
    if "surface_radius" in t:
        S.level_surface(leaves, r, float(t["surface_radius"]), *t["bbox"], int(t["resolution"]))
    return leaves


def digest(verts, tris, colors) -> str:
    h = hashlib.sha256()
    for a in (verts, tris, colors):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(cell, seed: int, seconds: float, trace: bool, device, clock_start: float,
        trace_fn=None) -> dict:
    cfg, t = cell.config, cell.traffic
    r = cfg["MODEL"]["RENDERER"]
    res, thr = int(t["resolution"]), float(t.get("threshold", 0.0))
    bmin, bmax = (np.asarray(b, np.float32) for b in t["bbox"])
    leaves = make_leaves(cell, seed, device)
    blocks = S.surface_blocks(leaves, r, bmin, bmax, res, thr, block_side(res))
    prog = Program(cfg, leaves, device)
    prog.extract(res, bmin, bmax, thr)
    _sync(device)
    out = {"setup_s": time.perf_counter() - clock_start}
    runs = []

    def one():
        runs.append(prog.extract(res, bmin, bmax, thr))
        runs[-1] = runs[-1] + (digest(*runs[-1][:3]),)

    if trace:
        n = int(t.get("trace_extractions", 1))
        window_s, events = trace_fn(lambda: [one() for _ in range(n)])
        out.update(window_s=window_s, events=events)
    else:
        t0 = time.perf_counter()
        while True:
            one()
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(device)
        out["window_s"] = time.perf_counter() - t0
        out["extract_s"] = out["window_s"] / len(runs)
    out["attempted"] = len(runs)
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                if torch.device(device).type == "cuda" else 0)
    verts, tris, colors, stats, dig = runs[-1]
    out["stats"] = [x[3] for x in runs]
    out["n_verts"] = len(verts)
    out["failed"] = sum(x[4] != dig for x in runs)
    del prog
    gc.collect()
    g = torch.Generator(device=device).manual_seed(S._seed63(seed, 5))
    nums = ref_extract.judge(leaves, r, verts, tris, colors, bmin, bmax, res, thr,
                             int(t.get("lines", 4096)), g, device)
    nums["repeat_mismatch"] = float(out["failed"])
    out["numbers"] = nums
    out["counts"] = extraction_counts(r, res, blocks, len(verts))
    return out


def block_side(res: int) -> int:
    """The lattice cells a side of the sparse grid's blocks (ops/mesh's)."""
    return 8 if res >= 128 else 4


def extraction_counts(r: dict, res: int, blocks: int, n_verts: int) -> dict:
    """The benchmark's operations and bytes of one extraction: the grid
    SDF at the coarse corners and at every point of the `blocks` blocks
    the surface crosses (benchmark.scene.surface_blocks: the benchmark's
    own count, whatever blocks the program evaluates), and the vertex
    colours (the SDF, its gradient and the colour net at every vertex)."""
    f = block_side(res)
    nb = res // f
    pts = (nb + 1) ** 3 + blocks * f ** 3
    sdf_w = networks.macs(networks.sdf_layers(r))
    col = (networks.macs(networks.sdf_layers(r)) + networks.sdf_value_macs(r)
           + networks.macs(networks.color_layers(r)))
    return {"grid": {"flops": 2.0 * pts * networks.sdf_value_macs(r),
                     "bytes": 4.0 * (sdf_w + 4 * pts), "points": pts},
            "colors": {"flops": 2.0 * n_verts * col, "bytes": 4.0 * (col + 6 * n_verts)}}


def end_to_end(out: dict) -> dict:
    return {"extract_s": out["extract_s"], "setup_s": out["setup_s"]}


def per_layer_context(out: dict, summary, peak) -> dict:
    return {"kind": "extract", "summary": summary, "extractions": out["attempted"],
            "window_s": out["window_s"], "counts": out["counts"], "stats": out["stats"],
            "peak": peak}
