"""Faults planted in the program underneath a run, for the check that
`correct` comes out false (benchmark/tests, benchmark/calibrate.py). The
benchmark's own runs never plant one.

  unchanged   the step returns its state unchanged: no update reaches
              the parameters or the optimizer (the step count still
              advances);
  half_batch  half of the batch left out: the loss is taken over the
              first half of the rays alone, its means over the rest;
  unchanged_in_graph
              the update left out of the captured graph alone: the
              warm-up bundle's steps update, a replay's do not (a fault
              only a card shows: the CPU runs no graph);
  half_mesh   half of the mesh left out: the vertices with x > 0 and
              their triangles dropped where the mesh is made;
  misindexed  the triangles' indices shifted by one where the mesh is
              made (each names its neighbour's vertices);
  dropped_tris
              every tenth triangle dropped where the mesh is made, the
              vertices kept;
  altered     one answer altered where it is produced: the first
              vertex's colour raised by 0.25.
The first three are a training cell's, the last four an extraction cell's.
"""

from __future__ import annotations

import contextlib

import numpy as np

FAULTS = {"train": ("unchanged", "half_batch"),
          "extract": ("half_mesh", "misindexed", "dropped_tris", "altered")}
CARD_FAULTS = {"train": ("unchanged_in_graph",)}


@contextlib.contextmanager
def planted(name: str):
    from color_neus_torch.models import trainer as TR
    from color_neus_torch.ops import mesh as M
    if name == "half_mesh":
        mod, attr, orig = M, "extract_geometry", M.extract_geometry

        def fault(*args, **kw):
            verts, tris = orig(*args, **kw)
            keep = verts[:, 0] <= 0
            new = np.cumsum(keep) - 1
            tris = tris[keep[tris].all(axis=1)]
            return verts[keep], new[tris]
    elif name in ("misindexed", "dropped_tris"):
        mod, attr, orig = M, "extract_geometry", M.extract_geometry

        def fault(*args, **kw):
            verts, tris = orig(*args, **kw)
            if name == "misindexed":
                return verts, (tris + 1) % max(len(verts), 1)
            return verts, tris[np.arange(len(tris)) % 10 != 0]
    elif name == "altered":
        mod, attr, orig = M, "extract_vertex_colors", M.extract_vertex_colors

        def fault(*args, **kw):
            colors = orig(*args, **kw).copy()
            colors[:1] += 0.25
            return colors
    elif name == "unchanged":
        mod, attr, orig = TR, "apply_gradients", TR.apply_gradients

        def fault(state, cfg):
            lr = TR.lr_schedule(cfg)(state.step_t)
            state.step_t.add_(1)
            state.step += 1
            return lr
    elif name == "unchanged_in_graph":
        import torch
        mod, attr, orig = TR, "apply_gradients", TR.apply_gradients

        def fault(state, cfg):
            if not torch.cuda.is_current_stream_capturing():
                return orig(state, cfg)
            lr = TR.lr_schedule(cfg)(state.step_t)
            state.step_t.add_(1)
            state.step += 1
            return lr
    elif name == "half_batch":
        mod, attr, orig = TR, "compute_loss", TR.compute_loss

        def fault(cfg, render):
            n = render["rgb_map_gt"].shape[0] // 2
            cut = {k: (v[:n] if hasattr(v, "shape") and v.dim() > 0 and v.shape[0] == 2 * n
                       else v) for k, v in render.items()}
            return orig(cfg, cut)
    else:
        raise ValueError(f"no fault {name!r}")
    setattr(mod, attr, fault)
    try:
        yield
    finally:
        setattr(mod, attr, orig)
