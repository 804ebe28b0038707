"""Offline mesh evaluation: Chamfer distance between two PLY meshes, the
port of tools/mesh_compare.py.

Loads both meshes' vertices, samples each to at most --n points
(RandomState(0), as JAX's), optionally centres and scales both clouds,
and prints the symmetric Chamfer distance in JAX's line.

    python -m color_neus_torch.tools.mesh_compare pred.ply gt.ply [--normalize] \\
        [--n 100000] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from color_neus_torch import resolve_device
from color_neus_torch.ops.mesh import normalize_point_cloud, read_ply
from color_neus_torch.utils.metrics import chamfer_distance


def main(argv=None) -> float:
    p = argparse.ArgumentParser("chamfer mesh comparison")
    p.add_argument("pred")
    p.add_argument("gt")
    p.add_argument("--normalize", action="store_true",
                   help="center + unit-scale both clouds before comparing")
    p.add_argument("--n", type=int, default=100000, help="max points per cloud")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' for the host)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    va, _, _ = read_ply(args.pred)
    vb, _, _ = read_ply(args.gt)
    rng = np.random.RandomState(0)
    if len(va) > args.n:
        va = va[rng.choice(len(va), args.n, replace=False)]
    if len(vb) > args.n:
        vb = vb[rng.choice(len(vb), args.n, replace=False)]
    if args.normalize:
        va = normalize_point_cloud(va)
        vb = normalize_point_cloud(vb)
    d = chamfer_distance(va, vb, device=device)
    print(f"chamfer({args.pred}, {args.gt}) = {d:.6e}")
    return d


if __name__ == "__main__":
    main()
