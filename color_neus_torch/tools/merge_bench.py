"""The two sorted merges of the hierarchy, timed and held equal: the port
of tools/merge_bench.py.

merge_z_vals (counting ranks and an equality-masked sum over an [R, n,
n + m] intermediate) against merge_z_vals_sort (one stable sort of the
concatenation, what the hierarchy runs), at the last and largest merge
round of the bench shape (MB_R rays, default 2048, n 448 old samples, m 64
new ones), 8 merges a timed call (JAX's k merges a dispatch, kept), and
one whole hierarchical_z_vals at the bench shape (256 + 256 samples, 4
rounds, the sweeps on row 1 on the card) with each merge. The merges'
outputs must be bitwise equal (z_equal, sdf_equal), as must the two
hierarchies' z (hierarchy_z_equal).

    python -m color_neus_torch.tools.merge_bench              # on the card
    MB_R=16 python -m color_neus_torch.tools.merge_bench --device cpu

Median of 10 calls after 2, CUDA events on the card (the host clock on
the CPU). Prints one JSON line with JAX's keys, the hierarchy's ms with
each merge and the card's name and power limit.
"""

from __future__ import annotations

import os

import torch

from color_neus_torch import pin_precision
from color_neus_torch.models import neus
from color_neus_torch.ops.kernels.sdf_rays import resolve_sdf_sweep_fn
from color_neus_torch.ops.rays import near_far_from_sphere
from color_neus_torch.tools import parse_device, print_report
from color_neus_torch.tools._timing import median_ms
from color_neus_torch.tools.bench_step import bench_config

K = 8          # merges a timed call
N_OLD, N_NEW = 448, 64


def run(R: int, device) -> dict:
    pin_precision()

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    z = torch.sort(torch.rand((R, N_OLD), generator=gen(0), device=device), dim=1).values
    zn = torch.sort(torch.rand((R, N_NEW), generator=gen(1), device=device), dim=1).values
    s = torch.randn((R, N_OLD), generator=gen(2), device=device)
    sn = torch.randn((R, N_NEW), generator=gen(3), device=device)

    def many(fn):
        def f():
            acc = torch.zeros((), device=device)
            for _ in range(K):
                zz, ss = fn(z + acc * 1e-30, zn, s, sn)
                acc = acc + zz[0, 0] + ss[0, 0]
            return acc
        return f

    res = {"counting_ms_per_merge": round(median_ms(many(neus.merge_z_vals), device) / K, 4),
           "sort_ms_per_merge": round(median_ms(many(neus.merge_z_vals_sort), device) / K, 4)}
    a = neus.merge_z_vals(z, zn, s, sn)
    b = neus.merge_z_vals_sort(z, zn, s, sn)
    res["z_equal"] = bool(torch.equal(a[0], b[0]))
    res["sdf_equal"] = bool(torch.equal(a[1], b[1]))

    # one whole hierarchy at the bench shape with each merge
    rcfg = bench_config(R).renderer
    params = neus.init_renderer(rcfg, gen(0), device)
    d = torch.randn((R, 3), generator=gen(4), device=device)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    o = -2.4 * d + 0.05 * torch.randn((R, 3), generator=gen(5), device=device)
    near, far = near_far_from_sphere(o, d)
    sweep = resolve_sdf_sweep_fn(params["sdf"], rcfg.sdf, rcfg.fused_sdf,
                                 dtype=rcfg.sweep_dtype, act=rcfg.sweep_activation)

    def hier(merge):
        return neus.hierarchical_z_vals(params, rcfg, o, d, near, far, generator=gen(6),
                                        sdf_rays_fn=sweep, merge=merge)

    for name, merge in (("counting", neus.merge_z_vals), ("sort", neus.merge_z_vals_sort)):
        res[f"hierarchy_{name}_ms"] = round(median_ms(lambda: hier(merge), device), 4)
    res["hierarchy_z_equal"] = bool(torch.equal(hier(neus.merge_z_vals),
                                                hier(neus.merge_z_vals_sort)))
    res["R"] = R
    return res


def main(argv=None) -> dict:
    device = parse_device(argv, "the hierarchy's two sorted merges")
    return print_report(run(int(os.environ.get("MB_R", 2048)), device), device)


if __name__ == "__main__":
    main()
