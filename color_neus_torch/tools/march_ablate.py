"""Ablation of the fused march backward's load entry (kernel row 4 in the
save mode) on the card: the port of tools/march_ablate.py.

JAX's tool monkeypatches the kernel's helpers; the port builds the
march's source again with one part of the work skipped, a compile-time
switch (RM_ABLATE in csrc/point_pipeline_tile.cuh; the libraries of
ops/kernels/build.py ABLATIONS, built here, all nvcc processes at once,
and only here: the default library is built without the switch):

  full            the production code, built again: the tool's own launch
                  path, held against the production entry in this process
  no_pullback     backward_tile skipped (the reverse sweeps' products and
                  the weight-grad operands) and the weight-grad flush:
                  the stash load and the compositing VJP remain
  no_unflatten    load_tile skipped: the stash is not read, the tile and
                  its scratch keep what they held
  pullback_only   the per-ray compositing VJP skipped (the cotangents
                  taken as the scratch holds them); in the forward, the
                  per-ray compositing scan (JAX's fwd_no_composite)
  no_wgrad        the weight-grad operand stores and the per-batch flush
                  skipped (the port's own)

The MARCH_BWD_PRECISION mode is ABL_PREC (f32stash by default, or bf16 /
f32): the mode's production entry and its five builds
(build.ablation_names); in every mode no_wgrad skips whatever route the
mode's weight grads take.

At JAX's shape: ABL_N_RAYS rays (default 1024) x 512 samples, Color-NeuS
at full width on its geometric init, in mode ABL_PREC, inv_s 64, rays
toward +z through the unit sphere, sorted z in [1.5, 3.5], cotangents
N(0, 0.01). The ablated outputs are garbage and only timed.
Each entry is timed with CUDA events over ABL_REPS back-to-back launches
(default 5, after one), the wrapper's allocations and the partials'
reduction included as in training. Prints one JSON object: JAX's keys
(fwd_save_ms, fwd_nosave_ms, bwd_<variant>_ms, fwd_no_composite_ms), each
variant's difference from full, the production load entry's ms
(production_load_ms), the mode (prec) and the card.

    python -m color_neus_torch.tools.march_ablate       # on the card only
    ABL_PREC=f32 python -m color_neus_torch.tools.march_ablate

There is no CPU path: the variants are CUDA builds, so the tool raises
without a card.
"""

from __future__ import annotations

import os

import torch

from color_neus_torch import pin_precision
from color_neus_torch.models.configs import ColorConfig, RendererConfig
from color_neus_torch.models.neus import init_renderer
from color_neus_torch.ops.kernels import build
from color_neus_torch.ops.kernels import point_pipeline as PP
from color_neus_torch.ops.kernels import ray_march as RM
from color_neus_torch.tools import parse_device, print_report
from color_neus_torch.tools._timing import cuda_ms

S = 512


def inputs(n_rays: int, device, seed: int = 0, mode: str = "f32stash", n_samples: int = S):
    """(pw, rays_o, rays_d, z, inv_s, gbar) at JAX's ablation shape
    (march_ablate.py:60-93; n_samples a ray): geometric init,
    MARCH_BWD_PRECISION mode."""
    rcfg = RendererConfig(kind="color_neus", n_samples=256, n_importance=256,
                          up_sample_steps=4,
                          color=ColorConfig(mode="no_view_dir", d_in=6, multires_view=0),
                          march_bwd_precision=mode)
    g = torch.Generator(device=device).manual_seed(seed)
    pw = PP.resolve_pipeline_weights(init_renderer(rcfg, g, device), rcfg)
    ro = torch.randn((n_rays, 3), generator=g, device=device) * 0.1 \
        + torch.tensor([0.0, 0.0, -2.5], device=device)
    rd = torch.randn((n_rays, 3), generator=g, device=device) * 0.05 \
        + torch.tensor([0.0, 0.0, 1.0], device=device)
    rd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    z = torch.sort(torch.rand((n_rays, n_samples), generator=g, device=device) * 2.0 + 1.5,
                   dim=1).values
    inv_s = torch.full((1,), 64.0, device=device)
    gbar = torch.randn((n_rays, 16), generator=g, device=device) * 0.01
    return pw, ro.contiguous(), rd.contiguous(), z.contiguous(), inv_s, gbar.contiguous()


def run(n_rays: int, reps: int, device, mode: str = "f32stash") -> dict:
    if device.type != "cuda":
        raise RuntimeError("march_ablate times CUDA builds of the march kernels: it needs "
                           "a card and has no CPU path")
    pin_precision()
    libraries = build.ablation_names(mode)   # variant -> its build's name
    build.build(tuple(libraries.values()))
    pw, ro, rd, z, inv_s, gbar = inputs(n_rays, device, mode=mode)
    sd = 2.0 / pw.rcfg.n_samples

    def ms(fn):
        return cuda_ms(fn, reps=reps, warmup=1)

    res = {"n_rays": n_rays, "n_samples": S, "reps": reps, "prec": mode,
           "fwd_save_ms": ms(lambda: RM.launch_ray_march_save(pw, ro, rd, z, inv_s, sd)),
           "fwd_nosave_ms": ms(lambda: RM.launch_ray_march(pw, ro, rd, z, inv_s, sd))}
    _, stash, act = RM.launch_ray_march_save(pw, ro, rd, z, inv_s, sd)
    res["production_load_ms"] = ms(lambda: RM.launch_ray_march_bwd_load(
        pw, ro, rd, z, inv_s, sd, stash, act, gbar))
    for v, name in libraries.items():
        lib = RM._library(mode, name)
        res[f"bwd_{v}_ms"] = ms(lambda: RM._bwd(pw, ro, rd, z, inv_s, sd, stash, act, gbar,
                                                lib=lib))
        if v == "pullback_only":
            res["fwd_no_composite_ms"] = ms(lambda: RM._fwd(pw, ro, rd, z, inv_s, sd, True,
                                                            lib=lib))
    res["minus_full_ms"] = {v: res[f"bwd_{v}_ms"] - res["bwd_full_ms"] for v in libraries}
    res["full_over_production"] = res["bwd_full_ms"] / res["production_load_ms"]
    return res


def main(argv=None) -> dict:
    device = parse_device(argv, "ablation of the march backward's load entry")
    return print_report(run(int(os.environ.get("ABL_N_RAYS", 1024)),
                            int(os.environ.get("ABL_REPS", 5)), device,
                            os.environ.get("ABL_PREC", "f32stash")), device, indent=1)


if __name__ == "__main__":
    main()
