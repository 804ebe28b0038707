"""Times the four point-pipeline kernels at the training step's shapes,
Color-NeuS at full width, off geometric init, with CUDA events: the
point-pipeline forward and backward (kernel rows 5 and 6) on 131,072
points, and the fused march forward and backward (rows 3 and 4) on 1024
rays x 128 samples.

    python -m color_neus_torch.tools.pipeline_time     # on the card, from a checkout's root

It builds and loads the kernels of the checkout it is imported from and
uses only their public launch functions and chip_smoke.py's input makers,
so a copy of this file dropped into another checkout (a cost probe: one
part of a kernel removed) times that checkout's kernels the same way.
Prints one JSON line: {"card", "row5_ms", "row3_ms", "row6_ms", "row4_ms",
"peak_gib"}.
"""

from __future__ import annotations

import json
import sys


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("pipeline_time: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from color_neus_torch import pin_precision
    from color_neus_torch.models.configs import ColorConfig, RendererConfig
    from color_neus_torch.models.neus import init_renderer
    from color_neus_torch.ops.kernels import build
    from color_neus_torch.ops.kernels import point_pipeline as PP
    from color_neus_torch.ops.kernels import ray_march as RM

    pin_precision()
    device = torch.device("cuda")
    build.build(("point_pipeline", "ray_march"))
    g = torch.Generator(device=device).manual_seed(cs.SEED + 70)
    rcfg = RendererConfig(kind="color_neus",
                          color=ColorConfig(mode="no_view_dir", d_in=6, multires_view=0))
    params = cs.off_geometric_init(init_renderer(rcfg, g, device), g)
    pw = PP.resolve_pipeline_weights(params, rcfg)
    R, S = cs.PIPELINE_RAYS, cs.PIPELINE_SAMPLES
    o, d, z = cs.sweep_inputs(R, S, device, cs.SEED + 80 + R)
    pts = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3).contiguous()
    dirs = d[:, None, :].expand(R, S, 3).reshape(-1, 3).contiguous()
    gbar = torch.randn((R * S, 16), generator=g, device=device)
    gbar[:, 13:] = 0.0
    gbar = gbar.contiguous()
    torch.cuda.reset_peak_memory_stats()
    row5 = cs.cuda_ms(lambda: PP.launch_point_pipeline(pw, pts, dirs))
    row6 = cs.cuda_ms(lambda: PP.launch_point_pipeline_bwd(pw, pts, dirs, gbar), reps=5)

    _, pw, o, d, z, inv_s, gb = cs.march_inputs(device, "color_neus", 0.3, cs.SEED + 120)
    sd = 2.0 / rcfg.n_samples
    row3 = cs.cuda_ms(lambda: RM.launch_ray_march(pw, o, d, z, inv_s, sd))
    _, stash = RM.launch_ray_march(pw, o, d, z, inv_s, sd)
    row4 = cs.cuda_ms(lambda: RM.launch_ray_march_bwd(pw, o, d, z, inv_s, sd, stash, gb), reps=5)
    print(json.dumps({"card": cs.card_line(), "row5_ms": row5, "row3_ms": row3, "row6_ms": row6,
                      "row4_ms": row4,
                      "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
