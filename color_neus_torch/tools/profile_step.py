"""Decomposition of the bench step's time: the port of
tools/profile_step.py.

At the bench shape (PROF_N_RAYS rays, default 2048, x 512 samples, the
bench step's arm: fused_march on, save), each piece timed on its own:

  * the full train step, one step a call, uncaptured (trainer.full_data_step);
  * the point pipeline (rows 5 + 6, fused_core on) forward + backward
    alone on n_rays x 512 points, and its forward (row 5) alone;
  * hierarchical_z_vals alone, its four sweeps on row 1;
  * the render forward (render_rays without grad: row 5 for the core);
  * the render + loss backward (render_rays_train with grad: rows 3 + 4,
    JAX's loss of rgb, eikonal, mask and relight terms);
  * JAX's two residuals: the step less the loss backward (sampling, rays,
    clip, Adam) and the loss backward less the pipeline and the hierarchy.

    python -m color_neus_torch.tools.profile_step            # on the card
    PROF_N_RAYS=8 PROF_ITERS=1 python -m color_neus_torch.tools.profile_step --device cpu

Each piece's median ms over PROF_ITERS calls (default 10) after 2
untimed ones, each call between CUDA events (the host clock on the CPU).
Prints one JSON line with JAX's keys, n_rays and the card's name and
power limit.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from color_neus_torch import pin_precision
from color_neus_torch.models import neus
from color_neus_torch.models import trainer as TR
from color_neus_torch.ops.kernels.sdf_rays import resolve_sdf_sweep_fn
from color_neus_torch.ops.rays import near_far_from_sphere
from color_neus_torch.tools import parse_device, print_report
from color_neus_torch.tools._timing import median_ms
from color_neus_torch.tools.bench_step import N_CAMS, bench_config, bench_data

S = 512


def render_loss(r: dict, rgb_gt, n_total: int):
    """JAX's profile loss (profile_step.py:144-151) on render_rays_train's
    outputs: colour MSE + 0.1 eikonal + 0.1 -mean log(1 - clipped weight
    sum) + the squared mean of delta (its per-ray sums over R S 3 values)."""
    rgb = torch.mean((r["color_fine"] - rgb_gt) ** 2)
    ws = torch.clamp(r["weight_sum"].squeeze(-1), 1e-3, 1 - 1e-3)
    m = -torch.mean(torch.log(1 - ws))
    rel = (torch.sum(r["delta_sum"]) / (r["delta_sum"].shape[0] * n_total * 3)) ** 2
    return rgb + 0.1 * r["gradient_error"] + 0.1 * m + rel


def run(n_rays: int, iters: int, device) -> dict:
    pin_precision()
    cfg = bench_config(n_rays)
    rcfg = cfg.renderer
    rcfg_on = dataclasses.replace(rcfg, fused_core="on")
    g = torch.Generator(device=device).manual_seed(0)
    state = TR.init_state(cfg, g, device, init_focal_np=np.asarray([1.2 * 256, 1.2 * 256]))
    params = state.params["renderer"]

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    rng = np.random.RandomState(0)
    d = rng.randn(n_rays, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays_o = t(-2.4 * d + 0.05 * rng.randn(n_rays, 3))
    rays_d = t(d)
    near, far = near_far_from_sphere(rays_o, rays_d)
    rgb_gt = t(rng.rand(n_rays, 3))
    pts = t(rng.randn(n_rays * S, 3) * 0.5)
    dirs = rays_d.repeat_interleave(S, dim=0).contiguous()
    scene, images, masks = bench_data(device)
    lw = [t(rng.randn(n_rays * S, k)) for k in (1, 3, 3, 3, 3)]
    leaves = list(params.parameters())

    def ms(fn):
        return median_ms(fn, device, iters=iters)

    out = {}
    # 1) the full train step, one step a call, uncaptured
    gen = torch.Generator(device=device).manual_seed(1)
    out["train_step_ms"] = ms(lambda: TR.full_data_step(state, scene, cfg, images, masks,
                                                        N_CAMS, gen))

    # 2) the point pipeline's forward + backward (rows 5 + 6), then row 5 alone
    def pp_loss_grad():
        outs = neus.eval_point_pipeline(params, rcfg_on, pts, dirs)
        loss = sum(torch.sum(w * o) for w, o in zip(lw, outs))
        return torch.autograd.grad(loss, leaves, allow_unused=True)

    out["pipeline_fwd_bwd_ms"] = ms(pp_loss_grad)

    @torch.no_grad()
    def pp_fwd():
        return neus.eval_point_pipeline(params, rcfg_on, pts, dirs)[0]

    out["pipeline_fwd_ms"] = ms(pp_fwd)

    # 3) the hierarchy alone, its sweeps on row 1
    g2 = torch.Generator(device=device).manual_seed(2)

    def hier():
        sweep = resolve_sdf_sweep_fn(params["sdf"], rcfg.sdf, rcfg.fused_sdf,
                                     dtype=rcfg.sweep_dtype, act=rcfg.sweep_activation)
        return neus.hierarchical_z_vals(params, rcfg, rays_o, rays_d, near, far,
                                        generator=g2, sdf_rays_fn=sweep)

    out["hierarchy_ms"] = ms(hier)

    # 4) the render forward
    @torch.no_grad()
    def fwd():
        return neus.render_rays(params, rcfg, rays_o, rays_d, near, far,
                                generator=g2)["color_fine"]

    out["render_fwd_ms"] = ms(fwd)

    # 5) the render + loss forward and backward (no sampling, no optimiser)
    n_total = rcfg.n_samples + rcfg.n_importance

    def loss_grad():
        r = neus.render_rays_train(params, rcfg, rays_o, rays_d, near, far, generator=g2)
        return torch.autograd.grad(render_loss(r, rgb_gt, n_total), leaves,
                                   allow_unused=True)

    out["render_loss_bwd_ms"] = ms(loss_grad)

    out["residual_step_minus_lossgrad_ms"] = out["train_step_ms"] - out["render_loss_bwd_ms"]
    out["residual_lossgrad_minus_pieces_ms"] = (
        out["render_loss_bwd_ms"] - out["pipeline_fwd_bwd_ms"] - out["hierarchy_ms"])
    out = {k: round(v, 2) for k, v in out.items()}
    out["n_rays"] = n_rays
    return out


def main(argv=None) -> dict:
    device = parse_device(argv, "decomposition of the bench step's time")
    return print_report(run(int(os.environ.get("PROF_N_RAYS", 2048)),
                            int(os.environ.get("PROF_ITERS", 10)), device), device)


if __name__ == "__main__":
    main()
