"""The bench step: the port of bench.py's build_bench / time_step
(bench.py:43-153), the training step the benchmark and the A/B,
decomposition and trace tools time.

    from color_neus_torch.tools.bench_step import build_bench, time_step
    step_fn, args, flops = build_bench(2048, 10)      # on the card
    seconds = time_step(step_fn, args, rounds=3)      # per call of 10 steps

The workload is JAX's: full-width Color-NeuS (SDF 8 x 256 multires 6,
colour no_view_dir with d_in 6 and multires_view 0, relight 4 x 256),
256 + 256 samples a ray in 4 up-sample rounds, 8 cameras of 256 x 256
RandomState(0) noise images with a disc mask, mask_rate (0.5, 0.8), pose
6d, the loss with the eikonal, mask and relight terms, the per-leaf clip
and Adam; k_steps steps a call through trainer.make_train_multi_step (on
the card one replay of a captured CUDA graph after a warm-up bundle and
the capture; on the CPU a loop). The state advances in place at every
call (a step's time does not depend on it).

fused_march defaults to 'on' and march_acts to 'save': JAX's bench runs
the fused march because its fused_march 'auto' resolves to on on the TPU,
while the port's 'auto' stays on the plain core (configs.py), which at
2048 x 512 takes 45.6 GiB and ~426 ms a step. march_tile and thin_dots
are TPU keys the port does not read (configs._UNPORTED_KEYS): anything
but JAX's default raises. flops_per_step is the port's own count, at the
networks' real widths (ray_march.march_macs_per_point for the march's
forward and backward, the sweeps' SDF layers for the hierarchy), not
JAX's, which counts the padded MXU products. Nothing is printed: the
benchmark's metric line is not this module's.
"""

from __future__ import annotations

import copy
import time

import numpy as np
import torch

from color_neus_torch import pin_precision, resolve_device
from color_neus_torch.models import trainer as TR
from color_neus_torch.models.camera import CameraConfig
from color_neus_torch.models.configs import _UNPORTED_KEYS, ColorConfig, RendererConfig
from color_neus_torch.ops.kernels import point_pipeline as PP
from color_neus_torch.ops.kernels.ray_march import march_macs_per_point, resolve_save_acts
from color_neus_torch.ops.kernels.sdf_rays import resolve_sweep_weights

H = W = 256
N_CAMS = 8
INIT_SEED, STEP_SEED = 0, 1   # JAX's PRNGKey(0) for the weights, PRNGKey(1) for the steps


def bench_config(n_rays: int, *, ray_chunk=0, march_acts="save", sweep_act="softplus",
                 bwd_prec="f32stash", fused_march="on", fused_core="auto", march_tile=0,
                 thin_dots="hilo") -> TR.TrainerConfig:
    """bench.py's TrainerConfig, with the port's fused_march / fused_core."""
    for key, v in (("MARCH_TILE", march_tile), ("THIN_DOTS", thin_dots)):
        if v != _UNPORTED_KEYS[key]:
            raise NotImplementedError(f"{key.lower()}={v!r}: a TPU key the port does not "
                                      f"read (JAX's default {_UNPORTED_KEYS[key]!r})")
    rcfg = RendererConfig(
        kind="color_neus", n_samples=256, n_importance=256, up_sample_steps=4,
        ray_chunk=ray_chunk, march_acts=march_acts, sweep_activation=sweep_act,
        march_bwd_precision=bwd_prec, fused_march=fused_march, fused_core=fused_core,
        color=ColorConfig(mode="no_view_dir", d_in=6, multires_view=0))
    return TR.TrainerConfig(
        n_rays=n_rays, include_mask=True, mask_rate=(0.5, 0.8), iterations=100000,
        warm_up=5000, camera=CameraConfig(H=H, W=W, n_cams=N_CAMS, pose_mode="6d"),
        renderer=rcfg)


def bench_data(device):
    """(scene, images [8, 256, 256, 3], masks [8, 256, 256]) as bench.py
    draws them from RandomState(0): cameras at radius 2.5 looking at the
    origin, uniform noise images, a disc mask of radius H / 3."""
    rng = np.random.RandomState(0)
    poses = np.tile(np.eye(4, dtype=np.float32), (N_CAMS, 1, 1))
    for i in range(N_CAMS):
        z = rng.randn(3)
        z /= np.linalg.norm(z)
        poses[i, :3, 3] = -2.5 * z
        # look-at rotation: the camera's z axis toward the origin
        up = (np.asarray([0.0, 0.0, 1.0]) if abs(z[2]) < 0.9
              else np.asarray([0.0, 1.0, 0.0]))
        x = np.cross(up, z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        poses[i, :3, :3] = np.stack([x, y, z], axis=1)
    scene = TR.make_scene(np.zeros(3), 1.0, poses, device)
    images = torch.as_tensor(rng.rand(N_CAMS, H, W, 3).astype(np.float32), device=device)
    yy, xx = np.mgrid[0:H, 0:W]
    blob = (((yy - H / 2) ** 2 + (xx - W / 2) ** 2) < (H / 3) ** 2).astype(np.float32)
    masks = torch.as_tensor(np.tile(blob[None], (N_CAMS, 1, 1)), device=device)
    return scene, images, masks


def flops_per_step(cfg: TR.TrainerConfig, params) -> int:
    """2 x the multiply-adds of one optimiser step's model products at the
    networks' real widths: the march's forward and backward on every
    sample (ray_march.march_macs_per_point, in the backward mode
    march_acts resolves to at this shape) and the hierarchy's SDF sweeps
    (the coarse samples and every up-sample round's but the last, the
    last layer's sdf row only). Elementwise work is not counted."""
    rcfg = cfg.renderer
    cpu = copy.deepcopy(params).to("cpu")
    pw = PP.resolve_pipeline_weights(cpu, rcfg)
    s_total = rcfg.n_samples + rcfg.n_importance
    save = resolve_save_acts(rcfg.march_acts, rcfg, cfg.n_rays * s_total,
                             rcfg.march_stash_budget_gb)
    fwd, bwd = march_macs_per_point(pw, save)
    sweep = sum(w.shape[0] * w.shape[1]
                for w, _ in resolve_sweep_weights(cpu["sdf"], rcfg.sdf).layers)
    sweep_pts = rcfg.n_samples + (rcfg.up_sample_steps - 1) * (
        rcfg.n_importance // rcfg.up_sample_steps)
    return 2 * cfg.n_rays * (s_total * (fwd + bwd) + sweep_pts * sweep)


def build_bench(n_rays: int, k_steps: int, *, ray_chunk=0, march_acts="save",
                sweep_act="softplus", bwd_prec="f32stash", fused_march="on",
                fused_core="auto", march_tile=0, thin_dots="hilo", device=None):
    """The bench step: (step_fn, (state, scene, images, masks, generator),
    flops_per_step). step_fn(state, scene, images, masks, generator) runs
    k_steps optimiser steps (trainer.MultiStep; step_fn.cfg is the
    TrainerConfig) and returns (state, aux of the last step, the losses
    [k_steps]). The weights come from a generator seeded 0, the steps draw
    from `generator` (seeded 1). device: the card unless 'cpu'."""
    pin_precision()
    device = resolve_device(device)
    cfg = bench_config(n_rays, ray_chunk=ray_chunk, march_acts=march_acts,
                       sweep_act=sweep_act, bwd_prec=bwd_prec, fused_march=fused_march,
                       fused_core=fused_core, march_tile=march_tile, thin_dots=thin_dots)
    g = torch.Generator(device=device).manual_seed(INIT_SEED)
    state = TR.init_state(cfg, g, device, init_focal_np=np.asarray([1.2 * W, 1.2 * W]))
    scene, images, masks = bench_data(device)
    step_fn = TR.make_train_multi_step(cfg, N_CAMS, N_CAMS, k_steps)
    flops = flops_per_step(cfg, state.params["renderer"])
    gen = torch.Generator(device=device).manual_seed(STEP_SEED)
    return step_fn, (state, scene, images, masks, gen), flops


def call(step_fn, args) -> float:
    """One call of step_fn, ended by a host read of its loss (a sync);
    returns that loss."""
    _state, aux, _losses = step_fn(*args)
    return float(aux["loss"])


def time_step(step_fn, args, rounds: int) -> list:
    """One untimed call (on the card the warm-up bundle and the capture),
    then `rounds` timed calls: host seconds per call (k_steps steps), each
    ended by a host read of the loss."""
    call(step_fn, args)
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        call(step_fn, args)
        times.append(time.perf_counter() - t0)
    return times
