#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (color_neus_torch) on one card.

    python3 chip_smoke.py

Phases; any failure exits non-zero and prints no result:
  1. device and build: the card's name and power limit; nvcc builds every
     kernel of the main path from color_neus_torch/csrc (all at once).
  2. kernels against their plain PyTorch versions, on the card: the SDF
     placement sweep (csrc/sdf_rays.cu), through the sweep function the
     main path uses, at a full-width SDF (8x256, multires 6) taken off its
     geometric init by seeded noise on every leaf (geometric init zeroes
     the PE columns of lin0 and of the skip layer, which would hide a
     misread of them), 1024 rays x 64 sorted z, in all four variants
     (softplus/relu x bf16/f32), plus the up-sample-round shape (S=16) and
     a ragged tail; times kernel and plain version with CUDA events.
  3. the main path: TrainLoop trains Color-NeuS at full width (the MODEL
     section of config/Color_NeuS_dtu.yml: 1024 rays, 64+64 samples, 4
     up-sample rounds) on the synthetic sphere (DATASET, DATA_PRESET and
     TRAIN of config/Color_NeuS_synthetic.yml) for 60 steps. The sweep
     kernel must launch exactly 4 times per step, every loss must be
     finite, and the mean of the last 5 losses must be below half the
     mean of the first 5.
  4. the sweep kernel against its plain version on the trained weights,
     at every sweep of one step: the main path's own rays (sampled pixels
     of the training cameras) and z (coarse, then each up-sample round),
     timed with CUDA events; these are the kernel line's numbers.
  5. where the step's time goes: torch.profiler over a few steps; device
     busy time is the union of the trace's kernel intervals, and the idle
     share is read from the same trace (1 - busy / span).
The last lines are one JSON object per kernel list, the card's name and
power limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

SEED = 0
STEPS = 60
SWEEPS_PER_STEP = 4
# H100 SXM peaks (NVIDIA data sheet, dense): the bound of each kernel
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# kernel vs plain tolerances, set from the H100's readings (PERF.md) with
# headroom. f32: summation order only (read <= 3e-7). bf16: a layer input
# that rounds to the other neighbouring bf16 value after a different f32
# summation order moves the next layer by one bf16 ulp (2^-8 relative) of
# that input, and such flips propagate (read <= 1.94e-3 in phase 2, and
# <= 3.03e-3 in phase 4 on the trained weights and the main path's rays).
ATOL = {"float32": 2e-6, "bfloat16": 3e-3}
ATOL_MAIN_PATH = 5e-3

# MODEL of config/Color_NeuS_dtu.yml; DATASET, DATA_PRESET and TRAIN of
# config/Color_NeuS_synthetic.yml (the DTU scan is not in the repo, and
# DTU's WARM_UP of 5000 would keep lr near 0 for all 60 steps). Written
# out so the run needs no PyYAML; tests/test_torch_package.py holds it
# equal to the YAML sections.
SMOKE_CFG = {
    "DATASET": {"TYPE": "Synthetic", "N_IMGS": 8, "H": 64, "W": 64, "SPHERE_RADIUS": 0.5},
    "DATA_PRESET": {"FX_ONLY": False, "INCLUDE_MASK": True, "OPENGL_SYS": False},
    "MODEL": {
        "TYPE": "NeuS_Trainer", "PRETRAINED": None, "N_RAYS": 1024, "EVAL_RAY_SIZE": 1024,
        "NORMALIZE_DIR": True, "FOCAL_ORDER": 2, "LEARN_FOCAL": False, "LEARN_R": False,
        "LEARN_T": False, "MASK_RATE": [0.5, 0.8], "POSE_MODE": "6d",
        "RENDERER": {
            "TYPE": "Color_NeuS", "EXTRACT_SPARSE": True, "N_SAMPLES": 64,
            "N_IMPORTANCE": 64, "UP_SAMPLE_STEPS": 4, "PERTURB": 1.0,
            "SDF": {"D_IN": 3, "D_OUT": 257, "D_HIDDEN": 256, "N_LAYERS": 8, "SKIP_IN": [4],
                    "MULTIRES": 6, "BIAS": 0.5, "SCALE": 3.0, "GEOMETRIC_INIT": True,
                    "WEIGHT_NORM": True, "INSIDE_OUTSIDE": False},
            "COLOR": {"D_FEATURE": 256, "MODE": "no_view_dir", "D_IN": 6, "D_OUT": 3,
                      "D_HIDDEN": 256, "N_LAYERS": 4, "WEIGHT_NORM": True,
                      "MULTIRES_VIEW": 0, "SQUEEZE_OUT": True},
            "RELIGHT": {"D_IN": 6, "D_OUT": 3, "D_HIDDEN": 256, "N_LAYERS": 4,
                        "Y_IN_LAYER": 3, "MULTIRES_VIEW": 4, "INCLUDE_GRAD": True,
                        "INV_SIGMOID": True},
            "DEVIATION": {"INIT_VAL": 0.3},
        },
        "LOSS": {"RGB_LOSS_TYPE": "mse", "LAMBDA_FINE": 1.0, "LAMBDA_EIKONAL": 0.1,
                 "LAMBDA_MASK": 0.1, "LAMBDA_RELIGHT": 1.0},
    },
    "TRAIN": {
        "BATCH_SIZE": 8, "ITERATIONS": 500,
        "OPTIMIZE": {"TYPE": "adam", "LR": 0.0005, "SCHEDULER_TYPE": "NEUS", "WARM_UP": 50,
                     "LR_ALPHA": 0.05},
        "LOG_INTERVAL": 10, "SAVE_INTERVAL": 250, "VIZ_IMAGE_INTERVAL": 250,
        "VIZ_MESH_INTERVAL": 250, "MANUAL_SEED": 1, "CONV_REPEATABLE": True,
        "GRAD_CLIP_ENABLED": True, "GRAD_CLIP": {"TYPE": 2, "NORM": 1.0},
    },
}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=20, warmup=3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sweep_inputs(R, S, device, seed):
    """Rays toward the unit sphere and sorted z in [near, far]."""
    import torch
    from color_neus_torch.ops.rays import near_far_from_sphere
    g = torch.Generator(device=device).manual_seed(seed)
    d = torch.randn((R, 3), generator=g, device=device)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    o = -2.2 * d + 0.1 * torch.randn((R, 3), generator=g, device=device)
    near, far = near_far_from_sphere(o, d)
    t = torch.sort(torch.rand((R, S), generator=g, device=device), dim=-1).values
    z = near[:, None] + (far - near)[:, None] * t
    return o.contiguous(), d.contiguous(), z.contiguous()


def off_geometric_init(params, generator, scale=0.02):
    """Seeded noise on every leaf, so every weight of the net matters."""
    import torch
    with torch.no_grad():
        for p in params.parameters():
            p.add_(scale * torch.randn(p.shape, generator=generator, device=p.device))
    return params


def sweep_bound_ms(sw, R, S):
    """Least time for one sweep and what sets it: the larger of its bytes
    (inputs read once, output written once) over the memory rate and its
    MACs (the network's real widths) over the peak of the dot type."""
    n = R * S
    macs = sum(w.shape[0] * w.shape[1] for w, _ in sw.layers)
    nbytes = (2 * R * 3 + n + n) * 4 + sw.packed.numel() * sw.packed.element_size() \
        + sw.bias.numel() * 4
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, 2 * macs * n / PEAK_FLOPS[sw.dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def main_path_sweeps(loop, seed):
    """Phase 4: run the hierarchy of one step on the trained weights and
    the main path's rays, holding each sweep's kernel output against the
    plain version on the same rays and z; returns one record per sweep."""
    import torch
    from color_neus_torch.models import trainer as TR
    from color_neus_torch.models.neus import hierarchical_z_vals
    from color_neus_torch.ops.kernels.sdf_rays import (
        make_fused_sdf_rays_fn, resolve_sdf_sweep_fn, sdf_rays_plain)

    st, tcfg = loop.state, loop.tcfg
    rcfg = tcfg.renderer
    g = torch.Generator(device=loop.device).manual_seed(seed)
    img_ids = torch.arange(min(loop.batch_size, loop.n_imgs), device=loop.device)
    images = loop.images[img_ids]
    masks = loop.masks[img_ids] if loop.masks is not None else None
    sweeps = []
    with torch.no_grad():
        cam_sel, py, px, _ = TR.sample_pixels(tcfg, images, masks, st.step, g)
        rays_o, rays_d, near, far = TR.pixel_rays(st.params, loop.scene, tcfg, images,
                                                  img_ids, cam_sel, py, px)
        renderer = st.params["renderer"]
        fn = resolve_sdf_sweep_fn(renderer["sdf"], rcfg.sdf, rcfg.fused_sdf,
                                  dtype=rcfg.sweep_dtype, act=rcfg.sweep_activation)
        # the relu variant on the same data: its time does not depend on the
        # values, so the difference is what the softplus epilogue costs here
        relu_fn = make_fused_sdf_rays_fn(renderer["sdf"], rcfg.sdf, dtype=rcfg.sweep_dtype,
                                         act="relu")

        def checked(o, d, z):
            got = fn(o, d, z)
            o, d, z = o.contiguous(), d.contiguous(), z.contiguous()
            want = sdf_rays_plain(fn.weights, o, d, z)
            R, S = z.shape
            check(got.shape == (R, S) and bool(torch.isfinite(got).all()),
                  f"main-path sweep S={S}: bad output {tuple(got.shape)}")
            bound, bound_by = sweep_bound_ms(fn.weights, R, S)
            sweeps.append({"R": R, "S": S, "err": float((got - want).abs().max()),
                           "ms": cuda_ms(lambda: fn(o, d, z)),
                           "plain_ms": cuda_ms(lambda: sdf_rays_plain(fn.weights, o, d, z)),
                           "relu_ms": cuda_ms(lambda: relu_fn(o, d, z)),
                           "bound_ms": bound, "bound_by": bound_by})
            return got

        hierarchical_z_vals(renderer, rcfg, rays_o, rays_d, near, far, generator=g,
                            sdf_rays_fn=checked)
    return fn.weights.dtype, sweeps


def _union_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, cur = 0.0, None
    for s, e in sorted(intervals):
        if cur is None or s > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    return total + (cur[1] - cur[0] if cur else 0.0)


def profile_steps(loop, n_steps=3, top=12):
    """Phase 5: device time by kernel, busy time and idle share over a few
    steady-state steps, all read from one torch.profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        loop.run(loop.state.step + n_steps)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    dev = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", ""))
           for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not dev:
        print("[5] the profiler trace holds no device events: time by kernel not measured")
        return
    busy = _union_us([(s, e) for s, e, _ in dev]) / 1e3
    span = (max(e for _, e, _ in dev) - min(s for s, _, _ in dev)) / 1e3
    print(f"[5] profiled window: {wall_ms / n_steps:.2f} ms/step host clock (profiler on) | "
          f"device span {span / n_steps:.2f} ms/step | busy {busy / n_steps:.2f} ms/step | "
          f"idle share {1 - busy / span:.4f} of the span", flush=True)
    by_name = {}
    for s, e, name in dev:
        t, c = by_name.get(name, (0.0, 0))
        by_name[name] = (t + (e - s) / 1e3, c + 1)
    total = sum(t for t, _ in by_name.values())
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"[5]   {t / total * 100:5.1f}%  {t / n_steps:8.3f} ms/step  "
              f"{c // n_steps:4d}x  {name[:90]}")
    sweep = sorted((e - s) / 1e3 for s, e, name in dev if "sdf_rays_" in name)
    print(f"[5] sweep kernel launches in the trace (ms each, sorted): "
          f"{' '.join(f'{x:.4f}' for x in sweep)}", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: needs a CUDA card",
              file=sys.stderr)
        return 2
    from color_neus_torch import pin_precision
    from color_neus_torch.models.configs import SDFConfig
    from color_neus_torch.models.fields import init_sdf
    from color_neus_torch.ops.kernels import build
    from color_neus_torch.ops.kernels.sdf_rays import (
        KERNEL, launch_sdf_rays, make_fused_sdf_rays_fn, sdf_rays_plain)
    from color_neus_torch.runtime import TrainLoop
    from color_neus_torch.utils.config import config_from_dict

    pin_precision()
    device = torch.device("cuda")
    card = card_line()
    print(f"[1] device: {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # ---- phase 1: build every kernel of the main path, all at once ----
    t0 = time.perf_counter()
    build.build([KERNEL])
    print(f"[1] built {KERNEL} in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in build.build_log(KERNEL).splitlines():
        if "registers" in line or "spill" in line:
            print(f"[1] ptxas: {line.strip()}")

    # ---- phase 2: kernel vs plain on the card, off geometric init ----
    g = torch.Generator(device=device).manual_seed(SEED)
    sdf_cfg = SDFConfig()
    sdf_params = off_geometric_init(init_sdf(sdf_cfg, g, device), g)
    cases = [(act, dt, 1024, 64) for act in ("softplus", "relu")
             for dt in ("bfloat16", "float32")]
    cases += [("softplus", "bfloat16", 1024, 16), ("softplus", "bfloat16", 1000, 37)]
    for i, (act, dt, R, S) in enumerate(cases):
        fn = make_fused_sdf_rays_fn(sdf_params, sdf_cfg, dtype=dt, act=act)
        o, d, z = sweep_inputs(R, S, device, SEED + 1 + i)
        with torch.no_grad():
            before = launch_sdf_rays.launches
            got = fn(o, d, z)
            torch.cuda.synchronize()
            check(launch_sdf_rays.launches == before + 1,
                  f"sweep {act}/{dt}: the sweep function did not launch the kernel")
            want = sdf_rays_plain(fn.weights, o, d, z)
        check(got.shape == (R, S) and bool(torch.isfinite(got).all()),
              f"sweep {act}/{dt} R={R} S={S}: bad output {tuple(got.shape)}")
        err = float((got - want).abs().max())
        with torch.no_grad():
            ms = cuda_ms(lambda: fn(o, d, z))
            plain_ms = cuda_ms(lambda: sdf_rays_plain(fn.weights, o, d, z))
        bound, _ = sweep_bound_ms(fn.weights, R, S)
        print(f"[2] sdf_rays {act:8s} {dt:8s} R={R} S={S}: |out| max {float(want.abs().max()):.3f} | "
              f"max|kernel-plain| {err:.3e} (atol {ATOL[dt]:g}) | kernel {ms:.4f} ms | "
              f"plain {plain_ms:.4f} ms | bound {bound:.4f} ms", flush=True)
        check(err <= ATOL[dt], f"sweep {act}/{dt} R={R} S={S}: max error {err:.3e} "
                               f"above {ATOL[dt]:g}")

    # ---- phase 3: the main path ----
    cfg = config_from_dict(SMOKE_CFG)
    loop = TrainLoop(cfg, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launch_sdf_rays.launches = 0
    t0 = time.perf_counter()
    losses = loop.run(STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_sdf_rays.launches
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(x) for x in losses]
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    print(f"[3] {STEPS} steps: {wall * 1e3 / STEPS:.2f} ms/step incl. first step | "
          f"loss {first:.5f} -> {last:.5f} | sweep launches {launches} | "
          f"peak memory {peak_gb:.2f} GiB", flush=True)
    check(launches == SWEEPS_PER_STEP * STEPS,
          f"sweep kernel launched {launches} times, want {SWEEPS_PER_STEP * STEPS}")
    check(all(x == x and abs(x) != float("inf") for x in losses), f"non-finite loss {losses}")
    check(last < 0.5 * first, f"loss did not halve: first-5 mean {first}, last-5 mean {last}")

    # steady state, after the checked run
    n_rays = loop.tcfg.n_rays
    n_spp = loop.tcfg.renderer.n_samples + loop.tcfg.renderer.n_importance
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop.run(STEPS + 20)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 20
    print(f"[3] steady state: {step_ms:.2f} ms/step | {n_rays / step_ms * 1e3:.0f} rays/s "
          f"(fwd+bwd, {n_rays} rays x {n_spp} samples)", flush=True)

    # ---- phase 4: kernel vs plain on the trained weights, main-path rays and z ----
    dt, sweeps = main_path_sweeps(loop, SEED + 100)
    check(len(sweeps) == SWEEPS_PER_STEP,
          f"one step's hierarchy ran {len(sweeps)} sweeps, want {SWEEPS_PER_STEP}")
    for sw in sweeps:
        atol = ATOL_MAIN_PATH if dt == "bfloat16" else ATOL[dt]
        print(f"[4] main-path sweep R={sw['R']} S={sw['S']} {dt}: max|kernel-plain| "
              f"{sw['err']:.3e} (atol {atol:g}) | kernel {sw['ms']:.4f} ms "
              f"(relu variant {sw['relu_ms']:.4f} ms) | plain {sw['plain_ms']:.4f} ms | "
              f"bound {sw['bound_ms']:.4f} ms", flush=True)
        check(sw["err"] <= atol, f"main-path sweep S={sw['S']}: max error "
                                 f"{sw['err']:.3e} above {atol:g}")
    step_sweep = {k: sum(sw[k] for sw in sweeps) for k in ("ms", "plain_ms", "bound_ms")}
    print(f"[4] one step's {len(sweeps)} sweeps: kernel {step_sweep['ms']:.4f} ms | "
          f"plain {step_sweep['plain_ms']:.4f} ms | bound {step_sweep['bound_ms']:.4f} ms",
          flush=True)

    # ---- phase 5: where the step's time goes ----
    profile_steps(loop)

    # the kernel line: one step's sweeps (every launch of a step), phase 4
    kernels = [{
        "name": "sdf_rays", "route": "cuda", "source": "color_neus_torch/csrc/sdf_rays.cu",
        "replaces": "color_neus_tpu/ops/pallas/sdf_mlp.py:203", "launches": launches,
        "max_abs_err": max(sw["err"] for sw in sweeps), "ms": step_sweep["ms"],
        "plain_ms": step_sweep["plain_ms"], "bound_ms": step_sweep["bound_ms"],
        "bound_by": sweeps[0]["bound_by"], "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        rc = 1
    sys.exit(rc)
