"""Trained-quality gate: the port of tools/quality_gate.py, one JSON verdict.

Trains Color-NeuS on the analytic sphere (config/Color_NeuS_synthetic.yml;
QG_SCENE=blob: the textured non-convex blob of
config/Color_NeuS_synthetic_blob.yml) for QG_STEPS steps (default 1000)
through the port's TrainLoop, then

  * renders camera 0 (a seeded generator) and computes PSNR / SSIM
    against the analytic ground truth,
  * extracts the QG_RES^3 mesh (default 128) in world space and measures
    the mean and p95 of |r - 0.5| at its vertices (the sphere), or of the
    analytic |blob_sdf| (the blob),

and prints JAX's verdict dict, with JAX's thresholds (`thresholds`):
the sphere at >= 1000 steps PSNR >= 34.0 dB and mean radial error <=
0.027 (30.5 / 0.033 below), the blob 32.5 / 0.019 (26.0 / 0.025).

    python -m color_neus_torch.tools.quality_gate               # on the card
    QG_STEPS=200 QG_RES=64 python -m color_neus_torch.tools.quality_gate --device cpu

The knobs are JAX's: QG_FUSED sets FUSED_MARCH, FUSED_CORE and FUSED_SDF
('' keeps the config's auto: on the port the plain core under grad; JAX's
TPU "fused" anchors are QG_FUSED=on), QG_PREC MARCH_BWD_PRECISION,
QG_SWEEP_ACT SWEEP_ACTIVATION, QG_SWEEP_DTYPE SWEEP_DTYPE, QG_SEED
TRAIN.MANUAL_SEED, QG_VIZ_EVERY the validation image and mesh cadence
(default max(250, steps // 4)). QG_MATMUL: the port's products are
always f32 with TF32 off (pin_precision), JAX's "highest"; the verdict
says so, and any other value raises. The run records into
exp/quality_gate_<steps>_<tag>_<timestamp>/ of the working directory;
WRITE_REPORT=1 also writes reports/torch/quality_gate.json.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from color_neus_torch.data.synthetic import blob_sdf
from color_neus_torch.models import trainer as TR
from color_neus_torch.runtime import TrainLoop
from color_neus_torch.tools import platform_name
from color_neus_torch.utils.config import config_from_dict, get_config
from color_neus_torch.utils.metrics import mse2psnr, ssim

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIGS = {"sphere": os.path.join(REPO, "config", "Color_NeuS_synthetic.yml"),
           "blob": os.path.join(REPO, "config", "Color_NeuS_synthetic_blob.yml")}
# the held-out view and the seed of its generator (JAX's PRNGKey(7))
VIEW, VIEW_SEED = 0, 7


def thresholds(scene: str, steps: int) -> tuple:
    """(PSNR min, mean surface error max): JAX's table
    (quality_gate.py:156-166), calibrated on its own runs."""
    if scene == "blob":
        return (32.5, 0.019) if steps >= 1000 else (26.0, 0.025)
    return (34.0, 0.027) if steps >= 1000 else (30.5, 0.033)


def arm_config(cfg, steps: int, fused: str = "", prec: str = "", sweep_act: str = "",
               sweep_dtype: str = "", seed: int = 0, viz_every: int | None = None):
    """cfg with JAX's gate overrides (quality_gate.py:65-103): ITERATIONS,
    the image / mesh cadence, SAVE_INTERVAL, the seed and the renderer
    knobs that are set."""
    d = cfg.to_dict()
    t, r = d["TRAIN"], d["MODEL"]["RENDERER"]
    viz = max(250, steps // 4) if viz_every is None else viz_every
    t["ITERATIONS"] = steps
    t["VIZ_IMAGE_INTERVAL"] = t["VIZ_MESH_INTERVAL"] = viz
    t["SAVE_INTERVAL"] = max(int(t["SAVE_INTERVAL"]), steps)
    if seed:
        t["MANUAL_SEED"] = seed
    for k, v in (("MARCH_BWD_PRECISION", prec), ("SWEEP_ACTIVATION", sweep_act),
                 ("SWEEP_DTYPE", sweep_dtype)):
        if v:
            r[k] = v
    if fused:
        for k in ("FUSED_MARCH", "FUSED_CORE", "FUSED_SDF"):
            r[k] = fused
    return config_from_dict(d)


def image_metrics(rgb: np.ndarray, gt: np.ndarray) -> tuple:
    """(PSNR, SSIM) of the clipped render against the ground truth."""
    rgbc = np.clip(rgb, 0, 1)
    return (mse2psnr(float(np.mean((rgbc - gt) ** 2))),
            float(ssim(rgbc, np.asarray(gt))))


def surface_error(verts: np.ndarray, scene: str) -> np.ndarray:
    """|r - 0.5| per vertex (the sphere), |analytic blob sdf| (the blob:
    exact outside, conservative across the union's seams)."""
    if scene == "blob":
        return np.abs(blob_sdf(verts))
    return np.abs(np.linalg.norm(verts, axis=1) - 0.5)


def train(cfg, tag: str, device=None) -> TrainLoop:
    """The loop of one arm, trained to TRAIN.ITERATIONS, recording into
    exp/quality_gate_<steps>_<tag>_* of the working directory."""
    loop = TrainLoop(cfg, device=device, exp_id=f"quality_gate_{cfg['TRAIN']['ITERATIONS']}_{tag}",
                     require_clean_git=False)
    loop.run()
    return loop


def judge(loop: TrainLoop, res: int, scene: str, fused: str = "", seed: int = 0) -> dict:
    """JAX's verdict (quality_gate.py:119-187) on a trained loop."""
    steps = loop.state.step
    g = torch.Generator(device=loop.device).manual_seed(VIEW_SEED)
    rgb, _depth = TR.render_image(loop.state.params, loop.scene, loop.tcfg, VIEW, loop.H,
                                  loop.W, g)
    p, s = image_metrics(rgb, loop.images[VIEW].cpu().numpy())
    out = loop.validate_mesh(steps, resolution=res, world_space=True)
    if out is None:
        return {"psnr": round(p, 2), "ssim": round(s, 4), "mesh": "EMPTY", "pass": False}
    verts, tris, _colors = out
    err = surface_error(verts, scene)
    mean_err, p95_err = float(err.mean()), float(np.percentile(err, 95))
    gate_psnr, gate_err = thresholds(scene, steps)
    rr = loop.tcfg.renderer
    return {
        "steps": steps, "resolution": res, "scene": scene, "seed": seed or 1,
        "fused": fused or "auto",
        "march_bwd_precision": rr.march_bwd_precision,
        "thin_dots": loop.cfg["MODEL"]["RENDERER"].get("THIN_DOTS", "hilo"),
        "sweep_activation": rr.sweep_activation,
        "sweep_dtype": rr.sweep_dtype,
        "matmul_precision": "highest",
        "platform": platform_name(loop.device),
        "psnr": round(p, 2), "ssim": round(s, 4),
        "n_verts": int(len(verts)), "n_tris": int(len(tris)),
        "radial_err_mean": round(mean_err, 5),
        "radial_err_p95": round(p95_err, 5),
        "gates": {"psnr_min": gate_psnr, "radial_err_mean_max": gate_err},
        "pass": bool(p >= gate_psnr and mean_err <= gate_err),
    }


def gate(cfg, steps: int = 1000, res: int = 128, scene: str = "sphere", fused: str = "",
         prec: str = "", sweep_act: str = "", sweep_dtype: str = "", seed: int = 0,
         viz_every: int | None = None, device=None) -> dict:
    """Train one arm of `cfg` (a Config) for `steps` and judge it."""
    cfg = arm_config(cfg, steps, fused, prec, sweep_act, sweep_dtype, seed, viz_every)
    tag = "_".join(x for x in (fused or "auto", prec, sweep_act, sweep_dtype,
                               f"s{seed}" if seed else "") if x)
    return judge(train(cfg, tag, device), res, scene, fused, seed)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' for the plain path)")
    arg = p.parse_args(argv)
    matmul = os.environ.get("QG_MATMUL", "")
    if matmul not in ("", "highest"):
        raise ValueError(f"QG_MATMUL={matmul!r}: the port's products are always f32 with "
                         "TF32 off (JAX's 'highest'); it has no other precision to set")
    scene = os.environ.get("QG_SCENE", "sphere")
    viz = os.environ.get("QG_VIZ_EVERY")
    verdict = gate(get_config(CONFIGS[scene]), int(os.environ.get("QG_STEPS", 1000)),
                   int(os.environ.get("QG_RES", 128)), scene, os.environ.get("QG_FUSED", ""),
                   os.environ.get("QG_PREC", ""), os.environ.get("QG_SWEEP_ACT", ""),
                   os.environ.get("QG_SWEEP_DTYPE", ""), int(os.environ.get("QG_SEED", 0)),
                   int(viz) if viz else None, arg.device)
    print(json.dumps(verdict))
    if os.environ.get("WRITE_REPORT"):
        os.makedirs(os.path.join("reports", "torch"), exist_ok=True)
        with open(os.path.join("reports", "torch", "quality_gate.json"), "w") as f:
            json.dump(verdict, f, indent=1)
    return verdict


if __name__ == "__main__":
    main()
