"""Render-side evaluation: PSNR / SSIM of rendered views against the
dataset's images, the port of tools/eval_views.py.

Loads a checkpoint of the port (--reload), renders every dataset view (or
--n evenly spaced ones) with the training config's renderer, masks render
and ground truth by the view's mask where the dataset has masks (the
reference's protocol), and prints one JSON line with JAX's keys: per-view
and mean PSNR / SSIM.

    python -m color_neus_torch.tools.eval_views --cfg config/Color_NeuS_dtu.yml -obj 83 \\
        --data_root $DATA_ROOT --reload exp/.../checkpoints/state.npz \\
        [--n 5] [--out reports/torch/dtu83_views.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from color_neus_torch.models import trainer as TR
from color_neus_torch.runtime import TrainLoop
from color_neus_torch.tools import platform_name
from color_neus_torch.utils.config import get_config
from color_neus_torch.utils.metrics import mse2psnr, ssim

# view v renders with a generator seeded VIEW_SEED * 1_000_003 + v (JAX
# folds v into PRNGKey(7))
VIEW_SEED = 7


def parse_args(argv=None):
    p = argparse.ArgumentParser("color_neus_torch render-side eval")
    p.add_argument("--cfg", type=str, required=True)
    p.add_argument("-obj", "--obj_id", type=str, default=None)
    p.add_argument("--reload", type=str, required=True, help="checkpoint npz")
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--n", type=int, default=0,
                   help="render only N evenly-spaced views (0 = all)")
    p.add_argument("--out", type=str, default=None, help="also write JSON here")
    p.add_argument("-b", "--batch_size", type=int, default=None)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' for the plain path)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    arg = parse_args(argv)
    cfg = get_config(arg.cfg, arg)   # --reload -> MODEL.PRETRAINED
    loop = TrainLoop(cfg, device=arg.device)
    ids = np.arange(loop.n_imgs)
    if arg.n and arg.n < loop.n_imgs:
        ids = np.unique(np.linspace(0, loop.n_imgs - 1, arg.n).astype(int))

    views = []
    for cam_id in ids:
        g = torch.Generator(device=loop.device).manual_seed(VIEW_SEED * 1_000_003 + int(cam_id))
        rgb, _depth = TR.render_image(loop.state.params, loop.scene, loop.tcfg, int(cam_id),
                                      loop.H, loop.W, g)
        gt = loop.images[cam_id].cpu().numpy()
        rgbc = np.clip(rgb, 0.0, 1.0)
        if loop.masks is not None:
            # the reference's protocol: masked regions carry GT * mask
            m = loop.masks[cam_id].cpu().numpy()[..., None]
            rgbc, gt = rgbc * m, gt * m
        views.append({"cam": int(cam_id),
                      "psnr": round(mse2psnr(float(np.mean((rgbc - gt) ** 2))), 3),
                      "ssim": round(float(ssim(rgbc, gt)), 5)})

    rep = {
        "checkpoint": arg.reload,
        "n_views": len(views),
        "psnr_mean": round(float(np.mean([v["psnr"] for v in views])), 3),
        "ssim_mean": round(float(np.mean([v["ssim"] for v in views])), 5),
        "platform": platform_name(loop.device),
        "views": views,
    }
    print(json.dumps(rep))
    if arg.out:
        os.makedirs(os.path.dirname(arg.out) or ".", exist_ok=True)
        with open(arg.out, "w") as f:
            json.dump(rep, f, indent=1)
    return rep


if __name__ == "__main__":
    main()
