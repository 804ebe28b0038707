"""The blob scene through the DTU on-disk format and the real CLIs: the
port of tools/dtu_blob_e2e.py.

Writes the textured non-convex blob (data/synthetic.py's blob_sdf and
_render_blob) as a DTU scene (cameras_sphere.npz with identity scale
mats, image/ and mask/ PNGs; JAX's 12 views of 96 x 96 on a
pose_spherical orbit, focal 1.2 W), trains it at the synthetic config's
renderer through `python -m color_neus_torch.train` and extracts its
mesh through `python -m color_neus_torch.evaluate -rr DBE_RES`, both as
subprocesses in a temporary directory, then prints JAX's keys:

  * psnr_view0: view 0 rendered from the checkpoint against the
    sphere-traced ground truth,
  * mesh_mean_abs_sdf: mean |analytic sdf| at the mesh vertices,
  * chamfer_vs_analytic: symmetric Chamfer distance between the mesh
    vertices and 30,000 vertices of a 192^3 marching-cubes pass over the
    analytic sdf.

JAX's tool sets no pass threshold, and neither does this one.

    DBE_STEPS=2000 DBE_RES=256 python -m color_neus_torch.tools.dtu_blob_e2e   # on the card
    python -m color_neus_torch.tools.dtu_blob_e2e --device cpu                 # the CLIs too
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from color_neus_torch import resolve_device
from color_neus_torch.data.synthetic import _render_blob, blob_sdf
from color_neus_torch.models import trainer as TR
from color_neus_torch.ops.marching_cubes import extract_geometry_from_grid
from color_neus_torch.ops.mesh import read_ply
from color_neus_torch.ops.transforms import pose_spherical
from color_neus_torch.runtime import TrainLoop
from color_neus_torch.tools import platform_name
from color_neus_torch.tools.dataset_replica import write_dtu
from color_neus_torch.utils.config import get_config
from color_neus_torch.utils.metrics import chamfer_distance, mse2psnr

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OBJ_ID = "901"
# ground-truth surface points the Chamfer distance samples (JAX's)
GT_POINTS = 30000


def write_blob_dtu(root: str, n_imgs: int = 12, H: int = 96, W: int = 96) -> tuple:
    """The blob scene in the DTU on-disk format under root/DTU/dtu_scan901
    (JAX's cameras, dtu_blob_e2e.py:235-266). Returns (root, poses [n,4,4],
    focal [2], (H, W))."""
    f = 1.2 * W
    focal = np.array([f, f], np.float32)
    poses, rgb, mask = [], [], []
    for i in range(n_imgs):
        c2w = pose_spherical(360.0 * i / n_imgs, -35.0 + 25.0 * (i % 3), 3.0)
        c2w[:, 1:3] *= -1  # z forward
        im, m = _render_blob(c2w, focal, H, W)
        poses.append(c2w)
        rgb.append((np.clip(im, 0, 1) * 255).astype(np.uint8))
        mask.append((m * 255).astype(np.uint8))
    poses = np.stack(poses)
    write_dtu(root, OBJ_ID, poses, np.stack(rgb), np.stack(mask), focal, scale=1.0,
              centre=(0.0, 0.0, 0.0))
    return root, poses, focal, (H, W)


def gt_surface_points(res: int = 192) -> np.ndarray:
    """Vertices of a marching-cubes pass over the analytic blob sdf on the
    res^3 lattice of [-0.7, 0.7]^3."""
    ax = np.linspace(-0.7, 0.7, res, dtype=np.float32)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    u = -blob_sdf(np.stack([X, Y, Z], axis=-1))
    v, _t = extract_geometry_from_grid(u, [-0.7] * 3, [0.7] * 3, 0.0)
    return v


def write_config(path: str, data_root: str, steps: int) -> None:
    """config/Color_NeuS_synthetic.yml on the written scene, every
    interval at `steps` (one checkpoint at the end, no mid-run viz)."""
    import yaml
    with open(os.path.join(REPO, "config", "Color_NeuS_synthetic.yml")) as f:
        cfg = yaml.safe_load(f)
    cfg["DATASET"] = {"TYPE": "DTU", "DATA_ROOT": data_root, "OBJ_ID": OBJ_ID}
    for k in ("ITERATIONS", "SAVE_INTERVAL", "VIZ_IMAGE_INTERVAL", "VIZ_MESH_INTERVAL"):
        cfg["TRAIN"][k] = steps
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)


def _cli(args, cwd, device, timeout):
    """python -m <args> in `cwd` with this checkout importable; raises with
    the tail of its output when it fails. Returns its output."""
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    dev = [] if device is None else ["--device", str(device)]
    r = subprocess.run([sys.executable, "-m", *args, *dev], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=timeout)
    if r.returncode != 0:
        raise RuntimeError(f"{' '.join(args[:1])} exited {r.returncode}:\n"
                           f"{r.stdout[-2000:]}{r.stderr[-3000:]}")
    return r.stdout + r.stderr


def run(steps: int = 2000, res: int = 256, workdir: str | None = None, device=None) -> tuple:
    """The whole tool in `workdir` (default a new temporary directory):
    (JAX's report, {"cfg", "checkpoint", "mesh"}: the files it made).
    device None: the CLIs' default, the card."""
    tmp = workdir or tempfile.mkdtemp(prefix="dtu_blob_")
    root, poses, focal, (H, W) = write_blob_dtu(os.path.join(tmp, "data"))
    cfg_path = os.path.join(tmp, "blob_dtu.yml")
    write_config(cfg_path, root, steps)
    log = _cli(["color_neus_torch.train", "--cfg", cfg_path, "--exp_id", "dtu_blob_e2e",
                "--allow_dirty", "--iterations", str(steps)], tmp, device, 7200)
    exps = sorted(glob.glob(os.path.join(tmp, "exp", "dtu_blob_e2e_*")))
    ckpt = os.path.join(exps[-1], "checkpoints", "state.npz") if exps else ""
    if not os.path.exists(ckpt):
        raise RuntimeError(f"train wrote no checkpoint in {tmp}/exp")
    _cli(["color_neus_torch.evaluate", "--cfg", cfg_path, "--reload", ckpt, "-rr", str(res)],
         tmp, device, 3600)
    plys = sorted(glob.glob(os.path.join(tmp, "exp", "eval_*", "meshes", "*_mesh.ply")))
    if not plys:
        raise RuntimeError(f"evaluate wrote no mesh in {tmp}/exp")

    dev = resolve_device(device)
    loop = TrainLoop(get_config(cfg_path, argparse.Namespace(reload=ckpt)), device=dev)
    g = torch.Generator(device=dev).manual_seed(7)
    rgb, _ = TR.render_image(loop.state.params, loop.scene, loop.tcfg, 0, loop.H, loop.W, g)
    gt, _m = _render_blob(poses[0], focal, H, W)
    psnr = mse2psnr(float(np.mean((np.clip(rgb, 0, 1) - gt) ** 2)))
    verts, _tris, _c = read_ply(plys[-1])
    gtp = gt_surface_points()
    sample = np.random.RandomState(0).choice(len(gtp), min(len(gtp), GT_POINTS), replace=False)
    report = {
        "what": "blob scene through the DTU on-disk format + real CLI",
        "steps": steps, "n_imgs": len(poses), "hw": [H, W],
        "platform": platform_name(dev),
        "psnr_view0": round(psnr, 2),
        "mesh_n_verts": int(len(verts)),
        "mesh_mean_abs_sdf": round(float(np.abs(blob_sdf(verts)).mean()), 5),
        "chamfer_vs_analytic": round(chamfer_distance(verts, gtp[sample], device=dev), 6),
        "train_tail": log.strip().splitlines()[-2:],
    }
    return report, {"cfg": cfg_path, "checkpoint": ckpt, "mesh": plys[-1]}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' for the plain path)")
    arg = p.parse_args(argv)
    report, _files = run(int(os.environ.get("DBE_STEPS", 2000)),
                         int(os.environ.get("DBE_RES", 256)), device=arg.device)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
