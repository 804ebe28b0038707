"""On-disk replicas of the four real dataset formats, written from the
'blob' scene of data/synthetic.py (two spheres and a torus, coloured by
position), rendered in torch on the card (or the CPU).

    python -m color_neus_torch.tools.dataset_replica --root data --format DTU \
        --views 49 --height 1200 --width 1600 [--obj_id 901] [--device cpu]

Each writer lays its files out as the family's reader expects them
(data/dtu.py, bmvs.py, iho_video.py with COLMAP binaries, omniobject3d.py):
  DTU          DTU/dtu_scan<id>/{image,mask}/NNN.png + cameras_sphere.npz,
               world_mat_i = K [R|t] in a world frame where scale_mat_i
               maps the unit sphere onto the object (as DTU's do)
  BlendedMVS   BlendedMVS/bmvs_<id>/..., DTU's layout
  IHO_VIDEO    IHO_video/<id>/obj/NNN.png (RGBA, alpha = mask) +
               colmap/{cameras,images,points3D}.bin (PINHOLE; the SfM
               points are surface points seen by the views)
  OmniObject3D OmniObject3D/blender_renders/<class>/<id>/render/
               {images/NNN.png (RGBA), transforms.json}
The tool is no reader and stands in for no data: it gives the readers,
the train loop and chip_smoke.py real files of each format to read.
Images are written by data/image_io.write_png unless another writer
(path, uint8 image in RGB(A) order) is passed.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from color_neus_torch import resolve_device
from color_neus_torch.data import colmap
from color_neus_torch.data.image_io import write_png
from color_neus_torch.ops.transforms import pose_spherical, rotmat_to_quat

# DTU-like intrinsics at 1600 x 1200 (DTU's own cameras read fx ~2892,
# fy ~2883); the principal point sits at the centre, as the model's rays
# assume
DTU_FOCAL_AT_1600 = (2892.33, 2883.18)
# a DTU-like world frame: the unit sphere of the scene at scale ~240 mm
# around a centre ~600 mm from the origin
DTU_SCALE, DTU_CENTRE = 237.4, (-12.5, 31.2, 612.8)
FORMATS = ("DTU", "BlendedMVS", "IHO_VIDEO", "OmniObject3D")


# ---------------------------------------------------------------------------
# The scene (data/synthetic.py's blob, in torch)
# ---------------------------------------------------------------------------

def blob_sdf(p: torch.Tensor) -> torch.Tensor:
    """data/synthetic.blob_sdf in torch."""
    sa = torch.linalg.norm(p - p.new_tensor([0.15, 0.0, 0.05]), dim=-1) - 0.35
    sb = torch.linalg.norm(p - p.new_tensor([-0.25, 0.12, -0.05]), dim=-1) - 0.25
    qx = torch.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2) - 0.45
    st = torch.sqrt(qx ** 2 + p[..., 2] ** 2) - 0.12
    return torch.minimum(torch.minimum(sa, sb), st)


def blob_color(p: torch.Tensor) -> torch.Tensor:
    """data/synthetic._blob_color in torch."""
    c = torch.stack([0.55 + 0.35 * torch.sin(7.0 * p[..., 0] + 3.0 * p[..., 2]),
                     0.50 + 0.35 * torch.sin(6.0 * p[..., 1] + 2.0 * p[..., 0]),
                     0.45 + 0.35 * torch.cos(5.0 * p[..., 2] + 4.0 * p[..., 1])], dim=-1)
    return torch.clamp(c, 0.05, 0.95)


@torch.no_grad()
def render_blob(c2w: np.ndarray, focal, H: int, W: int, device, n_steps: int = 128):
    """data/synthetic._render_blob in torch on `device`: the sphere-traced
    view of camera c2w (z forward) as (rgb uint8 [H,W,3], mask uint8 [H,W]
    0 / 255, surface points [n, 3] of the hit pixels, float32 numpy)."""
    c2w = torch.as_tensor(np.asarray(c2w, np.float32), device=device)
    ys, xs = torch.meshgrid(torch.arange(H, device=device, dtype=torch.float32),
                            torch.arange(W, device=device, dtype=torch.float32), indexing="ij")
    dirs = torch.stack([(xs - 0.5 * W) / float(focal[0]), (ys - 0.5 * H) / float(focal[1]),
                        torch.ones_like(xs)], dim=-1)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    rd = (dirs @ c2w[:3, :3].T).reshape(-1, 3)
    ro = c2w[:3, 3]
    t = torch.full((rd.shape[0],), 0.5, device=device)   # cameras sit at ~3.0
    for _ in range(n_steps):
        d = blob_sdf(ro + t[:, None] * rd)
        t = torch.clamp(t + torch.clamp_min(d, 0.0) * 0.9, max=6.0)
    pts = ro + t[:, None] * rd
    hit = blob_sdf(pts) < 2e-3
    eps = 1e-3     # central-difference normals at the hits
    n = torch.stack([blob_sdf(pts + e) - blob_sdf(pts - e)
                     for e in torch.eye(3, device=device) * eps], dim=-1)
    n = n / torch.clamp_min(torch.linalg.norm(n, dim=-1, keepdim=True), 1e-9)
    light = torch.clamp(-torch.sum(n * rd, dim=-1), 0.0, 1.0)
    rgb = torch.where(hit[:, None], blob_color(pts) * (0.3 + 0.7 * light[:, None]), 0.0)
    rgb8 = (torch.clamp(rgb, 0.0, 1.0) * 255).to(torch.uint8).reshape(H, W, 3)
    mask8 = (hit.to(torch.uint8) * 255).reshape(H, W)
    return rgb8.cpu().numpy(), mask8.cpu().numpy(), pts[hit].cpu().numpy()


def camera_poses(n: int, cam_radius: float = 3.0) -> np.ndarray:
    """data/synthetic.py's cameras: on a sphere around the origin, z forward."""
    poses = np.stack([pose_spherical(360.0 * i / n, -30.0 + 20.0 * (i % 3), cam_radius)
                      for i in range(n)])
    poses[:, :, 1:3] *= -1
    return poses.astype(np.float32)


def render_scene(n: int, H: int, W: int, focal, device):
    """(poses [n,4,4], rgb uint8 [n,H,W,3], mask uint8 [n,H,W], surface
    points [m,3]) of n views of the blob."""
    poses = camera_poses(n)
    rgb, mask, pts = zip(*[render_blob(p, focal, H, W, device) for p in poses])
    return poses, np.stack(rgb), np.stack(mask), np.concatenate(pts)


def _write_all(jobs, writer) -> None:
    """Write (path, image) jobs on threads (zlib releases the GIL)."""
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        for f in [ex.submit(writer, path, img) for path, img in jobs]:
            f.result()


def _w2c(c2w: np.ndarray):
    R = c2w[:3, :3].T
    return R, -R @ c2w[:3, 3]


# ---------------------------------------------------------------------------
# The four formats
# ---------------------------------------------------------------------------

def write_dtu(root: str, obj_id: str, poses, rgb, mask, focal, family: str = "DTU",
              writer=write_png, scale: float = DTU_SCALE, centre=DTU_CENTRE) -> str:
    """DTU (or, with family="BlendedMVS", BlendedMVS) layout. poses are the
    unit-sphere c2w; the files hold the world frame x_w = scale x + centre
    (by default DTU-like; scale 1 and centre 0 keep the unit-sphere frame,
    identity scale mats). Returns the scene directory."""
    sub = f"dtu_scan{obj_id}" if family == "DTU" else f"bmvs_{obj_id}"
    d = os.path.join(root, family, sub)
    for s in ("image", "mask"):
        os.makedirs(os.path.join(d, s), exist_ok=True)
    H, W = rgb.shape[1:3]
    K = np.eye(4)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = focal[0], focal[1], W / 2, H / 2
    scale_mat = np.eye(4)
    scale_mat[:3, :3] *= scale
    scale_mat[:3, 3] = centre
    payload = {}
    for i, c2w in enumerate(poses):
        world = c2w.astype(np.float64)
        world[:3, 3] = scale * world[:3, 3] + np.asarray(centre)
        R, t = _w2c(world)
        w2c = np.eye(4)
        w2c[:3, :3], w2c[:3, 3] = R, t
        payload[f"world_mat_{i}"] = (K @ w2c).astype(np.float32)
        payload[f"scale_mat_{i}"] = scale_mat.astype(np.float32)
    np.savez(os.path.join(d, "cameras_sphere.npz"), **payload)
    _write_all([(os.path.join(d, "image", f"{i:03d}.png"), im) for i, im in enumerate(rgb)]
               + [(os.path.join(d, "mask", f"{i:03d}.png"), m) for i, m in enumerate(mask)],
               writer)
    return d


def write_iho(root: str, obj_id: str, poses, rgb, mask, focal, points,
              writer=write_png) -> str:
    """IHO_VIDEO layout: RGBA frames in obj/ and a COLMAP model written by
    data/colmap.py's binary writers (one PINHOLE camera, w2c quaternions,
    the surface points as the SfM points)."""
    d = os.path.join(root, "IHO_video", obj_id)
    os.makedirs(os.path.join(d, "obj"), exist_ok=True)
    os.makedirs(os.path.join(d, "colmap"), exist_ok=True)
    H, W = rgb.shape[1:3]
    cams = {1: colmap.Camera(1, "PINHOLE", W, H, np.array([focal[0], focal[1], W / 2, H / 2]))}
    ims = {}
    for i, c2w in enumerate(poses):
        R, t = _w2c(c2w.astype(np.float64))
        ims[i + 1] = colmap.ColmapImage(i + 1, rotmat_to_quat(R), t, 1, f"{i:03d}.png")
    pts = {j + 1: colmap.Point3D(j + 1, p.astype(np.float64), np.array([128, 128, 128],
                                                                        np.uint8), 0.5)
           for j, p in enumerate(points)}
    colmap.write_cameras_binary(cams, os.path.join(d, "colmap", "cameras.bin"))
    colmap.write_images_binary(ims, os.path.join(d, "colmap", "images.bin"))
    colmap.write_points3d_binary(pts, os.path.join(d, "colmap", "points3D.bin"))
    rgba = np.concatenate([rgb, mask[..., None]], axis=-1)
    _write_all([(os.path.join(d, "obj", f"{i:03d}.png"), im) for i, im in enumerate(rgba)],
               writer)
    return d


def write_omniobject3d(root: str, obj_id: str, poses, rgb, mask, focal,
                       writer=write_png) -> str:
    """OmniObject3D layout (obj_id as <class>_NNN): RGBA images and a
    Blender transforms.json (OpenGL c2w, camera_angle_x from fx)."""
    d = os.path.join(root, "OmniObject3D", "blender_renders", obj_id[:-4], obj_id, "render")
    os.makedirs(os.path.join(d, "images"), exist_ok=True)
    W = rgb.shape[2]
    frames = []
    for i, c2w in enumerate(poses):
        tm = c2w.astype(np.float64)
        tm[:, 1:3] *= -1  # back to Blender's y up, z backward; the reader flips again
        frames.append({"file_path": f"./images/{i:03d}", "transform_matrix": tm.tolist()})
    with open(os.path.join(d, "transforms.json"), "w") as f:
        json.dump({"camera_angle_x": 2.0 * float(np.arctan(0.5 * W / focal[0])),
                   "frames": frames}, f)
    rgba = np.concatenate([rgb, mask[..., None]], axis=-1)
    _write_all([(os.path.join(d, "images", f"{i:03d}.png"), im) for i, im in enumerate(rgba)],
               writer)
    return d


def write_replica(root: str, fmt: str, n: int, H: int, W: int, obj_id: str, device) -> dict:
    """Render n views of the blob at H x W and write them in format `fmt`
    (DTU and BlendedMVS with DTU's focal scaled to W, the others with
    synthetic.py's 1.2 W). Returns what a reader should read back: {"dir",
    "poses" (unit-sphere c2w), "focal", "rgb", "mask", "points",
    "render_s", "write_s"}."""
    if fmt not in FORMATS:
        raise ValueError(f"format {fmt!r}: one of {FORMATS}")
    focal = ((DTU_FOCAL_AT_1600[0] * W / 1600, DTU_FOCAL_AT_1600[1] * W / 1600)
             if fmt in ("DTU", "BlendedMVS") else (1.2 * W, 1.2 * W))
    t0 = time.perf_counter()
    poses, rgb, mask, pts = render_scene(n, H, W, focal, device)
    t1 = time.perf_counter()
    if fmt in ("DTU", "BlendedMVS"):
        d = write_dtu(root, obj_id, poses, rgb, mask, focal, family=fmt)
    elif fmt == "IHO_VIDEO":
        # a few thousand of the views' surface points, as an SfM run keeps
        pts = pts[::max(1, len(pts) // 4000)]
        d = write_iho(root, obj_id, poses, rgb, mask, focal, pts)
    else:
        d = write_omniobject3d(root, obj_id, poses, rgb, mask, focal)
    return {"dir": d, "poses": poses, "focal": np.asarray(focal, np.float32), "rgb": rgb,
            "mask": mask, "points": pts, "render_s": t1 - t0,
            "write_s": time.perf_counter() - t1}


def main(argv=None):
    p = argparse.ArgumentParser("color_neus_torch dataset replica")
    p.add_argument("--root", required=True, help="DATA_ROOT to write into")
    p.add_argument("--format", choices=FORMATS, default="DTU")
    p.add_argument("--obj_id", default=None,
                   help="OBJ_ID (default 901; OmniObject3D: blob_001)")
    p.add_argument("--views", type=int, default=49)
    p.add_argument("--height", type=int, default=1200)
    p.add_argument("--width", type=int, default=1600)
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    a = p.parse_args(argv)
    obj_id = a.obj_id or ("blob_001" if a.format == "OmniObject3D" else "901")
    r = write_replica(a.root, a.format, a.views, a.height, a.width, obj_id,
                      resolve_device(a.device))
    print(f"{a.format} replica in {r['dir']}: {a.views} views at {a.width} x {a.height}, "
          f"render {r['render_s']:.2f} s, write {r['write_s']:.2f} s")


if __name__ == "__main__":
    main()
