"""Synthetic in-memory dataset (copy of color_neus_tpu/data/synthetic.py).

A coloured sphere or the 'blob' scene, rendered analytically. Used by
tests and the smoke run — no disk data required. Cameras sit on a
sphere looking at the origin; images are analytic lambert-shaded renders
of a sphere of the given radius, so a correctly-implemented trainer can
actually reconstruct it.
"""

from __future__ import annotations

import numpy as np

from color_neus_torch.data.base import BaseDataset
from color_neus_torch.ops.transforms import pose_spherical
from color_neus_torch.utils.registry import DATASET


def _render_sphere(c2w, focal, H, W, radius=0.5, color=(0.8, 0.3, 0.2)):
    """Analytic ray-traced sphere at the origin; returns (rgb, mask)."""
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    dirs = np.stack([(xs - 0.5 * W) / focal[0],
                     (ys - 0.5 * H) / focal[1],
                     np.ones_like(xs)], axis=-1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rd = dirs @ c2w[:3, :3].T
    ro = c2w[:3, 3]

    b = 2.0 * rd @ ro
    c = float(ro @ ro) - radius * radius
    disc = b * b - 4 * c
    hit = disc > 0
    t = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0.0))) / 2.0, 0.0)
    pts = ro + t[..., None] * rd
    n = pts / np.maximum(np.linalg.norm(pts, axis=-1, keepdims=True), 1e-8)
    light = np.clip(-np.sum(n * rd, axis=-1), 0.0, 1.0)
    rgb = np.zeros((H, W, 3), np.float32)
    rgb[hit] = np.asarray(color, np.float32) * (0.3 + 0.7 * light[hit, None])
    return rgb, hit.astype(np.float32)


def blob_sdf(pts: np.ndarray) -> np.ndarray:
    """Analytic SDF of the 'blob' scene: union of two overlapping
    spheres and a torus — non-convex, with self-occlusions and a
    sign-change geometry the importance sampler must navigate (VERDICT
    r4 #6: the single sphere cannot catch errors there; any blob
    converges on a sphere).

    Exact distance for each primitive; union by min (exact outside,
    conservative inside — standard CSG union)."""
    p = np.asarray(pts, np.float32)
    sa = np.linalg.norm(p - np.array([0.15, 0.0, 0.05], np.float32),
                        axis=-1) - 0.35
    sb = np.linalg.norm(p - np.array([-0.25, 0.12, -0.05], np.float32),
                        axis=-1) - 0.25
    qx = np.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2) - 0.45
    st = np.sqrt(qx ** 2 + p[..., 2] ** 2) - 0.12
    return np.minimum(np.minimum(sa, sb), st)


def _blob_color(pts: np.ndarray) -> np.ndarray:
    """Procedural view-independent texture (smooth position bands)."""
    p = np.asarray(pts, np.float32)
    c = np.stack([
        0.55 + 0.35 * np.sin(7.0 * p[..., 0] + 3.0 * p[..., 2]),
        0.50 + 0.35 * np.sin(6.0 * p[..., 1] + 2.0 * p[..., 0]),
        0.45 + 0.35 * np.cos(5.0 * p[..., 2] + 4.0 * p[..., 1]),
    ], axis=-1)
    return np.clip(c, 0.05, 0.95)


def _render_blob(c2w, focal, H, W, n_steps: int = 128):
    """Sphere-traced analytic render of the blob scene: (rgb, mask)."""
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    dirs = np.stack([(xs - 0.5 * W) / focal[0],
                     (ys - 0.5 * H) / focal[1],
                     np.ones_like(xs)], axis=-1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rd = (dirs @ c2w[:3, :3].T).reshape(-1, 3)
    ro = c2w[:3, 3]

    t = np.full(rd.shape[0], 0.5, np.float32)   # cameras sit at ~3.0
    for _ in range(n_steps):
        d = blob_sdf(ro + t[:, None] * rd)
        t = np.minimum(t + np.maximum(d, 0.0) * 0.9, 6.0)
    pts = ro + t[:, None] * rd
    hit = blob_sdf(pts) < 2e-3

    # numeric central-difference normal at the hits
    eps = 1e-3
    n = np.zeros_like(pts)
    for a in range(3):
        e = np.zeros(3, np.float32)
        e[a] = eps
        n[:, a] = blob_sdf(pts + e) - blob_sdf(pts - e)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-9)

    light = np.clip(-np.sum(n * rd, axis=-1), 0.0, 1.0)
    rgb = np.zeros((rd.shape[0], 3), np.float32)
    rgb[hit] = _blob_color(pts[hit]) * (0.3 + 0.7 * light[hit, None])
    return rgb.reshape(H, W, 3), hit.reshape(H, W).astype(np.float32)


@DATASET.register_module("Synthetic")
class Synthetic(BaseDataset):
    name = "Synthetic"

    def __init__(self, cfg: dict):
        preset = cfg.get("DATA_PRESET", {})
        self.include_mask = preset.get("INCLUDE_MASK", True)
        self.fx_only = preset.get("FX_ONLY", False)

        self.n_imgs = cfg.get("N_IMGS", 8)
        H = cfg.get("H", 64)
        W = cfg.get("W", 64)
        # 'sphere' (default) or 'blob' (textured non-convex CSG scene)
        self.scene = cfg.get("SCENE", "sphere")
        self.sphere_radius = cfg.get("SPHERE_RADIUS", 0.5)
        cam_radius = cfg.get("CAM_RADIUS", 3.0)
        f = cfg.get("FOCAL", 1.2 * W)
        self.focal = (np.array([f], np.float32) if self.fx_only
                      else np.array([f, f], np.float32))

        self.poses = np.stack([
            pose_spherical(360.0 * i / self.n_imgs, -30.0 + 20.0 * (i % 3), cam_radius)
            for i in range(self.n_imgs)
        ])
        # pose_spherical yields OpenGL-style (z backward) frames; flip to our
        # z-forward convention so rays look at the origin.
        self.poses[:, :, 1:3] *= -1

        self._images, self._masks = [], []
        for i in range(self.n_imgs):
            f2 = (self.focal if len(self.focal) == 2
                  else np.repeat(self.focal, 2))
            if self.scene == "blob":
                rgb, mask = _render_blob(self.poses[i], f2, H, W)
            else:
                rgb, mask = _render_sphere(self.poses[i], f2, H, W,
                                           self.sphere_radius)
            self._images.append(rgb)
            self._masks.append(mask)

        self.origin = np.zeros(3, np.float32)
        self.radius = 1.0
        self.scale_mats = np.tile(np.eye(4, dtype=np.float32), (self.n_imgs, 1, 1))
        self.object_bbox_min = np.array([-1.01, -1.01, -1.01], np.float32)
        self.object_bbox_max = np.array([1.01, 1.01, 1.01], np.float32)

    def get_image(self, idx: int):
        return self._images[idx], self._masks[idx] if self.include_mask else None
