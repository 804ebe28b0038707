"""Camera visualization: port of color_neus_tpu/utils/viztools.py.

Scene wireframes and trajectory plots -> RGB arrays for the scalar
writer (reference lib/models/tools/viztools.py:76-141: the camera-frustum
scene plot and the camera-track plot). matplotlib is imported when a plot
is drawn, in Agg mode, so this works headless; the package imports
without it.
"""

from __future__ import annotations

import numpy as np


def _fig_to_rgb(fig):
    fig.canvas.draw()
    w, h = fig.canvas.get_width_height()
    buf = np.frombuffer(fig.canvas.buffer_rgba(), dtype=np.uint8)
    return buf.reshape(h, w, 4)[..., :3].copy()


def _frustum_points(c2w: np.ndarray, scale: float = 0.1) -> np.ndarray:
    """5 points of a camera wireframe pyramid in world space."""
    pts_cam = np.array([
        [0, 0, 0],
        [-1, -0.75, 1.5], [1, -0.75, 1.5], [1, 0.75, 1.5], [-1, 0.75, 1.5],
    ]) * scale
    return pts_cam @ c2w[:3, :3].T + c2w[:3, 3]


def plot_camera_scene(c2ws: np.ndarray, radius: float = 1.0,
                      title: str = "") -> np.ndarray:
    """3D wireframe plot of all camera frusta; returns [H, W, 3] uint8."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    c2ws = np.asarray(c2ws)
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(111, projection="3d")
    scale = 0.08 * float(radius)
    for c2w in c2ws:
        p = _frustum_points(c2w, scale)
        for a, b in ((0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)):
            ax.plot(*zip(p[a], p[b]), color="tab:blue", linewidth=0.7)
    ax.scatter([0], [0], [0], color="red", s=12)
    lim = 1.2 * max(float(np.abs(c2ws[:, :3, 3]).max()), radius)
    ax.set_xlim(-lim, lim)
    ax.set_ylim(-lim, lim)
    ax.set_zlim(-lim, lim)
    ax.set_title(title)
    img = _fig_to_rgb(fig)
    plt.close(fig)
    return img


def plot_cameras_track(c2ws: np.ndarray, title: str = "") -> np.ndarray:
    """Camera-center trajectory plot; returns [H, W, 3] uint8."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    centers = np.asarray(c2ws)[:, :3, 3]
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(111, projection="3d")
    ax.plot(centers[:, 0], centers[:, 1], centers[:, 2], "-o",
            markersize=2, linewidth=0.8)
    ax.scatter(*centers[0], color="green", s=30, label="start")
    ax.scatter(*centers[-1], color="red", s=30, label="end")
    ax.legend()
    ax.set_title(title)
    img = _fig_to_rgb(fig)
    plt.close(fig)
    return img
