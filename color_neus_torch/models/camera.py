"""Learnable camera refinement: port of color_neus_tpu/models/camera.py.

Focal coefficients and pose deltas (reference camera_net.py:8-109).
Freezing (LEARN_FOCAL / LEARN_R / LEARN_T false) detaches the leaves, the
counterpart of JAX's stop_gradient: they get no gradient and no update.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from color_neus_torch.ops.transforms import aa_to_rotmat, convert3x4_4x4, rot6d_to_rotmat


@dataclass(frozen=True)
class CameraConfig:
    learn_focal: bool = False
    learn_r: bool = False
    learn_t: bool = False
    fx_only: bool = False
    focal_order: int = 2       # fx = coeff^order * W (camera_net.py:55-66)
    pose_mode: str = "6d"      # "3d" axis-angle | "6d" rot6d
    H: int = 0
    W: int = 0
    n_cams: int = 0


def _param(x, device):
    return nn.Parameter(torch.tensor(x, dtype=torch.float32, device=device))


def init_focal(cfg: CameraConfig, init_focal=None, device="cpu") -> nn.ParameterDict:
    """Focal stored as a coefficient of (W, H): order 2 -> sqrt(f/dim)."""
    if init_focal is None:
        return nn.ParameterDict({"fx": _param(1.0, device), "fy": _param(1.0, device)})
    init_focal = np.asarray(init_focal, dtype=np.float64).reshape(-1)
    fx = init_focal[0]
    fy = init_focal[1] if (init_focal.shape[0] == 2 and not cfg.fx_only) else init_focal[0]
    if cfg.focal_order == 2:
        cx, cy = np.sqrt(fx / cfg.W), np.sqrt(fy / cfg.H)
    elif cfg.focal_order == 1:
        cx, cy = fx / cfg.W, fy / cfg.H
    else:
        raise ValueError("focal order must be 1 or 2")
    # round through f32 as the JAX package stores them
    cx, cy = float(np.float32(cx)), float(np.float32(cy))
    if cfg.fx_only:
        return nn.ParameterDict({"fx": _param(cx, device)})
    return nn.ParameterDict({"fx": _param(cx, device), "fy": _param(cy, device)})


def focal_apply(params, cfg: CameraConfig) -> torch.Tensor:
    """Returns [fx, fy]."""
    fx = params["fx"]
    fy = params["fx"] if cfg.fx_only else params["fy"]
    if not cfg.learn_focal:
        fx, fy = fx.detach(), fy.detach()
    if cfg.focal_order == 2:
        return torch.stack([fx * fx * cfg.W, fy * fy * (cfg.W if cfg.fx_only else cfg.H)])
    return torch.stack([fx * cfg.W, fy * (cfg.W if cfg.fx_only else cfg.H)])


def init_pose(cfg: CameraConfig, device="cpu") -> nn.ParameterDict:
    """Identity delta: axis-angle zeros or rot6d [1,0,0,0,1,0] rows."""
    n = cfg.n_cams
    if cfg.pose_mode == "3d":
        r = torch.zeros((n, 3), device=device)
    elif cfg.pose_mode == "6d":
        r = torch.tensor([[1.0, 0, 0, 0, 1, 0]], device=device).repeat(n, 1)
    else:
        raise ValueError(f"pose mode must be 3d or 6d, got {cfg.pose_mode}")
    return nn.ParameterDict({"r": nn.Parameter(r),
                             "t": nn.Parameter(torch.zeros((n, 3), device=device))})


def pose_apply(params, cfg: CameraConfig, init_c2w: torch.Tensor,
               cam_ids: torch.Tensor) -> torch.Tensor:
    """c2w [len(cam_ids), 4, 4] = delta(cam) @ init_c2w[cam] (camera_net.py:95-109)."""
    r = params["r"][cam_ids]
    t = params["t"][cam_ids]
    if not cfg.learn_r:
        r = r.detach()
    if not cfg.learn_t:
        t = t.detach()
    R = aa_to_rotmat(r) if cfg.pose_mode == "3d" else rot6d_to_rotmat(r)
    delta = convert3x4_4x4(torch.cat([R, t[..., None]], dim=-1))
    # 4x4 products as elementwise f32 sums: no TF32 path can round a pose
    return torch.sum(delta[..., :, :, None] * init_c2w[cam_ids][..., None, :, :], dim=-2)
