"""Rotation conversions and misc transforms the training path needs.

Port of color_neus_tpu/ops/transforms.py (reference
lib/utils/transform.py and camera_net.py:112-131): the rotation
conversions of the pose net and the rest of the reference's set
(quaternions, axis-angle from a matrix, slerp, pose interpolation), and
the host-side camera preprocessing (load_K_Rt_from_P, rotmat_to_quat).
Torch for what may sit in the autograd graph, numpy for host-side camera
setup.
"""

from __future__ import annotations

import numpy as np
import torch


def aa_to_rotmat(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> rotation matrix [..., 3, 3] (Rodrigues),
    with Taylor-guarded sin(t)/t and (1-cos t)/t^2 near t = 0.

    Where the series is taken, the other branch divides by 1, not by t^2:
    the JAX package's form (a where over (1-cos t)/t^2) has a 0/0 there
    whose NaN its gradient keeps, so a 3d pose leaf at its init (aa = 0)
    got a NaN gradient. Values and gradients elsewhere are unchanged."""
    theta2 = torch.sum(aa * aa, dim=-1, keepdim=True)
    small = theta2 < 1e-12
    safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(safe)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe)

    x, y, z = aa[..., 0], aa[..., 1], aa[..., 2]
    zeros = torch.zeros_like(x)
    K = torch.stack([
        torch.stack([zeros, -z, y], dim=-1),
        torch.stack([z, zeros, -x], dim=-1),
        torch.stack([-y, x, zeros], dim=-1),
    ], dim=-2)
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand(K.shape)
    return eye + a[..., None] * K + b[..., None] * (K @ K)


def rot6d_to_rotmat(d6: torch.Tensor) -> torch.Tensor:
    """6D rotation [..., 6] -> matrix [..., 3, 3] (Zhou et al. CVPR'19,
    pytorch3d.rotation_6d_to_matrix): Gram-Schmidt rows b1, b2, b1 x b2."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True).clamp_min(1e-12)
    a2p = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = a2p / torch.linalg.norm(a2p, dim=-1, keepdim=True).clamp_min(1e-12)
    b3 = torch.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z) [..., 4] -> rotation matrix [..., 3, 3]."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)


def rotmat_to_aa(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> axis-angle [..., 3], through the
    quaternion (the reference's matrix_to_quaternion ->
    quaternion_to_axis_angle, transform.py:77-92): Shepperd's four
    candidates, the one of the largest pivot. Exact for theta in [0, pi)."""
    m = R
    t = m.diagonal(dim1=-2, dim2=-1).sum(-1)
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    qs = torch.stack([
        torch.stack([1.0 + t, m[..., 2, 1] - m[..., 1, 2], m[..., 0, 2] - m[..., 2, 0],
                     m[..., 1, 0] - m[..., 0, 1]], dim=-1),
        torch.stack([m[..., 2, 1] - m[..., 1, 2], 1.0 + m00 - m11 - m22,
                     m[..., 0, 1] + m[..., 1, 0], m[..., 0, 2] + m[..., 2, 0]], dim=-1),
        torch.stack([m[..., 0, 2] - m[..., 2, 0], m[..., 0, 1] + m[..., 1, 0],
                     1.0 + m11 - m00 - m22, m[..., 1, 2] + m[..., 2, 1]], dim=-1),
        torch.stack([m[..., 1, 0] - m[..., 0, 1], m[..., 0, 2] + m[..., 2, 0],
                     m[..., 1, 2] + m[..., 2, 1], 1.0 + m22 - m00 - m11], dim=-1),
    ], dim=-2)   # [..., 4 candidates, 4]
    pivots = torch.stack([1.0 + t, 1.0 + m00 - m11 - m22, 1.0 + m11 - m00 - m22,
                          1.0 + m22 - m00 - m11], dim=-1)
    best = torch.argmax(pivots, dim=-1)
    q = torch.take_along_dim(qs, best[..., None, None].expand(*best.shape, 1, 4), dim=-2)
    return quat_to_aa(q[..., 0, :])


def aa_to_quat(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> quaternion (w, x, y, z) [..., 4], with the
    series 1/2 - t^2/48 for sin(t/2)/t below t = 1e-6."""
    theta = torch.linalg.norm(aa, dim=-1, keepdim=True)
    half = theta * 0.5
    small = theta < 1e-6
    k = torch.where(small, 0.5 - theta ** 2 / 48.0,
                    torch.sin(half) / torch.clamp_min(theta, 1e-12))
    return torch.cat([torch.cos(half), aa * k], dim=-1)


def quat_to_aa(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z) [..., 4] -> axis-angle [..., 3], the
    shortest rotation (w >= 0), with the series 2 + t^2/12 for t / sin(t/2)
    below t = 1e-6."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(1e-12)
    q = torch.where(q[..., :1] < 0, -q, q)
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    theta = 2.0 * torch.arccos(w)
    s = torch.sqrt(torch.clamp_min(1.0 - w * w, 1e-12))
    small = theta < 1e-6
    k = torch.where(small, 2.0 + theta ** 2 / 12.0, theta / s)
    return q[..., 1:] * k


def rotmat_to_rot6d(R: torch.Tensor) -> torch.Tensor:
    """Matrix [..., 3, 3] -> 6D rep (its first two rows, pytorch3d's
    convention; rot6d_to_rotmat's inverse)."""
    return R[..., :2, :].reshape(*R.shape[:-2], 6)


def slerp(q0: torch.Tensor, q1: torch.Tensor, ratio) -> torch.Tensor:
    """Spherical interpolation of two quaternions [4] (transform.py:347-370):
    the shorter arc, a linear blend where they are nearly parallel (|dot| >
    0.9995), normalised."""
    q0 = q0 / torch.linalg.norm(q0).clamp_min(1e-12)
    q1 = q1 / torch.linalg.norm(q1).clamp_min(1e-12)
    dot = torch.sum(q0 * q1)
    q0 = torch.where(dot < 0, -q0, q0)
    dot = torch.abs(dot)
    theta = torch.arccos(torch.clamp(dot, -1.0, 1.0)) * ratio
    q_perp = q1 - dot * q0
    q_perp = q_perp / torch.linalg.norm(q_perp).clamp_min(1e-12)
    geo = torch.cos(theta) * q0 + torch.sin(theta) * q_perp
    lerp = q0 + ratio * (q1 - q0)
    out = torch.where(dot > 0.9995, lerp, geo)
    return out / torch.linalg.norm(out).clamp_min(1e-12)


def rotmat_interpolate(R0: np.ndarray, R1: np.ndarray, ratio: float) -> np.ndarray:
    """Rotation at `ratio` between two 3x3 matrices (host-side): slerp of
    their quaternions."""
    q0, q1 = (torch.as_tensor(rotmat_to_quat(np.asarray(R)), dtype=torch.float32)
              for R in (R0, R1))
    return quat_to_rotmat(slerp(q0, q1, ratio)).numpy()


def se3_interpolate(T0: np.ndarray, T1: np.ndarray, ratio: float) -> np.ndarray:
    """Pose at `ratio` between two 4x4 poses (transform.py:373-384): slerp
    of the rotation, lerp of the translation."""
    T0 = np.asarray(T0)
    T1 = np.asarray(T1)
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = rotmat_interpolate(T0[:3, :3], T1[:3, :3], ratio)
    out[:3, 3] = T0[:3, 3] + ratio * (T1[:3, 3] - T0[:3, 3])
    return out


def convert3x4_4x4(mat: torch.Tensor) -> torch.Tensor:
    """[..., 3, 4] -> [..., 4, 4] homogeneous (appends [0,0,0,1])."""
    bottom = torch.zeros((*mat.shape[:-2], 1, 4), dtype=mat.dtype, device=mat.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([mat, bottom], dim=-2)


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip: the values of torch.clamp, but a gradient that splits a
    tie at a bound 0.5 / 0.5, as jnp.clip's does (torch.clamp passes all
    of it). The bounds are filled on x's device (no host copy)."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)), x.new_full((), hi))


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """logit with the reference's clamping (transform.py:304-320); ties
    split the gradient as jnp.clip and jnp.maximum do."""
    x = clip(x, 0.0, 1.0)
    e = x.new_full((), eps)
    x1 = torch.maximum(x, e)
    x2 = torch.maximum(1.0 - x, e)
    return torch.log(x1 / x2)


def pose_spherical(theta: float, phi: float, radius: float) -> np.ndarray:
    """Blender-style spherical camera pose (transform.py:323-337)."""
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = radius
    phi_r = phi / 180.0 * np.pi
    th_r = theta / 180.0 * np.pi
    rot_phi = np.array(
        [[1, 0, 0, 0],
         [0, np.cos(phi_r), -np.sin(phi_r), 0],
         [0, np.sin(phi_r), np.cos(phi_r), 0],
         [0, 0, 0, 1]], dtype=np.float32)
    rot_theta = np.array(
        [[np.cos(th_r), 0, -np.sin(th_r), 0],
         [0, 1, 0, 0],
         [np.sin(th_r), 0, np.cos(th_r), 0],
         [0, 0, 0, 1]], dtype=np.float32)
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.float32)
    return flip @ rot_theta @ rot_phi @ c2w


# ---------------------------------------------------------------------------
# Camera preprocessing (host-side numpy)
# ---------------------------------------------------------------------------

def rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix (3,3) -> quaternion (w,x,y,z). Host-side numpy."""
    m = np.asarray(R, dtype=np.float64)
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
                         (m[1, 0] - m[0, 1]) / s])
    i = int(np.argmax(np.diag(m)))
    if i == 0:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        return np.array([(m[2, 1] - m[1, 2]) / s, 0.25 * s, (m[0, 1] + m[1, 0]) / s,
                         (m[0, 2] + m[2, 0]) / s])
    if i == 1:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        return np.array([(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s, 0.25 * s,
                         (m[1, 2] + m[2, 1]) / s])
    s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
    return np.array([(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s,
                     (m[1, 2] + m[2, 1]) / s, 0.25 * s])


def load_K_Rt_from_P(P: np.ndarray):
    """Decompose a 3x4 projection matrix into intrinsics and c2w pose:
    (intrinsics 4x4 with K[2,2] = 1, pose 4x4 camera-to-world), the
    contract of the reference's cv2.decomposeProjectionMatrix version
    (transform.py:280-301), by an RQ decomposition of P[:, :3] with the
    signs fixed so K has a positive diagonal."""
    P = np.asarray(P, dtype=np.float64)[:3, :4]
    M = P[:, :3]
    # RQ decomposition via QR of the row-reversed matrix
    rev = np.eye(3)[::-1]
    Q_, R_ = np.linalg.qr((rev @ M).T)
    K = rev @ R_.T @ rev
    R = rev @ Q_.T
    sign = np.diag(np.sign(np.diag(K)))
    K = K @ sign
    R = sign @ R
    # camera centre: the null space of P (M c = -p4)
    t = -np.linalg.solve(M, P[:, 3])
    K = K / K[2, 2]
    intrinsics = np.eye(4, dtype=np.float32)
    intrinsics[:3, :3] = K.astype(np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R.T.astype(np.float32)
    pose[:3, 3] = t.astype(np.float32)
    return intrinsics, pose
