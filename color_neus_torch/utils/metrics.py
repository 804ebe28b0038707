"""Metrics: port of color_neus_tpu/utils/metrics.py.

Running loss meters, PSNR, SSIM (Wang et al. windowed SSIM with an 11x11
Gaussian, sigma 1.5, as kornia's defaults; the convolution in full f32,
pin_precision keeps cuDNN off TF32), the symmetric Chamfer distance
(tiled nearest neighbour), and the LPIPS stub that returns 0, as the
reference's does (similarity.py:84-88).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class LossMetric:
    """Running means of every entry of the per-step loss dict."""

    def __init__(self):
        self._meters: dict[str, AverageMeter] = {}

    def feed(self, loss_dict: dict, n: int = 1):
        for k, v in loss_dict.items():
            self._meters.setdefault(k, AverageMeter()).update(float(v), n)

    def get_loss(self, key: str = "loss") -> float:
        return self._meters[key].avg if key in self._meters else float("nan")

    def items(self):
        return {k: m.avg for k, m in self._meters.items()}

    def reset(self):
        for m in self._meters.values():
            m.reset()

    def __str__(self):
        return " | ".join(f"{k}: {m.avg:.5f}" for k, m in self._meters.items())


def mse2psnr(mse: float) -> float:
    return -10.0 * math.log10(max(float(mse), 1e-12))


class _Meter:
    name = ""

    def __init__(self):
        self.meter = AverageMeter()

    @property
    def avg(self):
        return self.meter.avg

    def reset(self):
        self.meter.reset()

    def __str__(self):
        return f"{self.name}: {self.avg:.4f}"


class PSNR(_Meter):
    name = "PSNR"

    def feed(self, pred, target):
        mse = float(np.mean((np.asarray(pred) - np.asarray(target)) ** 2))
        self.meter.update(mse2psnr(mse))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    g = torch.exp(-0.5 * (x / sigma) ** 2)
    g = g / torch.sum(g)
    return torch.outer(g, g)


def ssim(img1, img2, max_val: float = 1.0, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over [H, W, C] images (Wang et al. 2004 constants)."""
    img1 = torch.as_tensor(np.asarray(img1), dtype=torch.float32)
    img2 = torch.as_tensor(np.asarray(img2), dtype=torch.float32)
    k = _gaussian_kernel(window_size, sigma)[None, None]       # [1,1,ks,ks]
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2

    def filt(x):  # [H, W, C] -> valid-window local means [C, H', W']
        return F.conv2d(x.permute(2, 0, 1)[:, None], k)[:, 0]

    mu1, mu2 = filt(img1), filt(img2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = filt(img1 * img1) - mu1_sq
    s2 = filt(img2 * img2) - mu2_sq
    s12 = filt(img1 * img2) - mu12
    ssim_map = ((2 * mu12 + c1) * (2 * s12 + c2)) / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return torch.mean(ssim_map)


class SSIM(_Meter):
    name = "SSIM"

    def feed(self, pred, target):
        self.meter.update(float(ssim(pred, target)))


class LPIPS(_Meter):
    """Stub matching the reference's LPIPS (similarity.py:84-88: always 0).
    A real perceptual metric needs pretrained VGG weights."""
    name = "LPIPS"

    def feed(self, pred, target):
        self.meter.update(0.0)


def _nn_sq_dists(a: torch.Tensor, b: torch.Tensor, tile: int = 4096) -> torch.Tensor:
    """min_j ||a_i - b_j||^2 for each i, tiled over a to bound memory."""
    b_sq = torch.sum(b * b, dim=1)
    mins = []
    for i in range(0, a.shape[0], tile):
        at = a[i:i + tile]
        d = torch.sum(at * at, dim=1)[:, None] - 2.0 * at @ b.T + b_sq[None]
        mins.append(torch.min(d, dim=1).values)
    return torch.clamp_min(torch.cat(mins), 0.0)


def chamfer_distance(pts_a, pts_b, device="cpu") -> float:
    """Symmetric mean-squared chamfer (pytorch3d convention:
    mean_a min_b ||.||^2 + mean_b min_a ||.||^2), computed on `device`."""
    a = torch.as_tensor(np.asarray(pts_a), dtype=torch.float32, device=device)
    b = torch.as_tensor(np.asarray(pts_b), dtype=torch.float32, device=device)
    return float(torch.mean(_nn_sq_dists(a, b)) + torch.mean(_nn_sq_dists(b, a)))
