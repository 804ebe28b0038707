"""The grid SDF: counterpart of make_fused_sdf_fn in
color_neus_tpu/ops/pallas/sdf_mlp.py (the mesh extraction's per-voxel
SDF, _sdf_mlp_kernel).

sdf_fn(pts [N,3]) -> sdf [N]. Two implementations of one function:
  * launch_sdf_points: the second entry of the placement sweep's kernel
    file csrc/sdf_rays.cu (sdf_points_launch: the same device code with
    the points read from memory). Runs for CUDA tensors, counts its
    launches in launch_sdf_points.launches, raises on any build or launch
    failure.
  * sdf_points_plain: the same arithmetic in plain PyTorch (the sweep's
    sdf_mlp_plain), in fixed-size chunks. Runs for CPU tensors, and is
    what tests and chip_smoke.py compare the kernel against.
The sdf_fn that make_fused_sdf_fn returns picks between them by the
device of the tensors it is given, and by nothing else.

Precision (RendererConfig.extract_precision): 'f32' runs exact f32 FMAs,
'bf16' the tensor-core mode (weights and layer inputs rounded to bf16),
'f32x3' JAX's 3-pass split on the tensor cores (every f32 layer input and
weight split into bf16 hi and lo parts, hi.hi + hi.lo + lo.hi summed in
f32: only lo.lo is missing, ~2^-16 relative; the activations stay f32
between layers). The PE phase is exact f32 in all three.
"""

from __future__ import annotations

import torch

from color_neus_torch.models.configs import SDFConfig
from color_neus_torch.ops.kernels.sdf_rays import (
    SweepWeights, _check, _check_kernel_shape, _library, resolve_sweep_weights, sdf_mlp_plain,
)

# CPU BLAS picks its blocking by the row count, so a point's value could
# depend on the batch it arrives in; fixed-size chunks keep it the same in
# every batch (the sparse and dense grids must agree bitwise).
PLAIN_CHUNK = 4096
_PRECISION = {"f32": "float32", "bf16": "bfloat16", "f32x3": "f32x3"}
# sdf_points_launch's mode argument of each SweepWeights.dtype
_MODE = {"float32": 0, "bfloat16": 1, "f32x3": 2}


def sdf_points_plain(sw: SweepWeights, pts: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch grid SDF: pts [N, 3] -> sdf [N]."""
    n = pts.shape[0]
    pad = (-n) % PLAIN_CHUNK
    if pad:
        pts = torch.cat([pts, pts.new_zeros((pad, 3))])
    with torch.no_grad():
        out = [sdf_mlp_plain(sw, pts[i:i + PLAIN_CHUNK])
               for i in range(0, pts.shape[0], PLAIN_CHUNK)]
    return torch.cat(out)[:n] if out else pts.new_zeros((0,))


def launch_sdf_points(sw: SweepWeights, pts: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; returns sdf [N]."""
    if sw.packed is None:
        raise ValueError("sdf_points: weights were resolved on the CPU")
    n = pts.shape[0]
    dev = pts.device
    _check("pts", pts, (n, 3), dev)
    if sw.packed.device != dev or sw.bias.device != dev:
        raise ValueError("sdf_points: weights and points are on different devices")
    d0, skip, n_lin = _check_kernel_shape(sw.cfg)
    lib = _library()
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.sdf_points_launch(pts.data_ptr(), sw.packed.data_ptr(), sw.bias.data_ptr(),
                               out.data_ptr(), n, n_lin, skip, d0, float(sw.cfg.scale),
                               _MODE[sw.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"sdf_points kernel launch failed: CUDA error {rc} "
                           f"({lib.sdf_rays_error_string(rc).decode()})")
    launch_sdf_points.launches += 1
    return out


launch_sdf_points.launches = 0


def make_fused_sdf_fn(params, cfg: SDFConfig, prec: str = "f32"):
    """Returns sdf_fn(pts [N, 3]) -> sdf [N]: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. Weights are resolved (and
    packed) once, here, and kept as sdf_fn.weights."""
    if prec not in _PRECISION:
        raise ValueError(f"extract_precision={prec!r} not in {tuple(_PRECISION)}")
    sw = resolve_sweep_weights(params, cfg, _PRECISION[prec], "softplus")

    def sdf_fn(pts):
        pts = pts.contiguous()
        if pts.is_cuda:
            return launch_sdf_points(sw, pts)
        return sdf_points_plain(sw, pts)

    sdf_fn.weights = sw
    return sdf_fn
