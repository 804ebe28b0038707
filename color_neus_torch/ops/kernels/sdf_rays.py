"""The SDF placement sweep: counterpart of color_neus_tpu/ops/pallas/sdf_mlp.py.

sdf_fn(rays_o [R,3], rays_d [R,3], z [R,S]) -> sdf [R,S] builds the
points ro + rd*z itself, so the caller never materialises [R*S, 3]
points. hierarchical_z_vals runs it 4 times per training step (one
coarse sweep, then one per up-sample round but the last).

Two implementations of one function:
  * launch_sdf_rays: the hand-written CUDA kernel csrc/sdf_rays.cu (its
    source note gives the bound and the design). Runs for CUDA tensors,
    counts its launches in launch_sdf_rays.launches, raises on any build
    or launch failure.
  * sdf_rays_plain: the same arithmetic in plain PyTorch (the counterpart
    of make_xla_sdf_rays_fn). In bf16 mode it rounds every layer input
    and weight to bf16 and multiplies in f32, emulating the kernel (the
    grid SDF's f32x3 mode: three products of their bf16 hi / lo parts); its
    softplus and its last division are the kernel's (the log term times
    0.01, the output times the f32 reciprocal of scale). Runs for CPU
    tensors, and is what tests and chip_smoke.py compare the kernel
    against.
The sdf_fn that make_fused_sdf_rays_fn returns picks between them by the
device of the tensors it is given, and by nothing else.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch

from color_neus_torch.models.configs import SDFConfig
from color_neus_torch.models.fields import resolve_linear
from color_neus_torch.ops.embedding import embedding_dim, positional_encoding
from color_neus_torch.ops.kernels.point_pipeline import _frag

KERNEL = "sdf_rays"
HID = 256    # the kernel's hidden width
EMB = 48     # the kernel's padded PE width
_INV_SQRT2 = 1.0 / math.sqrt(2.0)


@dataclass
class SweepWeights:
    """Weight-norm-resolved SDF weights of one sweep configuration.

    layers: [(w [in, out] f32, b [out] f32)] in the network's own widths,
    the last layer cut to its sdf row (w [in, 1]); packed / bias: the
    kernel's buffers (None for CPU weights). dtype: 'bfloat16', 'float32'
    or 'f32x3' (the grid SDF's 3-pass split, sdf_mlp.py)."""
    cfg: SDFConfig
    layers: list
    dtype: str
    act: str
    packed: torch.Tensor | None = None
    bias: torch.Tensor | None = None


def _check_kernel_shape(cfg: SDFConfig):
    d0 = embedding_dim(cfg.d_in, cfg.multires) if cfg.multires > 0 else cfg.d_in
    skips = tuple(cfg.skip_in)
    n_lin = cfg.n_layers + 1
    if (cfg.d_in != 3 or cfg.multires <= 0 or d0 > EMB or cfg.d_hidden != HID
            or len(skips) > 1 or any(not 1 <= s <= n_lin - 2 for s in skips)):
        raise ValueError(
            f"the sdf_rays CUDA kernel supports d_in=3, 0<multires<=7, "
            f"d_hidden={HID} and at most one skip layer inside the net; got {cfg}")
    return d0, (skips[0] if skips else -1), n_lin


def pack_sdf_weights(layers, cfg: SDFConfig, dtype: str):
    """The kernel's buffers: every layer as [K_l, 256] ([in, out]), K_0 = 48
    (PE padded), K_skip = 256 + 48 ([h padded to 256, emb padded to 48]),
    else 256; then the last layer's sdf row as [256]; all flat in `dtype`.
    bf16 blocks are in mma.m16n8k16 B-fragment order (point_pipeline._frag),
    so each 16-row k-step is one 8 KB slab of the kernel's weight ring and
    each warp's 32 columns of it one contiguous kilobyte; f32 blocks stay
    row-major (8 rows a slab). f32x3: each k-step's hi slab (the block in
    bf16) then its lo slab (bf16 of the block less its hi part), both in
    fragment order, then the last row's hi and lo parts. Bias as
    [n_lin, 256] f32. Zero padding keeps the math exact: padded inputs meet
    zero weight rows."""
    d0, skip, n_lin = _check_kernel_shape(cfg)
    dev = layers[0][0].device
    blocks = []
    bias = torch.zeros((n_lin, HID), dtype=torch.float32, device=dev)
    for l, (w, b) in enumerate(layers[:-1]):
        d_in, d_out = w.shape
        if l == 0:
            wp = torch.zeros((EMB, HID), device=dev)
            wp[:d0, :d_out] = w
        elif l == skip:
            h_real = d_in - d0
            wp = torch.zeros((HID + EMB, HID), device=dev)
            wp[:h_real, :d_out] = w[:h_real]
            wp[HID:HID + d0, :d_out] = w[h_real:]
        else:
            wp = torch.zeros((HID, HID), device=dev)
            wp[:d_in, :d_out] = w
        if dtype == "f32x3":
            hi, lo = _split(wp)
            blocks.append(torch.stack([_frag(hi).reshape(-1, 16 * HID),
                                       _frag(lo).reshape(-1, 16 * HID)], 1).reshape(-1))
        else:
            blocks.append(_frag(wp) if dtype == "bfloat16" else wp.reshape(-1))
        bias[l, :d_out] = b
    w_last, b_last = layers[-1]
    blocks.extend(_split(w_last[:, 0]) if dtype == "f32x3" else [w_last[:, 0]])
    bias[n_lin - 1, 0] = b_last[0]
    torch_dtype = torch.float32 if dtype == "float32" else torch.bfloat16
    return torch.cat([t.to(torch_dtype) for t in blocks]).contiguous(), bias.contiguous()


def resolve_sweep_weights(params, cfg: SDFConfig, dtype: str = "bfloat16",
                          act: str = "softplus") -> SweepWeights:
    """Resolve weight norm once per step (no grad: the sweep only places
    samples) and, for CUDA weights, pack the kernel's buffers."""
    if dtype not in ("bfloat16", "float32", "f32x3") or act not in ("softplus", "relu") \
            or (dtype == "f32x3" and act != "softplus"):
        raise ValueError(f"sweep dtype={dtype!r} act={act!r}")
    n_lin = cfg.n_layers + 1
    with torch.no_grad():
        layers = []
        for l in range(n_lin):
            w, b = resolve_linear(params[f"lin{l}"])
            if l == n_lin - 1:
                w, b = w[:1], b[:1]
            layers.append((w.detach().float().T.contiguous(), b.detach().float()))
        sw = SweepWeights(cfg, layers, dtype, act)
        if layers[0][0].is_cuda:
            sw.packed, sw.bias = pack_sdf_weights(layers, cfg, dtype)
    return sw


def _softplus100_stable(x: torch.Tensor) -> torch.Tensor:
    # the kernel's form (softplus_sweep): max(x,0) + log1p(exp(-100|x|)) * 0.01,
    # a multiply where a divide by 100 would take the card's slow path on
    # denormal log terms
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-100.0 * torch.abs(x))) * 0.01


def _split(x: torch.Tensor):
    """(hi, lo) bf16 parts of f32 x as f32: hi = bf16(x), lo = bf16(x - hi)
    (sdf_mlp.py::_sdf_layers' _split)."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def x3_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in three products of bf16-valued parts, hi.hi + hi.lo + lo.hi
    summed in f32 (sdf_mlp.py::_sdf_layers, prec='f32x3')."""
    (x_hi, x_lo), (w_hi, w_lo) = _split(x), _split(w)
    return x_hi @ w_hi + x_hi @ w_lo + x_lo @ w_hi


def inv_scale(cfg: SDFConfig) -> float:
    """1 / scale rounded to f32, as the kernel's launch computes it."""
    return float(np.float32(1.0) / np.float32(cfg.scale))


def sdf_mlp_plain(sw: SweepWeights, pts: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch SDF MLP on points [N, 3] -> [N], the kernel's
    arithmetic op for op."""
    cfg = sw.cfg
    emb = positional_encoding(pts * cfg.scale, cfg.multires)
    bf16 = sw.dtype == "bfloat16"
    h = emb
    n_lin = len(sw.layers)
    for l, (w, b) in enumerate(sw.layers):
        if l in cfg.skip_in:
            h = torch.cat([h, emb], dim=-1) * _INV_SQRT2
        if sw.dtype == "f32x3":
            h = x3_product(h, w) + b
        else:
            if bf16:
                h = h.to(torch.bfloat16).float()
                w = w.to(torch.bfloat16).float()
            h = h @ w + b
        if l < n_lin - 1:
            h = torch.relu(h) if sw.act == "relu" else _softplus100_stable(h)
    return h[:, 0] * inv_scale(cfg)


def sdf_rays_plain(sw: SweepWeights, rays_o, rays_d, z) -> torch.Tensor:
    """Plain PyTorch sweep, the kernel's arithmetic op for op."""
    R, S = z.shape
    pts = (rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]).reshape(-1, 3)
    return sdf_mlp_plain(sw, pts).reshape(R, S)


def _check(name, t, shape, device):
    if t.dtype != torch.float32 or not t.is_contiguous() or t.device != device \
            or tuple(t.shape) != tuple(shape):
        raise ValueError(f"sdf_rays: {name} must be a contiguous float32 tensor of "
                         f"shape {tuple(shape)} on {device}; got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def launch_sdf_rays(sw: SweepWeights, rays_o, rays_d, z) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; returns sdf [R, S]."""
    if sw.packed is None:
        raise ValueError("sdf_rays: weights were resolved on the CPU")
    if sw.dtype == "f32x3":
        raise ValueError("sdf_rays: f32x3 is the grid SDF's mode (sdf_mlp.py), not the sweep's")
    R, S = z.shape
    dev = z.device
    _check("rays_o", rays_o, (R, 3), dev)
    _check("rays_d", rays_d, (R, 3), dev)
    _check("z", z, (R, S), dev)
    if sw.packed.device != dev or sw.bias.device != dev:
        raise ValueError("sdf_rays: weights and rays are on different devices")
    d0, skip, n_lin = _check_kernel_shape(sw.cfg)
    lib = _library()
    out = torch.empty((R, S), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.sdf_rays_launch(
        rays_o.data_ptr(), rays_d.data_ptr(), z.data_ptr(), sw.packed.data_ptr(),
        sw.bias.data_ptr(), out.data_ptr(), R * S, S, n_lin, skip, d0,
        float(sw.cfg.scale), int(sw.dtype == "bfloat16"), int(sw.act == "relu"), stream)
    if rc != 0:
        raise RuntimeError(f"sdf_rays kernel launch failed: CUDA error {rc} "
                           f"({lib.sdf_rays_error_string(rc).decode()})")
    launch_sdf_rays.launches += 1
    return out


launch_sdf_rays.launches = 0


def _library():
    from color_neus_torch.ops.kernels import build
    lib = build.load(KERNEL)
    if lib.sdf_rays_launch.argtypes is None:
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.sdf_rays_launch.argtypes = [p, p, p, p, p, p, ll, i, i, i, i, f, i, i, p]
        lib.sdf_rays_launch.restype = ctypes.c_int
        lib.sdf_points_launch.argtypes = [p, p, p, p, ll, i, i, i, f, i, p]
        lib.sdf_points_launch.restype = ctypes.c_int
        # chip_smoke.py's measurement: the resident blocks per SM of a variant
        lib.sdf_rays_blocks_per_sm.argtypes = [i, i, i]
        lib.sdf_rays_blocks_per_sm.restype = ctypes.c_int
        lib.sdf_rays_error_string.argtypes = [i]
        lib.sdf_rays_error_string.restype = ctypes.c_char_p
    return lib


def make_fused_sdf_rays_fn(params, cfg: SDFConfig, dtype: str = "bfloat16",
                           act: str = "softplus"):
    """Returns sdf_fn(rays_o, rays_d, z) -> sdf [R, S]: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors. Weights are resolved
    (and packed) once, here, shared by every sweep of the step, and kept
    as sdf_fn.weights."""
    sw = resolve_sweep_weights(params, cfg, dtype, act)

    def sdf_fn(rays_o, rays_d, z):
        rays_o, rays_d, z = rays_o.contiguous(), rays_d.contiguous(), z.contiguous()
        if z.is_cuda:
            return launch_sdf_rays(sw, rays_o, rays_d, z)
        return sdf_rays_plain(sw, rays_o, rays_d, z)

    sdf_fn.weights = sw
    return sdf_fn


def resolve_sdf_sweep_fn(params, cfg: SDFConfig, mode: str = "auto",
                         dtype: str = "bfloat16", act: str = "softplus"):
    """The sweep evaluator for RendererConfig.fused_sdf: None for 'off'
    (the caller evaluates fields.sdf_value on the points), else the fused
    sweep (kernel on CUDA, plain version on the CPU)."""
    if mode == "off":
        return None
    if mode not in ("auto", "on"):
        raise ValueError(f"fused_sdf={mode!r} not in ('auto', 'on', 'off')")
    return make_fused_sdf_rays_fn(params, cfg, dtype=dtype, act=act)
