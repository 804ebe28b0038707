"""The fused ray march, the training loss path's render core: counterpart
of color_neus_tpu/ops/pallas/ray_march.py (fused_ray_march and its
custom_vjp _march_core).

Per ray it maps (rays_o, rays_d, z [R, S], inv_s) to the [R, 16] loss
partials: 0:3 the composited colour sum w relit, 3 the weight sum, 4 the
sum of delta, 5 / 6 the eikonal numerator and denominator over |p| < 1.2,
9 zero lanes. NeuS compositing with cos_anneal_ratio 0, no background; z
is a constant (the hierarchy is no-grad). Gradients flow to every weight,
to the rays and to inv_s.

The backward either recomputes the layer activations (JAX's march_acts
recompute) or, in the save mode (save), loads them from a stash the
forward wrote; resolve_save_acts picks the mode as JAX does ('auto' saves
when JAX's count of the stash, policy_stash_bytes, fits the budget; the
kernel's own stash, march_stash_bytes, is smaller). Forward, two
implementations of
one function:
  * launch_ray_march: the first entry of the hand-written CUDA source
    csrc/ray_march.cu (its note gives the bound and the design); it also
    returns the per-point stash (sdf, grad, relit, delta sum) its backward
    reads. launch_ray_march_save: its save entry, which also writes the
    activation stash (act_bytes a point). Each counts its launches in its
    own .launches and raises on any build or launch failure.
  * ray_march_plain: the same function in plain PyTorch in the per-ray
    [R, S] layout, the point pipeline's plain twin plus the compositing;
    save=True also returns the plain stash (point_pipeline.ActStash).
Backward (the VJP of the [R, 16] output), likewise:
  * launch_ray_march_bwd: the second entry of csrc/ray_march.cu and the
    fixed-order reduction of its per-block partials (point_pipeline.py's
    reduce_partials); launch_ray_march_bwd_load: its load entry, on the
    save entry's stashes. Each counts its launches in its own .launches.
  * ray_march_bwd_plain: the compositing VJP of ray_march.py:322-371 by
    hand (not autograd), then point_pipeline_bwd_plain (with stash=: on
    the plain stash, no recompute).
Both plain versions run on any device and in float64 as well, and take
the point pipeline's `bf16` flag (True: the kernels' bf16 products and
stash stores, the SDF chain's in the weights' march_bwd_precision). Each
kernel launches the instantiation of that mode (its library
point_pipeline.library_name; its own launch count per mode,
point_pipeline.mode_counters). RayMarchFunction is the autograd Function: the device of
the tensors alone picks the kernels or the plain versions, the resolved
mode the recompute or the save pair; fused_ray_march resolves the weight
norm and the mode outside it.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from color_neus_torch.models.configs import RendererConfig
from color_neus_torch.models.fields import resolve_linear
from color_neus_torch.ops.embedding import embedding_dim
from color_neus_torch.ops.kernels import point_pipeline as PP

KERNEL = "ray_march"
STASH = 8          # per point in the forward's stash (both modes): sdf, grad (3), relit (3),
                   # delta sum; the save mode adds the activation stash (act_bytes)
STASH_BUDGET_GB = 13.5   # the device memory 'auto' lets the save mode's stashes take (JAX's)
_MAX_BLOCKS: dict = {}   # (device, mode, entry, save) -> blocks resident at once


def march_points(rays_o, rays_d, z, sample_dist: float):
    """(dists [R,S], mid z [R,S], pts [R S, 3], dirs [R S, 3]): section
    lengths with the trailing sample_dist, the mid points and their view
    dirs (ray_march.py:145-153)."""
    d = z[:, 1:] - z[:, :-1]
    dists = torch.cat([d, torch.full_like(d[:, :1], sample_dist)], dim=-1)
    mid = z + dists * 0.5
    R, S = z.shape
    pts = rays_o[:, None, :] + rays_d[:, None, :] * mid[..., None]
    dirs = rays_d[:, None, :].expand(R, S, 3)
    return dists, mid, pts.reshape(-1, 3).contiguous(), dirs.reshape(-1, 3).contiguous()


@dataclass
class Composite:
    """The compositing quantities of every point, [R, S] each
    (ray_march.py:158-174)."""
    tc: torch.Tensor
    u: torch.Tensor
    ep: torch.Tensor
    en: torch.Tensor
    pc: torch.Tensor
    nc: torch.Tensor
    q: torch.Tensor
    alpha: torch.Tensor
    xv: torch.Tensor
    Tr: torch.Tensor
    w: torch.Tensor
    relaxed: torch.Tensor
    normg: torch.Tensor


def composite(outs, rays_d, dists, pts, inv_s) -> Composite:
    """NeuS compositing of the per-point outputs (sdf, grad, gc, relit,
    delta) of R rays of S samples each."""
    R, S = dists.shape
    sdf = outs[0].reshape(R, S)
    grad = outs[1].reshape(R, S, 3)
    tc = torch.sum(rays_d[:, None, :] * grad, dim=-1)
    u = -tc * 0.5 + 0.5
    ic = -torch.clamp_min(u, 0.0)
    ep = sdf - ic * dists * 0.5
    en = sdf + ic * dists * 0.5
    pc = torch.sigmoid(ep * inv_s)
    nc = torch.sigmoid(en * inv_s)
    q = (pc - nc + 1e-5) / (pc + 1e-5)
    alpha = torch.clamp(q, 0.0, 1.0)
    xv = 1.0 - alpha + 1e-7
    Tr = torch.cat([torch.ones_like(xv[:, :1]), torch.cumprod(xv, dim=-1)[:, :-1]], dim=-1)
    relaxed = (torch.linalg.norm(pts, dim=-1).reshape(R, S) < 1.2).to(sdf.dtype)
    normg = torch.linalg.norm(grad, dim=-1)
    return Composite(tc, u, ep, en, pc, nc, q, alpha, xv, Tr, alpha * Tr, relaxed, normg)


def out16(outs, c: Composite) -> torch.Tensor:
    """The [R, 16] per-ray loss partials."""
    R, S = c.w.shape
    relit = outs[3].reshape(R, S, 3)
    delta = outs[4].reshape(R, S, 3)
    cols = [torch.sum(c.w[..., None] * relit, dim=1), torch.sum(c.w, dim=1, keepdim=True),
            torch.sum(delta, dim=(1, 2))[:, None],
            torch.sum(c.relaxed * (c.normg - 1.0) ** 2, dim=1, keepdim=True),
            torch.sum(c.relaxed, dim=1, keepdim=True)]
    out = torch.cat(cols, dim=1)
    return torch.cat([out, torch.zeros((R, 9), dtype=out.dtype, device=out.device)], dim=1)


def ray_march_plain(pw: PP.PipelineWeights, rays_o, rays_d, z, inv_s, sample_dist: float,
                    bf16: bool = False, save: bool = False):
    """Plain PyTorch forward: [R, 16]. bf16: the point pipeline's products
    in the kernels' (and the TPU kernels') bf16 arithmetic
    (point_pipeline._forward); the compositing stays in the inputs' dtype.
    save: also return the save mode's stash (point_pipeline.ActStash, what
    the save kernel keeps, in its store dtypes when bf16): ([R, 16],
    stash)."""
    with torch.no_grad():
        dists, _, pts, dirs = march_points(rays_o, rays_d, z, sample_dist)
        outs, st = PP._forward(pw, pts, dirs, bf16)
        out = out16(outs, composite(outs, rays_d, dists, pts, inv_s))
        return (out, PP.stash_activations(pw.rcfg, outs, st, bf16)) if save else out


def composite_vjp(outs, c: Composite, rays_d, dists, inv_s, gbar):
    """The compositing VJP by hand (ray_march.py:322-356): the cotangents
    of the five per-point outputs ([R S, k] each, gc's zero), inv_s's, and
    tc_bar [R, S]."""
    R, S = c.w.shape
    relit = outs[3].reshape(R, S, 3)
    grad = outs[1].reshape(R, S, 3)
    cbar, wsum_bar, dsum_bar, ekn_bar = gbar[:, None, 0:3], gbar[:, 3:4], gbar[:, 4:5], gbar[:, 5:6]
    relit_hat = c.w[..., None] * cbar
    delta_hat = dsum_bar[..., None].expand(R, S, 3)
    w_bar = torch.sum(relit * cbar, dim=-1) + wsum_bar
    x = w_bar * c.w
    G = torch.flip(torch.cumsum(torch.flip(x, [1]), dim=1), [1]) - x   # sum over later samples
    alpha_bar = w_bar * c.Tr - G / c.xv
    one, half, zero = (torch.tensor(v, dtype=c.q.dtype, device=c.q.device)
                       for v in (1.0, 0.5, 0.0))
    # clip(q, 0, 1)'s cotangent: 0.5 at the bounds, jax.lax.clamp's rule
    gate = (torch.where(c.q < 1.0, one, torch.where(c.q == 1.0, half, zero))
            * torch.where(c.q > 0.0, one, torch.where(c.q == 0.0, half, zero)))
    q_bar = alpha_bar * gate
    pc_bar = q_bar * (1.0 - c.q) / (c.pc + 1e-5)
    nc_bar = -q_bar / (c.pc + 1e-5)
    dpc = c.pc * (1.0 - c.pc)
    dnc = c.nc * (1.0 - c.nc)
    ep_bar = pc_bar * dpc * inv_s
    en_bar = nc_bar * dnc * inv_s
    sinv_hat = torch.sum(pc_bar * dpc * c.ep + nc_bar * dnc * c.en)
    sdf_hat = ep_bar + en_bar
    ic_bar = (en_bar - ep_bar) * dists * 0.5
    u_bar = -ic_bar * (c.u > 0.0).to(ic_bar.dtype)
    tc_bar = -0.5 * u_bar
    ek = (ekn_bar * c.relaxed * 2.0 * (c.normg - 1.0))[..., None]
    grad_hat = tc_bar[..., None] * rays_d[:, None, :] + ek * grad / c.normg[..., None]
    cots = [sdf_hat.reshape(-1, 1), grad_hat.reshape(-1, 3),
            torch.zeros_like(grad_hat).reshape(-1, 3), relit_hat.reshape(-1, 3),
            delta_hat.reshape(-1, 3)]
    return cots, sinv_hat, tc_bar


def rays_vjp(pts_hat, dirs_hat, outs, tc_bar, mid):
    """The rays' cotangents from the points' (ray_march.py:363-367):
    (sum of pts_bar, sum of dirs_bar + tc_bar grad + pts_bar mid), [R, 3] each."""
    R, S = mid.shape
    ph = pts_hat.reshape(R, S, 3)
    rd_bar = dirs_hat.reshape(R, S, 3) + tc_bar[..., None] * outs[1].reshape(R, S, 3) \
        + ph * mid[..., None]
    return ph.sum(dim=1), rd_bar.sum(dim=1)


def march_vjp(rays_o, rays_d, z, inv_s, sample_dist, gbar, forward, pullback):
    """The march's VJP composed from a per-point forward (pts, dirs) -> the
    five outputs and a per-point pullback (pts, dirs, cotangents) ->
    (pts_hat, dirs_hat, grads): (rays_o_hat, rays_d_hat, inv_s_hat, grads)."""
    dists, mid, pts, dirs = march_points(rays_o, rays_d, z, sample_dist)
    outs = forward(pts, dirs)
    c = composite(outs, rays_d, dists, pts, inv_s)
    cots, sinv_hat, tc_bar = composite_vjp(outs, c, rays_d, dists, inv_s, gbar)
    pts_hat, dirs_hat, grads = pullback(pts, dirs, cots)
    ro_hat, rd_hat = rays_vjp(pts_hat, dirs_hat, outs, tc_bar, mid)
    return ro_hat, rd_hat, sinv_hat, grads


def ray_march_bwd_plain(pw: PP.PipelineWeights, rays_o, rays_d, z, inv_s, sample_dist, gbar,
                        bf16: bool = False, stash: PP.ActStash | None = None):
    """Plain PyTorch VJP of the march (not autograd): (rays_o_hat [R,3],
    rays_d_hat [R,3], inv_s_hat (0-d), {"sdf" / "color" / "relight": [(dW,
    db) per layer]}); bf16 as ray_march_plain. stash: the save mode's, from
    ray_march_plain(..., save=True) on the same inputs and bf16: its
    outputs feed the compositing VJP, and the pullback reads its
    activations instead of recomputing the point pipeline."""
    with torch.no_grad():
        return march_vjp(rays_o, rays_d, z, inv_s, sample_dist, gbar,
                         (lambda p, d: PP.point_pipeline_plain(pw, p, d, bf16)) if stash is None
                         else (lambda p, d: stash.outs),
                         lambda p, d, cots: PP.point_pipeline_bwd_plain(pw, p, d, cots, bf16,
                                                                        stash=stash))


def march_macs_per_point(pw: PP.PipelineWeights, save: bool = False):
    """(forward, backward) multiply-adds per point of the march kernels at
    the networks' real widths (the counterpart of
    march_gemm_flops_per_point): the forward is the point pipeline's (SDF,
    its reverse sweep, colour, relight); the backward dW and xbar of every
    colour and relight layer, the SDF tangent stream, dW and xbar of the
    last SDF layer, two dW and two xbar products per hidden SDF layer, the
    second (lo) bf16 pass of layer 0's two dW products (but in
    march_bwd_precision 'f32', whose SDF products are f32), and, unless
    save (the save mode loads the activations), one recompute of the
    forward."""
    def macs(layers):
        return sum(w.shape[0] * w.shape[1] for w, _ in layers)
    hidden = macs(pw.sdf[:-1])
    lo = 0 if pw.rcfg.march_bwd_precision == "f32" else 2 * macs(pw.sdf[:1])
    fwd = macs(pw.sdf) + hidden + macs(pw.color) + macs(pw.relight)
    pull = 2 * (macs(pw.color) + macs(pw.relight)) + hidden + 2 * macs(pw.sdf[-1:]) \
        + 4 * hidden + lo
    return fwd, pull + (0 if save else fwd)


def _net_counts(net) -> tuple:
    """(n_sdf, n_color, n_relight) linear layers of a PipelineWeights' or
    a RendererConfig's nets."""
    counts = PP._layer_counts(getattr(net, "rcfg", net))
    return counts["sdf"], counts["color"], counts["relight"]


def act_row_bytes(net) -> int:
    """Bytes a point's row of the save mode's activation stash, the
    kernel's layout (csrc/point_pipeline_tile.cuh act_layout): the softplus
    of every hidden SDF layer, 256 wide, in f32 (in bf16 under
    march_bwd_precision 'bf16', JAX's march_stash_bytes); a tail of 8 f32:
    gc, delta, the transmittance T before the sample (the forward's, which
    the load entry's compositing VJP reads), 0."""
    n_sdf, _, _ = _net_counts(net)
    sx = 2 if getattr(net, "rcfg", net).march_bwd_precision == "bf16" else 4
    return (n_sdf - 1) * PP.HID * sx + 32


def act_cr_slots(net) -> int:
    """The stash's bf16 slots of a point: the features and the colour /
    relight hidden layers' outputs, 256 wide each (act_layout's cr)."""
    _, n_color, n_relight = _net_counts(net)
    return n_color + max(n_relight - 1, 0)


def act_bytes(net) -> int:
    """Bytes a point of the save mode's activation stash where its 64-point
    backward tiles are full (every S a multiple of 64): its row and its cr
    slots, which the stash keeps in the flush's operand layout, a [256 k]
    [64 points] bf16 image per slot and tile (act_total_bytes)."""
    return act_row_bytes(net) + act_cr_slots(net) * PP.HID * 2


def rays_per_group(S: int) -> int:
    """Rays a group of every march kernel (csrc/ray_march.cu
    rays_per_group): whole rays filling a 128-point forward tile, whose
    halves are the backward's 64-point tiles."""
    return 1 if S >= 128 else 128 // S


def act_total_bytes(net, R: int, S: int) -> int:
    """Bytes of the save mode's activation stash for R rays of S samples
    (act_layout): the points' rows, then, from a 1024-byte boundary, the cr
    images of every 64-point backward tile (a group of rays_per_group(S)
    rays as ceil(G S / 64) tiles; a partial tile's padding points take
    their bytes too)."""
    G = rays_per_group(S)
    tiles = -(-R // G) * -(-G * S // 64)
    rows = -(-R * S * act_row_bytes(net) // 1024) * 1024
    return rows + tiles * act_cr_slots(net) * PP.HID * 128


def act_cr(net, act: torch.Tensor, R: int, S: int, slot: int | None = None) -> torch.Tensor:
    """The cr slots of a save stash (uint8 [act_total_bytes], on any
    device), each point's read out of its tile's image, in f32: [R S,
    act_cr_slots, 256], or [R S, 256] of one slot."""
    row, n_cr, hid = act_row_bytes(net), act_cr_slots(net), PP.HID
    n, dev = R * S, act.device
    off = -(-n * row // 1024) * 1024
    G = rays_per_group(S)
    tpg = -(-G * S // 64)
    img = act[off:off + -(-R // G) * tpg * n_cr * hid * 128].view(torch.int16)
    img = img.reshape(-1, n_cr, hid, 64)     # tile, slot, row k, its 64 points as stored
    q = torch.arange(n, device=dev)
    r, s = q // S, q % S
    tq = (r % G) * S + s                     # the point in its group
    tile, pt = (r // G) * tpg + tq // 64, tq % 64
    k = torch.arange(hid, device=dev)
    stored = ((pt[:, None] // 8) ^ (k[None, :] % 8)) * 8 + (pt % 8)[:, None]   # the swizzle

    def one(j):
        bits = img[tile[:, None], j, k[None, :], stored].to(torch.int32)
        return (bits << 16).view(torch.float32)
    return one(slot) if slot is not None else torch.stack([one(j) for j in range(n_cr)], 1)


def unpack_act(net, act: torch.Tensor, R: int, S: int) -> tuple:
    """A save stash (uint8 [act_total_bytes]) as (its points' rows [R S,
    act_row_bytes] uint8, its cr slots [R S, act_cr_slots, 256] f32:
    act_cr)."""
    row = act_row_bytes(net)
    return act[:R * S * row].reshape(R * S, row), act_cr(net, act, R, S)


def march_stash_bytes(net, n_pts: int, S: int | None = None) -> int:
    """Device bytes the save mode's stashes take for n_pts points: the
    activation stash and the 8-float outs stash (the recompute keeps only
    the latter); with S (n_pts a multiple of it), for rays of S samples,
    a partial tile's padding included. net: a PipelineWeights or a
    RendererConfig."""
    if S is not None:
        return act_total_bytes(net, n_pts // S, S) + n_pts * STASH * 4
    return n_pts * (act_bytes(net) + STASH * 4)


def _rup(x: int) -> int:
    return (x + 127) // 128 * 128


def stash_lane_widths(net) -> tuple:
    """(DX, DCR, DG): the lane widths of JAX's save-mode stash tensors
    (point_pipeline.py stash_lane_widths), rebuilt from the widths: every
    stored SDF layer input (layer 0's PE and the skip's PE half are
    rebuilt, not stored), the colour net's feature and hidden inputs and
    the relight net's hidden inputs, each padded to 128 lanes; the outs
    plane (sdf, grad, colour, relit, delta) padded to 128 f32 lanes."""
    rcfg = getattr(net, "rcfg", net)
    sdf, color, rl = rcfg.sdf, rcfg.color, rcfg.relight
    d0 = embedding_dim(3, sdf.multires) if sdf.multires > 0 else 3
    dims = [d0] + [sdf.d_hidden] * sdf.n_layers + [sdf.d_out]
    # layer l's stored input: the previous layer's output, padded (the
    # skip layer's h half: its input less the PE)
    dx = sum(_rup(dims[l] - d0 if l in sdf.skip_in else dims[l])
             for l in range(1, sdf.n_layers + 1))
    dcr = _rup(sdf.d_out - 1) + color.n_layers * _rup(color.d_hidden)
    if rcfg.kind == "color_neus":
        dcr += rl.n_layers * _rup(rl.d_hidden)
    return dx, dcr, 128


def policy_stash_bytes(net, n_pts: int) -> int:
    """JAX's march_stash_bytes: the bytes 'auto' weighs against the budget
    (its SX stash in bf16 under march_bwd_precision 'bf16', else f32; SCR
    bf16; SG f32). Its outs plane takes 128 f32 lanes where the kernel's
    layout keeps 8 floats, so it exceeds the kernel's own stash
    (march_stash_bytes); 'auto' decides on it so that the port picks the
    backward JAX picks at every shape."""
    dx, dcr, dg = stash_lane_widths(net)
    sx = 2 if getattr(net, "rcfg", net).march_bwd_precision == "bf16" else 4
    return n_pts * (dx * sx + dcr * 2 + dg * 4)


def resolve_save_acts(policy, net, n_pts: int, budget_gb: float | None = None) -> bool:
    """The march's backward for a march_acts policy (JAX ray_march.py
    resolve_save_acts): 'save' / True and 'recompute' / False / None pass
    through; 'auto' saves when policy_stash_bytes fits the budget in GiB
    (the environment's MARCH_STASH_BUDGET_GB first, then budget_gb, then
    STASH_BUDGET_GB), else recomputes; anything else raises ValueError."""
    if policy in (True, "save"):
        return True
    if policy in (False, "recompute", None):
        return False
    if policy != "auto":
        raise ValueError(f"march_acts policy {policy!r} not in ('auto', 'save', 'recompute')")
    if "MARCH_STASH_BUDGET_GB" in os.environ:
        budget_gb = float(os.environ["MARCH_STASH_BUDGET_GB"])
    elif budget_gb is None:
        budget_gb = STASH_BUDGET_GB
    return policy_stash_bytes(net, n_pts) <= budget_gb * 1024 ** 3


def partial_stride(n_grad: int) -> int:
    """Floats a block's partial takes in the backward (csrc/ray_march.cu
    partial_stride): the weight grads, inv_s's, padding to a multiple of
    4 (16 bytes)."""
    return (n_grad + 4) // 4 * 4


def _library(mode: str = "f32stash", name: str | None = None):
    """The loaded library of a march_bwd_precision mode's kernels (name:
    another build of that mode's source, build.ABLATIONS)."""
    from color_neus_torch.ops.kernels import build
    lib = build.load(name or PP.library_name(KERNEL, mode))
    if lib.ray_march_fwd_launch.argtypes is None:
        p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        net = [i, i, i, f, i, i, i, i, i, i, i, p, p, i]
        lib.ray_march_fwd_launch.argtypes = [p] * 10 + [ll, i, f, i] + net + [p]
        lib.ray_march_bwd_launch.argtypes = [p] * 12 + [ll, i, f, i, ll, i] + net + [p]
        for fn in (lib.ray_march_fwd_launch, lib.ray_march_bwd_launch, lib.ray_march_n_off,
                   lib.ray_march_rays_per_group, lib.ray_march_act_row_bytes,
                   lib.ray_march_act_cr_slots):
            fn.restype = i
        lib.ray_march_rays_per_group.argtypes = [i]
        lib.ray_march_act_row_bytes.argtypes = [i, i, i]
        lib.ray_march_act_cr_slots.argtypes = [i, i, i]
        lib.ray_march_act_total_bytes.argtypes = [i, i, i, ll, i]
        lib.ray_march_act_total_bytes.restype = ll
        for fn in (lib.ray_march_fwd_max_blocks, lib.ray_march_bwd_max_blocks):
            fn.argtypes = [i, ctypes.POINTER(i)]
            fn.restype = i
        lib.ray_march_fwd_scratch_floats.argtypes = [i, i]
        lib.ray_march_bwd_scratch_floats.argtypes = [i] * 8
        for fn in (lib.ray_march_fwd_scratch_floats, lib.ray_march_bwd_scratch_floats):
            fn.restype = ll
        lib.ray_march_partial_stride.argtypes = [ll]
        lib.ray_march_partial_stride.restype = ll
        lib.ray_march_error_string.argtypes = [i]
        lib.ray_march_error_string.restype = ctypes.c_char_p
        lib.ray_march_prec.restype = i
        if lib.ray_march_n_off() != PP.N_OFF:
            raise RuntimeError("ray_march: the kernel's offset table does not match")
        if lib.ray_march_prec() != PP.MODES.index(mode):
            raise RuntimeError(f"ray_march: the {mode} library computes another mode")
    return lib


def _raise_on(lib, rc, what):
    if rc != 0:
        raise RuntimeError(f"ray_march {what} failed: CUDA error {rc} "
                           f"({lib.ray_march_error_string(rc).decode()})")


def _max_blocks(lib, dev, mode: str, entry: str, save: bool) -> int:
    key = (dev, lib._name, mode, entry, save)
    if key not in _MAX_BLOCKS:
        nb = ctypes.c_int(0)
        with torch.cuda.device(dev):
            rc = getattr(lib, f"ray_march_{entry}_max_blocks")(int(save), ctypes.byref(nb))
        _raise_on(lib, rc, "occupancy query")
        _MAX_BLOCKS[key] = nb.value
    return _MAX_BLOCKS[key]


def _act_bytes(lib, pw: PP.PipelineWeights, R: int, S: int) -> int:
    """act_total_bytes(pw, R, S), checked against the kernel's layout."""
    n = act_total_bytes(pw, R, S)
    counts = _net_counts(pw)
    if (lib.ray_march_act_total_bytes(*counts, R, S) != n
            or lib.ray_march_act_row_bytes(*counts) != act_row_bytes(pw)
            or lib.ray_march_act_cr_slots(*counts) != act_cr_slots(pw)):
        raise RuntimeError("ray_march: the kernel's activation stash layout does not match")
    return n


def _check_inputs(pw: PP.PipelineWeights, rays_o, rays_d, z, inv_s):
    if pw.packed is None:
        raise ValueError("ray_march: weights were resolved on the CPU")
    R, S = z.shape
    dev = z.device
    PP._check("rays_o", rays_o, R, dev)
    PP._check("rays_d", rays_d, R, dev)
    PP._check("z", z, R, dev, S)
    if inv_s.dtype != torch.float32 or inv_s.numel() != 1 or inv_s.device != dev:
        raise ValueError(f"ray_march: inv_s must be one float32 on {dev}")
    if pw.packed.device != dev:
        raise ValueError("ray_march: weights and rays are on different devices")
    return R, S, dev


def _groups(lib, R, S) -> int:
    """The ray groups of the march kernels' tiles."""
    return -(-R // lib.ray_march_rays_per_group(S))


def _fwd(pw: PP.PipelineWeights, rays_o, rays_d, z, inv_s, sample_dist: float, save: bool,
         lib=None):
    """Launch the forward kernel (save: the save mode's) of the weights'
    mode (or of `lib`, a _library) on the current stream: (out [R, 16],
    the stash [R S, 8] its backward reads, the activation stash
    [act_total_bytes] uint8 or None)."""
    R, S, dev = _check_inputs(pw, rays_o, rays_d, z, inv_s)
    lib = lib if lib is not None else _library(PP._mode(pw))
    tables, images, net = PP._net_args(pw)
    out = torch.empty((R, 16), dtype=torch.float32, device=dev)
    stash = torch.empty((R * S, STASH), dtype=torch.float32, device=dev)
    act = torch.empty(_act_bytes(lib, pw, R, S), dtype=torch.uint8, device=dev) if save else None
    if R == 0:
        return out, stash, act
    grid = min(_groups(lib, R, S), _max_blocks(lib, dev, PP._mode(pw), "fwd", save))
    scratch = torch.empty(grid * lib.ray_march_fwd_scratch_floats(net[0], int(save)),
                          dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ray_march_fwd_launch(
            rays_o.data_ptr(), rays_d.data_ptr(), z.data_ptr(), inv_s.data_ptr(),
            pw.packed.data_ptr(), images.data_ptr(), out.data_ptr(), stash.data_ptr(),
            act.data_ptr() if save else None, scratch.data_ptr(), R, S, sample_dist, grid,
            *net, stream)
    _raise_on(lib, rc, "save kernel launch" if save else "kernel launch")
    return out, stash, act


def launch_ray_march(pw: PP.PipelineWeights, rays_o, rays_d, z, inv_s, sample_dist: float):
    """Launch the forward kernel on the current stream; returns (out [R,
    16], the stash [R S, 8] its backward reads)."""
    out, stash, _ = _fwd(pw, rays_o, rays_d, z, inv_s, sample_dist, False)
    PP._counter(launch_ray_march, pw).launches += 1
    return out, stash


launch_ray_march.launches = 0
launch_ray_march.modes = {"bf16": PP.ModeLaunches(), "f32": PP.ModeLaunches()}


def launch_ray_march_save(pw: PP.PipelineWeights, rays_o, rays_d, z, inv_s,
                          sample_dist: float):
    """Launch the save mode's forward kernel on the current stream;
    returns (out [R, 16], the stash [R S, 8], the activation stash
    [act_total_bytes] uint8), which launch_ray_march_bwd_load reads."""
    out = _fwd(pw, rays_o, rays_d, z, inv_s, sample_dist, True)
    PP._counter(launch_ray_march_save, pw).launches += 1
    return out


launch_ray_march_save.launches = 0
launch_ray_march_save.modes = {"bf16": PP.ModeLaunches(), "f32": PP.ModeLaunches()}


def _bwd(pw: PP.PipelineWeights, rays_o, rays_d, z, inv_s, sample_dist: float, stash, act,
         gbar, lib=None):
    """Launch the backward kernel (act not None: the save mode's, which
    loads it) of the weights' mode (or of `lib`) and the reduction on the
    current stream."""
    R, S, dev = _check_inputs(pw, rays_o, rays_d, z, inv_s)
    PP._check("stash", stash, R * S, dev, STASH)
    PP._check("gbar", gbar, R, dev, 16)
    lib = lib if lib is not None else _library(PP._mode(pw))
    save = act is not None
    if save and (act.dtype != torch.uint8 or not act.is_contiguous() or act.device != dev
                 or tuple(act.shape) != (_act_bytes(lib, pw, R, S),)):
        raise ValueError(f"ray_march: act must be launch_ray_march_save's "
                         f"[{act_total_bytes(pw, R, S)}] uint8 on {dev}; got {act.dtype} "
                         f"{tuple(act.shape)} on {act.device}")
    rays_hat = torch.empty((R, 8), dtype=torch.float32, device=dev)
    if R == 0:
        return rays_hat[:, 0:3], rays_hat[:, 4:7], torch.zeros(1, device=dev), \
            torch.zeros(pw.n_grad, device=dev)
    groups = _groups(lib, R, S)
    grid = min(groups, _max_blocks(lib, dev, PP._mode(pw), "bwd", save))
    G = lib.ray_march_rays_per_group(S)
    batch = PP.dw_batch(-(-groups // grid) * -(-G * S // 64), 1)
    tables, images, net = PP._net_args(pw)
    # per block: the recompute's gates, tangent stream and colour / relight
    # inputs (the load's tangent stream alone), the weight-grad operands of
    # `batch` tiles, the group's per-point cotangents; and a partial of the
    # weight grads (the packed layout) and of inv_s's, padded to 16 bytes a
    # row (partial_stride: the flush's vector reductions), summed afterwards
    per_block = lib.ray_march_bwd_scratch_floats(*PP._shape_args(net), S, batch, int(save))
    scratch = torch.empty(grid * per_block, dtype=torch.float32, device=dev)
    # (the load entry zeroes what its first flush does not store)
    partial = (torch.empty if save else torch.zeros)((grid, partial_stride(pw.n_grad)),
                                                     dtype=torch.float32, device=dev)
    if lib.ray_march_partial_stride(pw.n_grad) != partial.shape[1]:
        raise RuntimeError("ray_march: the kernel's partial stride does not match")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ray_march_bwd_launch(
            rays_o.data_ptr(), rays_d.data_ptr(), z.data_ptr(), inv_s.data_ptr(),
            pw.packed.data_ptr(), images.data_ptr(), stash.data_ptr(),
            act.data_ptr() if save else None, gbar.data_ptr(), rays_hat.data_ptr(),
            partial.data_ptr(), scratch.data_ptr(), R, S, sample_dist, grid, pw.n_grad, batch,
            *net, stream)
    _raise_on(lib, rc, "load backward kernel launch" if save else "backward kernel launch")
    total = PP.reduce_partials(partial)
    return rays_hat[:, 0:3], rays_hat[:, 4:7], total[pw.n_grad:pw.n_grad + 1], total[:pw.n_grad]


def launch_ray_march_bwd(pw: PP.PipelineWeights, rays_o, rays_d, z, inv_s, sample_dist: float,
                         stash, gbar):
    """Launch the backward kernel and the reduction on the current stream.
    stash: launch_ray_march's on the same inputs; gbar [R, 16]. Returns
    (rays_o_hat [R,3], rays_d_hat [R,3], inv_s_hat [1], the weight grads
    [n_grad] in the packed layout: point_pipeline._unpack_grads)."""
    out = _bwd(pw, rays_o, rays_d, z, inv_s, sample_dist, stash, None, gbar)
    PP._counter(launch_ray_march_bwd, pw).launches += 1
    return out


launch_ray_march_bwd.launches = 0
launch_ray_march_bwd.modes = {"bf16": PP.ModeLaunches(), "f32": PP.ModeLaunches()}


def launch_ray_march_bwd_load(pw: PP.PipelineWeights, rays_o, rays_d, z, inv_s,
                              sample_dist: float, stash, act, gbar):
    """Launch the save mode's backward kernel, which loads the layer
    activations from act instead of recomputing them, and the reduction.
    stash, act: launch_ray_march_save's on the same inputs; returns as
    launch_ray_march_bwd."""
    out = _bwd(pw, rays_o, rays_d, z, inv_s, sample_dist, stash, act, gbar)
    PP._counter(launch_ray_march_bwd_load, pw).launches += 1
    return out


launch_ray_march_bwd_load.launches = 0
launch_ray_march_bwd_load.modes = {"bf16": PP.ModeLaunches(), "f32": PP.ModeLaunches()}


class RayMarchFunction(torch.autograd.Function):
    """The march with its hand-written VJP (JAX _march_core).
    apply(rcfg, save, rays_o, rays_d, z_vals, inv_s, *flat) -> [R, 16],
    with save the resolved mode (resolve_save_acts) and flat the resolved
    (w, b) of every layer, sdf then colour then relight; z gets no
    gradient. Forward: row 3's kernel (CUDA; save: its save entry, which
    also writes the activation stash) or ray_march_plain (CPU; save: its
    stash too); backward: row 4's kernel on the forward's stashes (save: its
    load entry) or ray_march_bwd_plain (CPU; save: on the plain stash), the
    device alone deciding between kernel and plain version."""

    @staticmethod
    def forward(ctx, rcfg, save, rays_o, rays_d, z_vals, inv_s, *flat):
        pw = PP._make_weights(rcfg, PP._split_layers(rcfg, flat))
        ro, rd, z = (t.detach().float().contiguous() for t in (rays_o, rays_d, z_vals))
        s = inv_s.detach().float().reshape(1).contiguous()
        sample_dist = 2.0 / rcfg.n_samples
        ctx.pw, ctx.ro, ctx.rd, ctx.z, ctx.inv_s = pw, ro, rd, z, s
        ctx.sample_dist, ctx.inv_s_shape, ctx.save = sample_dist, inv_s.shape, save
        ctx.act = None
        if ro.is_cuda:
            if save:
                out, ctx.stash, ctx.act = launch_ray_march_save(pw, ro, rd, z, s, sample_dist)
            else:
                out, ctx.stash = launch_ray_march(pw, ro, rd, z, s, sample_dist)
            return out
        if save:
            out, ctx.stash = ray_march_plain(pw, ro, rd, z, s, sample_dist, save=True)
            return out
        return ray_march_plain(pw, ro, rd, z, s, sample_dist)

    @staticmethod
    @once_differentiable
    def backward(ctx, gbar):
        pw, ro, rd, z, s = ctx.pw, ctx.ro, ctx.rd, ctx.z, ctx.inv_s
        gbar = gbar.float().contiguous()
        if ro.is_cuda:
            if ctx.save:
                ro_hat, rd_hat, s_hat, packed = launch_ray_march_bwd_load(
                    pw, ro, rd, z, s, ctx.sample_dist, ctx.stash, ctx.act, gbar)
            else:
                ro_hat, rd_hat, s_hat, packed = launch_ray_march_bwd(
                    pw, ro, rd, z, s, ctx.sample_dist, ctx.stash, gbar)
            grads = PP._unpack_grads(pw, packed)
        else:
            ro_hat, rd_hat, s_hat, grads = ray_march_bwd_plain(
                pw, ro, rd, z, s, ctx.sample_dist, gbar,
                stash=ctx.stash if ctx.save else None)
        ctx.stash = ctx.act = None
        flat = [t for net in PP._layer_counts(pw.rcfg) for wb in grads[net] for t in wb]
        return (None, None, ro_hat, rd_hat, None, s_hat.reshape(ctx.inv_s_shape), *flat)


def fused_ray_march(params, rcfg: RendererConfig, rays_o, rays_d, z_vals, inv_s,
                    save_acts="auto"):
    """Differentiable [R, 16] loss partials of the rays (JAX
    fused_ray_march): RayMarchFunction on the weights resolved here (the
    weight norm, with grad), the sample_dist of rcfg.n_samples, in the
    backward mode resolve_save_acts gives save_acts (rcfg.march_acts on
    the main path) for R S points under rcfg.march_stash_budget_gb."""
    flat = [t for net, names in PP._layer_names(rcfg).items() for n in names
            for t in resolve_linear(params[net][n])]
    save = resolve_save_acts(save_acts, rcfg, z_vals.shape[0] * z_vals.shape[1],
                             rcfg.march_stash_budget_gb)
    return RayMarchFunction.apply(rcfg, save, rays_o, rays_d, z_vals, inv_s, *flat)
