"""NeuS volume renderer: port of color_neus_tpu/models/neus.py.

The hierarchy (coarse samples + 4 SDF-guided up-sample rounds) runs
under torch.no_grad(), its SDF sweeps through the placement-sweep kernel
(ops/kernels/sdf_rays.py) unless fused_sdf='off'. The render core's
per-point MLPs (eval_point_pipeline) follow fused_core:
  * auto / on, grad disabled (validation render, vertex colours): the
    point-pipeline forward kernel (ops/kernels/point_pipeline.py; its
    plain twin for CPU tensors);
  * on, grad enabled (training): fused_point_pipeline, the autograd
    Function whose forward is that kernel and whose backward is the
    point-pipeline backward kernel (plain twins for CPU tensors);
  * auto, grad enabled: the plain autograd core, the path the JAX
    package runs off-TPU (the backward kernel is slower than it for now,
    PERF.md);
  * off: always the plain core.
The training loss path (render_rays_train) follows fused_march: 'on' runs
the fused ray march (ops/kernels/ray_march.py: the autograd Function of
the march's forward and backward kernels in march_acts' mode, plain twins
for CPU tensors) on
the same z values, and returns the same dict; 'auto' and 'off' reduce the
plain core's render_rays output (auto stays on the plain core until a
measured march step beats it, PERF.md). With n_outside > 0 (the NeRF++
background, render_core_outside) the loss path never takes the march, as
in JAX. render_rays runs the core in chunks of ray_chunk rays, each
recomputed in the backward, and its MLP products in compute_dtype.

Behavioural quirks kept from the reference (SURVEY §3.6):
  * up-sampling uses fixed inv_s = 64 * 2^i, not the learned one
  * cos_anneal_ratio defaults to 0 (the trainer never schedules it)
  * alpha = clip((sig(prev*s)-sig(next*s)+1e-5)/(sig(prev*s)+1e-5), 0, 1)
  * eikonal averaged over the |p| < 1.2 relaxed sphere
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from color_neus_torch.models import fields
from color_neus_torch.models.configs import RendererConfig
from color_neus_torch.ops.kernels.point_pipeline import (
    fused_point_pipeline, fused_point_pipeline_fwd, resolve_pipeline_weights,
)
from color_neus_torch.ops.kernels.ray_march import fused_ray_march
from color_neus_torch.ops.kernels.sdf_rays import resolve_sdf_sweep_fn
from color_neus_torch.ops.rays import sample_pdf
from color_neus_torch.ops.transforms import clip
from color_neus_torch.parallel.sharding import gather_rays, ray_shard


def init_renderer(rcfg: RendererConfig, generator, device="cpu") -> nn.ModuleDict:
    params = {
        "sdf": fields.init_sdf(rcfg.sdf, generator, device),
        "color": fields.init_color(rcfg.color, generator, device),
        "variance": fields.init_variance(rcfg.variance, device),
    }
    if rcfg.kind == "color_neus":
        params["relight"] = fields.init_relight(rcfg.relight, generator, device)
    if rcfg.n_outside > 0:
        params["nerf"] = fields.init_nerf(rcfg.nerf, generator, device)
    return nn.ModuleDict(params)


# ---------------------------------------------------------------------------
# Shared compositing math
# ---------------------------------------------------------------------------

class _CumprodNonzero(torch.autograd.Function):
    """torch.cumprod over the last axis of entries that are never 0, with
    torch's gradient for that case (the reversed cumsum of grad * out over
    the input) but without the host check for zeros its backward makes
    (`.item()`), which a captured step cannot run."""

    @staticmethod
    def forward(ctx, x):
        y = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return torch.flip(torch.cumsum(torch.flip(y * g, [-1]), dim=-1), [-1]) / x


def exclusive_cumprod_weights(alpha: torch.Tensor) -> torch.Tensor:
    """weights = alpha * prod_{j<i} (1 - alpha_j + 1e-7)  (NeuS.py:269-270);
    alpha lies in [0, 1], so no factor is 0."""
    trans = _CumprodNonzero.apply(1.0 - alpha + 1e-7)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=-1)
    return alpha * trans


def section_dists(z_vals: torch.Tensor, sample_dist: float):
    """Per-section lengths with the trailing sample_dist pad, and mids."""
    d = z_vals[:, 1:] - z_vals[:, :-1]
    dists = torch.cat([d, torch.full_like(d[:, :1], sample_dist)], dim=-1)
    mid_z_vals = z_vals + dists * 0.5
    return dists, mid_z_vals


def neus_alpha(sdf, iter_cos, dists, inv_s):
    """Section alpha from estimated prev/next SDF (NeuS.py:244-254);
    clipped as jnp.clip clips: 0.5 of the gradient at q == 0 and q == 1,
    which are exact ties once inv_s is large."""
    est_next = sdf + iter_cos * dists * 0.5
    est_prev = sdf - iter_cos * dists * 0.5
    prev_cdf = torch.sigmoid(est_prev * inv_s)
    next_cdf = torch.sigmoid(est_next * inv_s)
    alpha = clip((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5), 0.0, 1.0)
    return alpha, prev_cdf


# the reference never schedules the cos annealing (NeuS_Trainer.py:124)
COS_ANNEAL_RATIO = 0.0


def anneal_cos(true_cos, cos_anneal_ratio):
    """The 'not dead at init' annealed cos (NeuS.py:241-242); always <= 0."""
    return -(F.relu(-true_cos * 0.5 + 0.5) * (1.0 - cos_anneal_ratio)
             + F.relu(-true_cos) * cos_anneal_ratio)


# ---------------------------------------------------------------------------
# Hierarchical sampling (no-grad)
# ---------------------------------------------------------------------------

def up_sample_z(rays_o, rays_d, z_vals, sdf, n_importance, inv_s):
    """One SDF-sign-change-guided importance round (NeuS.py:136-181).
    The alpha here is not clipped (unlike neus_alpha)."""
    # |ro + rd z|^2 as a per-ray quadratic in z: no [R, S, 3] points
    a = torch.sum(rays_o * rays_o, dim=-1, keepdim=True)
    b = 2.0 * torch.sum(rays_o * rays_d, dim=-1, keepdim=True)
    c = torch.sum(rays_d * rays_d, dim=-1, keepdim=True)
    radius = torch.sqrt(torch.clamp_min(a + b * z_vals + c * z_vals * z_vals, 0.0))
    inside_sphere = (radius[:, :-1] < 1.0) | (radius[:, 1:] < 1.0)

    prev_sdf, next_sdf = sdf[:, :-1], sdf[:, 1:]
    prev_z, next_z = z_vals[:, :-1], z_vals[:, 1:]
    mid_sdf = (prev_sdf + next_sdf) * 0.5
    cos_val = (next_sdf - prev_sdf) / (next_z - prev_z + 1e-5)

    prev_cos = torch.cat([torch.zeros_like(cos_val[:, :1]), cos_val[:, :-1]], dim=-1)
    cos_val = torch.minimum(prev_cos, cos_val)
    cos_val = torch.clamp(cos_val, -1e3, 0.0) * inside_sphere

    dist = next_z - prev_z
    prev_esti = mid_sdf - cos_val * dist * 0.5
    next_esti = mid_sdf + cos_val * dist * 0.5
    prev_cdf = torch.sigmoid(prev_esti * inv_s)
    next_cdf = torch.sigmoid(next_esti * inv_s)
    alpha = (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)
    weights = exclusive_cumprod_weights(alpha)
    return sample_pdf(z_vals, weights, n_importance, det=True)


def merge_z_vals_sort(z_vals, new_z, sdf, new_sdf):
    """Sorted merge by one stable sort of the concatenation: ties keep
    old before new; the sdf rides along in the sort order."""
    z_cat = torch.cat([z_vals, new_z], dim=-1)
    z, order = torch.sort(z_cat, dim=-1, stable=True)
    if sdf is None:
        return z, None
    s = torch.gather(torch.cat([sdf, new_sdf], dim=-1), 1, order)
    return z, s


def merge_z_vals(z_vals, new_z, sdf, new_sdf):
    """Sorted merge of per-ray sorted (z, sdf) [R, n] with (new_z, new_sdf)
    [R, m] by counting ranks (JAX's merge_z_vals): each old z goes to its
    index plus the count of new z below it, each new z to its index plus
    the count of old z at or below it (ties: old before new, as a stable
    sort of the concatenation), placed by an equality-masked sum over an
    [R, n, n + m] intermediate. Equal to merge_z_vals_sort, bitwise; off
    the hot path as in JAX (hierarchical_z_vals merges by the sort unless
    given merge=), the independent formulation tools/merge_bench.py holds
    and times the sort against."""
    R, n = z_vals.shape
    m = new_z.shape[1]
    dev = z_vals.device
    pos_a = torch.arange(n, device=dev)[None, :] + torch.sum(
        new_z[:, None, :] < z_vals[:, :, None], dim=-1)
    pos_b = torch.arange(m, device=dev)[None, :] + torch.sum(
        z_vals[:, :, None] <= new_z[:, None, :], dim=1)
    k = torch.arange(n + m, device=dev)

    def _place(vals, pos):
        return torch.sum(torch.where(pos[:, :, None] == k, vals[:, :, None], 0.0), dim=1)

    z = _place(z_vals, pos_a) + _place(new_z, pos_b)
    if sdf is None:
        return z, None
    return z, _place(sdf, pos_a) + _place(new_sdf, pos_b)


@torch.no_grad()
def hierarchical_z_vals(params, rcfg: RendererConfig, rays_o, rays_d, near, far,
                        generator=None, perturb_overwrite: float = -1.0,
                        sdf_rays_fn=None, mesh=None, merge=merge_z_vals_sort):
    """Coarse + SDF-guided importance z values, [R, n_samples+n_importance],
    outside the autograd graph (the reference's torch.no_grad(),
    NeuS.py:343-355). 1 + (up_sample_steps - 1) SDF sweeps: the last
    round merges z only. With a mesh (parallel.Mesh) the rays are this
    rank's shard of the global batch: the perturbation draws the global
    batch's noise and keeps the shard's rows, so every rank's generator
    stays in step with the others' and with a one-process run's (JAX folds
    the device's axis index into the key instead: the same distribution,
    other draws). merge: the sorted merge of each round (merge_z_vals
    gives the same z, bitwise)."""
    rays_o, rays_d = rays_o.detach(), rays_d.detach()
    near, far = near.detach(), far.detach()
    R = rays_o.shape[0]
    n = rcfg.n_samples

    t = torch.linspace(0.0, 1.0, n, dtype=rays_o.dtype, device=rays_o.device)
    z_vals = near[:, None] + (far - near)[:, None] * t[None, :]

    perturb = rcfg.perturb if perturb_overwrite < 0 else perturb_overwrite
    if perturb > 0:
        if generator is None:
            raise ValueError("perturbed sampling needs a generator")
        world = 1 if mesh is None else mesh.world
        t_rand = torch.rand((R * world, 1), generator=generator, dtype=z_vals.dtype,
                            device=z_vals.device) - 0.5
        if mesh is not None:
            t_rand = ray_shard(t_rand, mesh.rank, mesh.world)
        z_vals = z_vals + t_rand * 2.0 / n

    if rcfg.n_importance > 0:
        if sdf_rays_fn is not None:
            def sweep(z):
                return sdf_rays_fn(rays_o, rays_d, z)
        else:
            def sweep(z):
                pts = (rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]).reshape(-1, 3)
                return fields.sdf_value(params["sdf"], rcfg.sdf, pts).reshape(z.shape)
        sdf = sweep(z_vals)
        n_per_round = rcfg.n_importance // rcfg.up_sample_steps
        for i in range(rcfg.up_sample_steps):
            new_z = up_sample_z(rays_o, rays_d, z_vals, sdf, n_per_round, 64 * 2 ** i)
            if i + 1 == rcfg.up_sample_steps:
                z_vals, sdf = merge(z_vals, new_z, None, None)
            else:
                z_vals, sdf = merge(z_vals, new_z, sdf, sweep(new_z))
    return z_vals


# ---------------------------------------------------------------------------
# Background (NeRF++ inverted-sphere) model
# ---------------------------------------------------------------------------

def render_core_outside(params, rcfg: RendererConfig, rays_o, rays_d, z_vals, sample_dist):
    """NeRF++ background shading (NeuS.py:95-134): the nerf net on the
    inverted-sphere coordinates [x / r, 1 / r] of every section's mid
    point (r clipped to >= 1)."""
    R, S = z_vals.shape
    dists, mid_z_vals = section_dists(z_vals, sample_dist)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * mid_z_vals[..., None]
    dis = clip(torch.linalg.norm(pts, dim=-1, keepdim=True), 1.0, 1e10)
    pts4 = torch.cat([pts / dis, 1.0 / dis], dim=-1)
    dirs = rays_d[:, None, :].expand(R, S, 3)
    density, raw_rgb = fields.nerf_apply(params["nerf"], rcfg.nerf, pts4.reshape(-1, 4),
                                         dirs.reshape(-1, 3))
    sampled_color = torch.sigmoid(raw_rgb).reshape(R, S, 3)
    alpha = 1.0 - torch.exp(-F.softplus(density.reshape(R, S)) * dists)
    weights = exclusive_cumprod_weights(alpha)
    color = torch.sum(weights[..., None] * sampled_color, dim=1)
    return {"color": color, "sampled_color": sampled_color, "alpha": alpha, "weights": weights}


def _blend_background(alpha, sampled_color, inside, background_alpha,
                      background_sampled_color, S):
    """The foreground's alpha and colour inside the unit sphere, the
    background's outside it and past the S foreground samples."""
    alpha_in = alpha * inside + background_alpha[:, :S] * (1.0 - inside)
    alpha_full = torch.cat([alpha_in, background_alpha[:, S:]], dim=-1)
    col_in = sampled_color * inside[..., None] + \
        background_sampled_color[:, :S] * (1.0 - inside)[..., None]
    col_full = torch.cat([col_in, background_sampled_color[:, S:]], dim=1)
    return alpha_full, col_full


# ---------------------------------------------------------------------------
# Render cores
# ---------------------------------------------------------------------------

def resolve_point_pipeline(params, rcfg: RendererConfig):
    """The point-pipeline forward kernel's resolved weights when fused_core
    sends the no-grad calls made here to it (see the module note), else
    None."""
    if rcfg.fused_core == "off" or torch.is_grad_enabled():
        return None
    return resolve_pipeline_weights(params, rcfg)


def eval_point_pipeline(params, rcfg: RendererConfig, pts, dirs, weights=None):
    """(sdf [N,1], grad [N,3], colour [N,3], relit [N,3], delta [N,3]):
    the point-pipeline kernels when fused_core sends this call to them (or
    `weights` from resolve_point_pipeline are given), else the plain
    PyTorch path."""
    if weights is None:
        if rcfg.fused_core == "on" and torch.is_grad_enabled():
            return fused_point_pipeline(params, rcfg, pts, dirs)
        weights = resolve_point_pipeline(params, rcfg)
    if weights is not None:
        return fused_point_pipeline_fwd(params, rcfg, pts, dirs, weights=weights)
    sdf, feature, gradients = fields.sdf_with_grad(params["sdf"], rcfg.sdf, pts)
    color = fields.color_apply(params["color"], rcfg.color, pts, gradients, dirs, feature)
    if rcfg.kind == "color_neus":
        relit, delta = fields.relight_apply(params["relight"], rcfg.relight,
                                            color, pts, dirs, gradients)
        return sdf, gradients, color, relit, delta
    return sdf, gradients, color, color, torch.zeros_like(color)


def _sample_points(rays_o, rays_d, z_vals, sample_dist):
    dists, mid_z_vals = section_dists(z_vals, sample_dist)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * mid_z_vals[..., None]
    R, S = z_vals.shape
    dirs = rays_d[:, None, :].expand(R, S, 3)
    return dists, mid_z_vals, pts.reshape(-1, 3), dirs.reshape(-1, 3)


def _sphere_masks(pts_flat, R, S):
    pts_norm = torch.linalg.norm(pts_flat, dim=-1).reshape(R, S).detach()
    inside = (pts_norm < 1.0).to(pts_flat.dtype)
    relaxed = (pts_norm < 1.2).to(pts_flat.dtype)
    return inside, relaxed


def _eikonal_parts(gradients, relax_inside):
    """(numerator, denominator) of the mean squared (|grad|-1) over the
    relaxed sphere (NeuS.py:277-279)."""
    err = (torch.linalg.norm(gradients, dim=-1) - 1.0) ** 2
    return torch.sum(relax_inside * err), torch.sum(relax_inside)


def render_core_neus(params, rcfg: RendererConfig, rays_o, rays_d, z_vals, sample_dist,
                     background_alpha=None, background_sampled_color=None):
    """Plain NeuS core (NeuS.py:199-292)."""
    R, S = z_vals.shape
    dists, mid_z_vals, pts, dirs = _sample_points(rays_o, rays_d, z_vals, sample_dist)

    sdf, gradients, color_pt, _, _ = eval_point_pipeline(params, rcfg, pts, dirs)
    sampled_color = color_pt.reshape(R, S, 3)

    inv_s = fields.variance_inv_s(params["variance"])
    true_cos = torch.sum(dirs * gradients, dim=-1, keepdim=True)
    iter_cos = anneal_cos(true_cos, COS_ANNEAL_RATIO)

    alpha, prev_cdf = neus_alpha(sdf.reshape(R, S), iter_cos.reshape(R, S), dists, inv_s)
    inside, relaxed = _sphere_masks(pts, R, S)
    if background_alpha is not None:
        alpha, sampled_color = _blend_background(
            alpha, sampled_color, inside, background_alpha, background_sampled_color, S)

    weights = exclusive_cumprod_weights(alpha)
    color = torch.sum(sampled_color * weights[..., None], dim=1)

    eik_num, eik_den = _eikonal_parts(gradients.reshape(R, S, 3), relaxed)
    return {
        "color": color,
        "sdf": sdf,
        "dists": dists,
        "gradients": gradients.reshape(R, S, 3),
        "s_val": torch.ones((R, 1), dtype=color.dtype, device=color.device) / inv_s,
        "mid_z_vals": mid_z_vals,
        "weights": weights,
        "cdf": prev_cdf.reshape(R, S),
        "gradient_error": eik_num / (eik_den + 1e-5),
        "eik_num": eik_num,
        "eik_den": eik_den,
        "inside_sphere": inside,
    }


def _z_vals(params, rcfg: RendererConfig, rays_o, rays_d, near, far, generator,
            perturb_overwrite, mesh=None):
    """The hierarchy's z values, its sweeps as fused_sdf says."""
    sdf_rays_fn = None
    if rcfg.n_importance > 0:
        sdf_rays_fn = resolve_sdf_sweep_fn(params["sdf"], rcfg.sdf, rcfg.fused_sdf,
                                           dtype=rcfg.sweep_dtype,
                                           act=rcfg.sweep_activation)
    return hierarchical_z_vals(params, rcfg, rays_o, rays_d, near, far, generator=generator,
                               perturb_overwrite=perturb_overwrite, sdf_rays_fn=sdf_rays_fn,
                               mesh=mesh)


def _compute_dtype(rcfg: RendererConfig):
    """The context of rcfg.compute_dtype for the plain path's products."""
    if rcfg.compute_dtype == "float32":
        return contextlib.nullcontext()
    return fields.compute_dtype(getattr(torch, rcfg.compute_dtype))


def _chunked_core(core, params, rcfg: RendererConfig, rays_o, rays_d, z_vals, sample_dist,
                  background_alpha, background_sampled_color):
    """The core on chunks of rcfg.ray_chunk rays, each under
    torch.utils.checkpoint: the backward recomputes a chunk's activations
    instead of holding O(R S width) of them (JAX's jax.checkpoint over
    lax.map, neus.py:538-575). The core draws no random numbers, so the
    recomputation keeps no RNG state (a captured step could not read it);
    it sets rcfg.compute_dtype itself, since it runs again in the backward,
    outside render_rays. The outputs join as JAX's do: per-ray and flat
    per-point arrays in ray order, the eikonal parts summed before the
    ratio."""
    def chunk_fn(o, d, z, ba, bsc):
        with _compute_dtype(rcfg):
            return core(params, rcfg, o, d, z, sample_dist, background_alpha=ba,
                        background_sampled_color=bsc)

    c = rcfg.ray_chunk
    outs = []
    for i in range(0, rays_o.shape[0], c):
        args = [None if x is None else x[i:i + c]
                for x in (rays_o, rays_d, z_vals, background_alpha, background_sampled_color)]
        outs.append(checkpoint(chunk_fn, *args, use_reentrant=False, preserve_rng_state=False))
    ret = {k: torch.cat([o[k] for o in outs]) for k in outs[0]
           if k not in ("eik_num", "eik_den", "gradient_error")}
    ret["eik_num"] = torch.stack([o["eik_num"] for o in outs]).sum()
    ret["eik_den"] = torch.stack([o["eik_den"] for o in outs]).sum()
    ret["gradient_error"] = ret["eik_num"] / (ret["eik_den"] + 1e-5)
    return ret


def render_rays(params, rcfg: RendererConfig, rays_o, rays_d, near, far,
                generator=None, perturb_overwrite: float = -1.0, mesh=None):
    """Full forward: hierarchical sampling + core (NeuS.py:294-408), its
    MLP products in rcfg.compute_dtype (JAX's neus.py:493-494).

    Returns the reference's output dict: color_fine, s_val, cdf_fine,
    weight_sum, weight_max, gradients, weights, gradient_error and its
    parts eik_num / eik_den, inside_sphere, depth (+ global_color /
    delta_relight for color_neus). With n_outside > 0 the weights and
    depth run over the foreground and background samples together. With a
    mesh the rays are this rank's shard (hierarchical_z_vals)."""
    with _compute_dtype(rcfg):
        return _render_rays_inner(params, rcfg, rays_o, rays_d, near, far, generator,
                                  perturb_overwrite, mesh)


def _render_rays_inner(params, rcfg, rays_o, rays_d, near, far, generator, perturb_overwrite,
                       mesh):
    sample_dist = 2.0 / rcfg.n_samples
    z_vals = _z_vals(params, rcfg, rays_o, rays_d, near, far, generator, perturb_overwrite,
                     mesh)

    background_alpha = background_sampled_color = None
    z_vals_feed = z_vals
    if rcfg.n_outside > 0:
        # inverted-sphere background samples beyond far (NeuS.py:315-336)
        t_out = torch.linspace(1e-3, 1.0 - 1.0 / (rcfg.n_outside + 1.0), rcfg.n_outside,
                               dtype=z_vals.dtype, device=z_vals.device)
        z_out = far[:, None] / torch.flip(t_out, [-1])[None, :] + 1.0 / rcfg.n_samples
        z_vals_feed = torch.sort(torch.cat([z_vals, z_out], dim=-1), dim=-1).values
        out = render_core_outside(params, rcfg, rays_o, rays_d, z_vals_feed, sample_dist)
        background_alpha, background_sampled_color = out["alpha"], out["sampled_color"]

    if rcfg.kind == "color_neus":
        from color_neus_torch.models.color_neus import render_core_color_neus
        core = render_core_color_neus
    else:
        core = render_core_neus
    R = rays_o.shape[0]
    if rcfg.ray_chunk > 0 and R > rcfg.ray_chunk and R % rcfg.ray_chunk == 0:
        ret = _chunked_core(core, params, rcfg, rays_o, rays_d, z_vals, sample_dist,
                            background_alpha, background_sampled_color)
    else:
        ret = core(params, rcfg, rays_o, rays_d, z_vals, sample_dist,
                   background_alpha=background_alpha,
                   background_sampled_color=background_sampled_color)

    weights = ret["weights"]
    out = {
        "color_fine": ret["color"],
        "s_val": ret["s_val"],
        "cdf_fine": ret["cdf"],
        "weight_sum": torch.sum(weights, dim=-1, keepdim=True),
        "weight_max": torch.amax(weights, dim=-1, keepdim=True),
        "gradients": ret["gradients"],
        "weights": weights,
        "gradient_error": ret["gradient_error"],
        "eik_num": ret["eik_num"],
        "eik_den": ret["eik_den"],
        "inside_sphere": ret["inside_sphere"],
        "depth": torch.sum(weights * z_vals_feed, dim=-1),
    }
    for k in ("global_color", "delta_relight"):
        if k in ret:
            out[k] = ret[k]
    return out


def _use_fused_march(rcfg: RendererConfig) -> bool:
    """fused_march 'on' runs the march, unless a background model is on;
    'auto' and 'off' the plain core (see the module note)."""
    return rcfg.fused_march == "on" and rcfg.n_outside == 0


def _fused_out16(params, rcfg: RendererConfig, rays_o, rays_d, near, far, generator,
                 perturb_overwrite, mesh=None):
    """The hierarchy (the same sweeps and generator draws as render_rays),
    then the fused ray march: [R, 16] per-ray loss partials
    (ray_march.fused_ray_march)."""
    z_vals = _z_vals(params, rcfg, rays_o, rays_d, near, far, generator, perturb_overwrite,
                     mesh)
    inv_s = fields.variance_inv_s(params["variance"])
    return fused_ray_march(params, rcfg, rays_o, rays_d, z_vals, inv_s,
                           save_acts=rcfg.march_acts)


def render_rays_train(params, rcfg: RendererConfig, rays_o, rays_d, near, far,
                      generator=None, perturb_overwrite: float = -1.0, mesh=None):
    """Loss-path renderer: only what compute_loss and the train aux read
    (color_fine, weight_sum, gradient_error, s_val, per-ray delta sums),
    through the fused march when fused_march is 'on' (the fused branch of
    the JAX function, neus.py:465-480), else by reducing render_rays' output
    (its non-fused branch, neus.py:436-448).

    With a mesh (parallel.Mesh) the rays are this rank's shard of the
    global batch and the dict holds the global batch's values, as JAX's
    sharded function returns them (neus.py:449-488): the per-ray outputs
    gathered from every rank (parallel.gather_rays: the march's [R, 16]
    partials, or the plain core's colour, weight and delta sums), and the
    eikonal ratio of the global sums of its parts, so every rank computes
    the one-device loss. s_val stays the shard's (a constant per ray)."""
    n_total = rcfg.n_samples + rcfg.n_importance
    if _use_fused_march(rcfg):
        out16 = gather_rays(_fused_out16(params, rcfg, rays_o, rays_d, near, far, generator,
                                         perturb_overwrite, mesh), mesh)
        inv_s = fields.variance_inv_s(params["variance"])
        ret = {
            "color_fine": out16[:, 0:3],
            "weight_sum": out16[:, 3:4],
            "gradient_error": torch.sum(out16[:, 5]) / (torch.sum(out16[:, 6]) + 1e-5),
            "s_val": (1.0 / inv_s).expand(rays_o.shape[0], 1),
            "n_samples_total": n_total,
        }
        if rcfg.kind == "color_neus":
            ret["delta_sum"] = out16[:, 4]
        return ret
    out = render_rays(params, rcfg, rays_o, rays_d, near, far, generator=generator,
                      perturb_overwrite=perturb_overwrite, mesh=mesh)
    # each rank's (numerator, denominator), summed over the ranks
    eik = torch.sum(gather_rays(torch.stack([out["eik_num"], out["eik_den"]])[None], mesh),
                    dim=0)
    ret = {
        "color_fine": gather_rays(out["color_fine"], mesh),
        "weight_sum": gather_rays(out["weight_sum"], mesh),
        "gradient_error": eik[0] / (eik[1] + 1e-5),
        "s_val": out["s_val"],
        "n_samples_total": n_total,
    }
    if "delta_relight" in out:
        ret["delta_sum"] = gather_rays(torch.sum(out["delta_relight"], dim=(1, 2)), mesh)
    return ret
