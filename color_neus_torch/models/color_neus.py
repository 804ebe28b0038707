"""Color-NeuS core: port of color_neus_tpu/models/color_neus.py.

Reference lib/models/renderers/Color_NeuS.py:24-138: the colour MLP runs
in no_view_dir mode and predicts the view-independent global colour; the
relight MLP adds a view-dependent residual in inverse-sigmoid space. Both
the relit colour and the composited global colour are returned; the
trainer drives mean(delta_relight) to 0.
"""

from __future__ import annotations

import torch

from color_neus_torch.models import fields
from color_neus_torch.models.configs import RendererConfig
from color_neus_torch.models.neus import (
    COS_ANNEAL_RATIO,
    _blend_background,
    _eikonal_parts,
    _sample_points,
    _sphere_masks,
    anneal_cos,
    eval_point_pipeline,
    exclusive_cumprod_weights,
    neus_alpha,
)


def render_core_color_neus(params, rcfg: RendererConfig, rays_o, rays_d, z_vals,
                           sample_dist, background_alpha=None, background_sampled_color=None):
    R, S = z_vals.shape
    dists, mid_z_vals, pts, dirs = _sample_points(rays_o, rays_d, z_vals, sample_dist)

    sdf, gradients, global_color_pt, relit_pt, delta_relight = \
        eval_point_pipeline(params, rcfg, pts, dirs)
    sampled_color = relit_pt.reshape(R, S, 3)

    inv_s = fields.variance_inv_s(params["variance"])
    true_cos = torch.sum(dirs * gradients, dim=-1, keepdim=True)
    iter_cos = anneal_cos(true_cos, COS_ANNEAL_RATIO)

    alpha_global, prev_cdf = neus_alpha(sdf.reshape(R, S), iter_cos.reshape(R, S), dists,
                                        inv_s)
    inside, relaxed = _sphere_masks(pts, R, S)

    # the global colour is composited with the foreground weights
    # (Color_NeuS.py:94-95,116); without a background model they are the
    # weights of the relit colour too
    weights_global = exclusive_cumprod_weights(alpha_global)
    if background_alpha is not None:
        alpha, sampled_color = _blend_background(
            alpha_global, sampled_color, inside, background_alpha, background_sampled_color, S)
        weights = exclusive_cumprod_weights(alpha)
    else:
        weights = weights_global
    color = torch.sum(sampled_color * weights[..., None], dim=1)
    global_color = torch.sum(global_color_pt.reshape(R, S, 3) * weights_global[..., None],
                             dim=1)

    eik_num, eik_den = _eikonal_parts(gradients.reshape(R, S, 3), relaxed)
    return {
        "color": color,
        "global_color": global_color,
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
        "delta_relight": delta_relight.reshape(R, S, 3),
    }
