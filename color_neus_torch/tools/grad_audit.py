"""Gradient audit of the fused kernels: the port of tools/grad_audit.py.

Compares the gradient of a composite scalar loss over the full render
(hierarchical sampling, render core, second-order eikonal) between

  * a fused arm: by default fused_march='on' (rows 3 + 4, the training
    loss path, MARCH_ACTS as the config resolves it: the save mode at
    this shape) in the AUDIT_PREC arithmetic; `audit` also takes
    fused_core='on' (rows 5 + 6) as its arm, and
  * the f32 oracle: fused_march='off', the plain core in f32 with TF32
    off (pin_precision), the port's "highest",

on identical inputs at the flagship widths (Color-NeuS 8x256/PE6 SDF,
4x256 colour, 4x256 relight, 256 + 256 samples a ray in 4 up-sample
rounds), and prints one JSON line with JAX's keys (also written to
reports/torch/grad_audit.json with WRITE_REPORT=1). Both arms run the
no-grad sampling sweeps on the plain path (fused_sdf='off'), so they see
identical sample positions: the audit isolates the backward kernels.

    python -m color_neus_torch.tools.grad_audit              # on the card
    AUDIT_PREC=f32stash|bf16|f32 AUDIT_N_RAYS=256 python -m color_neus_torch.tools.grad_audit
    python -m color_neus_torch.tools.grad_audit --device cpu # or AUDIT_DEVICE=cpu

On the CPU (JAX's AUDIT_INTERPRET) the fused arm is the kernels' plain
twins, at 64 + 64 samples in 2 rounds and at most 32 rays.

What the statistics say (JAX's docstring): the error vector e_i =
g_fused(batch_i) - g_oracle(batch_i) on two independent ray batches gives
  * err_batch_cos         cos(e_1, e_2): ~1 a fixed bias, ~0 noise that
                          decorrelates across batches,
  * systematic_err_ratio  sqrt(max(e1.e2, 0)) / sqrt(max(g1.g2, 0)): the
                          estimated |bias| over the estimated |expected
                          gradient| (the cross-batch inner products are
                          unbiased estimates of the squared systematic
                          norms),
each beside the oracle's own cross-batch floor (xla_cross_batch_*: the f32
oracle against itself on the other batch; the key names are JAX's, so a
port report reads line for line beside reports/r5/grad_audit*.json).
`sys_le_2x_floor` holds a group's systematic ratio to at most twice that
floor; `pass_2x_floor` holds every group to it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os

import numpy as np
import torch

from color_neus_torch import pin_precision, resolve_device
from color_neus_torch.models import neus
from color_neus_torch.models.configs import ColorConfig, RendererConfig
from color_neus_torch.ops.rays import near_far_from_sphere
from color_neus_torch.tools import platform_name

# the two ray batches' numpy seeds and the parameters' generator seed
# (JAX's PRNGKey(1), PRNGKey(11) and PRNGKey(0))
BATCH_SEEDS = (1, 11)
PARAM_SEED = 0
ORACLE = {"fused_march": "off"}
FUSED_MARCH = {"fused_march": "on"}
FUSED_CORE = {"fused_core": "on"}
FLOOR_DEFINITION = ("xla_cross_batch_* = the f32 ORACLE vs itself on an independent ray "
                    "batch (pure batch-content variance; no fused kernel involved). "
                    "sys_le_2x_floor asserts max_systematic_err_ratio <= 2x "
                    "max_xla_cross_batch_rel per group.")


def audit_config(prec: str = "bf16", **over) -> RendererConfig:
    """JAX's audit renderer (grad_audit.py:88-92): Color-NeuS no_view_dir,
    256 + 256 samples in 4 rounds, march_bwd_precision `prec`."""
    kw = dict(kind="color_neus", n_samples=256, n_importance=256, up_sample_steps=4,
              march_bwd_precision=prec,
              color=ColorConfig(mode="no_view_dir", d_in=6, multires_view=0))
    return RendererConfig(**{**kw, **over})


def ray_batch(n_rays: int, seed: int) -> tuple:
    """(rays_o, rays_d) [n, 3] f32 numpy, shaped as JAX's (grad_audit.py:
    99-103): origins on the sphere of radius 1.5, aimed inward with 0.15
    jitter. numpy draws them, so they can be given to both packages."""
    rng = np.random.RandomState(seed)
    o = rng.standard_normal((n_rays, 3))
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 1.5
    d = -o / 1.5 + 0.15 * rng.standard_normal((n_rays, 3))
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def to_device(batch, device) -> tuple:
    """(rays_o, rays_d, near, far) tensors on `device` from a numpy batch."""
    o, d = (torch.as_tensor(x, device=device) for x in batch)
    return (o, d, *near_far_from_sphere(o, d))


def audit_loss(params, rcfg: RendererConfig, rays, arm: dict) -> torch.Tensor:
    """JAX's composite scalar (grad_audit.py:106-118) through the training
    loss path (render_rays_train, perturb 0): mean(color_fine) +
    gradient_error + mean(weight_sum) + mean(delta_sum)^2, with fused_core
    and fused_sdf 'off' unless `arm` sets them."""
    cfg = dataclasses.replace(rcfg, **{"fused_sdf": "off", "fused_core": "off",
                                       "fused_march": "off", **arm})
    out = neus.render_rays_train(params, cfg, *rays, perturb_overwrite=0.0)
    return (torch.mean(out["color_fine"]) + out["gradient_error"]
            + torch.mean(out["weight_sum"]) + torch.mean(out["delta_sum"]) ** 2)


def leaf_grads(params, rcfg: RendererConfig, rays, arm: dict) -> dict:
    """{leaf name as JAX flattens its params ("sdf/lin0/v"): the loss's
    gradient in float64}, zeros where a leaf gets none."""
    params.zero_grad(set_to_none=True)
    audit_loss(params, rcfg, rays, arm).backward()
    out = {}
    for name, p in params.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        out[name.replace(".", "/")] = g.detach().double().cpu().numpy()
    params.zero_grad(set_to_none=True)
    return out


def statistics(ff: dict, fx: dict, fb2: dict, ff2: dict) -> tuple:
    """JAX's per-leaf statistics and their per-group extremes
    (grad_audit.py:164-227) of the fused and oracle gradients on batch 1
    (ff, fx) and batch 2 (ff2, fb2): (groups, worst leaf)."""
    groups = {}
    worst = {"leaf": None, "rel": 0.0}
    for name in sorted(fx):
        a, b = ff[name].ravel(), fx[name].ravel()
        nb = float(np.linalg.norm(b))
        rel = float(np.linalg.norm(a - b) / (nb + 1e-30)) if nb > 0 else \
            float(np.linalg.norm(a))
        cos = float(np.dot(a, b) / ((np.linalg.norm(a) * nb) + 1e-30)) if nb > 0 else 1.0
        c = fb2[name].ravel()
        nc = float(np.linalg.norm(c))
        cos_mb = float(np.dot(b, c) / ((nb * nc) + 1e-30)) if nb > 0 and nc > 0 else 1.0
        # the oracle's own cross-batch floor: batch-content variance
        floor_rel = (2.0 * float(np.linalg.norm(b - c)) / (nb + nc + 1e-30)
                     if nb + nc > 0 else 0.0)
        e1 = a - b
        e2 = ff2[name].ravel() - c
        n1, n2 = float(np.linalg.norm(e1)), float(np.linalg.norm(e2))
        ecos = float(np.dot(e1, e2) / (n1 * n2 + 1e-30)) if n1 > 0 and n2 > 0 else 0.0
        sys_err = math.sqrt(max(float(np.dot(e1, e2)), 0.0))
        sys_grad = math.sqrt(max(float(np.dot(b, c)), 0.0))
        sys_ratio = sys_err / (sys_grad + 1e-30)
        g = groups.setdefault(name.split("/")[0], {
            "max_rel_err": 0.0, "min_cos": 1.0, "min_xla_cross_batch_cos": 1.0,
            "max_xla_cross_batch_rel": 0.0, "max_err_batch_cos": 0.0,
            "max_systematic_err_ratio": 0.0})
        g["max_rel_err"] = max(g["max_rel_err"], rel)
        g["min_cos"] = min(g["min_cos"], cos)
        g["min_xla_cross_batch_cos"] = min(g["min_xla_cross_batch_cos"], cos_mb)
        g["max_xla_cross_batch_rel"] = max(g["max_xla_cross_batch_rel"], floor_rel)
        g["max_err_batch_cos"] = max(g["max_err_batch_cos"], ecos)
        g["max_systematic_err_ratio"] = max(g["max_systematic_err_ratio"], sys_ratio)
        if rel > worst["rel"]:
            worst = {"leaf": name, "rel": rel, "err_batch_cos": ecos,
                     "systematic_err_ratio": sys_ratio, "xla_cross_batch_rel_floor": floor_rel,
                     "xla_cross_batch_cos_floor": cos_mb}
    for g in groups.values():
        g["sys_le_2x_floor"] = bool(g["max_systematic_err_ratio"]
                                    <= 2.0 * max(g["max_xla_cross_batch_rel"], 1e-12))
    return groups, worst


def describe(rcfg: RendererConfig) -> str:
    """JAX's "config" string, from the widths."""
    s, c, r = rcfg.sdf, rcfg.color, rcfg.relight
    return (f"{rcfg.kind} {s.n_layers}x{s.d_hidden}/PE{s.multires} + {c.n_layers}x"
            f"{c.d_hidden} color + {r.n_layers}x{r.d_hidden} relight")


def audit(params, rcfg: RendererConfig, batches, arm: dict = FUSED_MARCH) -> dict:
    """The report of one fused arm (FUSED_MARCH, FUSED_CORE) against the
    f32 oracle on two ray batches (numpy (o, d) pairs, ray_batch), with
    the keys of JAX's report; runs where `params` live."""
    device = next(params.parameters()).device
    (b1, b2) = (to_device(b, device) for b in batches)
    fx = leaf_grads(params, rcfg, b1, ORACLE)
    ff = leaf_grads(params, rcfg, b1, arm)
    fb2 = leaf_grads(params, rcfg, b2, ORACLE)
    ff2 = leaf_grads(params, rcfg, b2, arm)
    groups, worst = statistics(ff, fx, fb2, ff2)
    variant = ", ".join(f"{k}={v}" for k, v in arm.items())
    return {
        "config": describe(rcfg),
        "samples_per_ray": rcfg.n_samples + rcfg.n_importance,
        "n_rays": int(batches[0][0].shape[0]),
        "fused_variant": variant if device.type == "cuda" else variant + " (plain twins)",
        "march_bwd_precision": rcfg.march_bwd_precision,
        "platform": platform_name(device),
        "floor_definition": FLOOR_DEFINITION,
        "groups": {k: {kk: (round(vv, 6) if isinstance(vv, float) else vv)
                       for kk, vv in v.items()} for k, v in sorted(groups.items())},
        "worst_leaf": {"name": worst["leaf"], "rel_err": round(worst["rel"], 6),
                       "err_batch_cos": round(worst.get("err_batch_cos", 0.0), 4),
                       "systematic_err_ratio": round(worst.get("systematic_err_ratio", 0.0), 6),
                       "xla_cross_batch_rel_floor":
                           round(worst.get("xla_cross_batch_rel_floor", 0.0), 6),
                       "xla_cross_batch_cos_floor":
                           round(worst.get("xla_cross_batch_cos_floor", 0.0), 4)},
        "pass_2x_floor": bool(all(g["sys_le_2x_floor"] for g in groups.values())),
    }


def init_params(rcfg: RendererConfig, device, seed: int = PARAM_SEED):
    """The renderer's parameters from the port's init under a seeded
    generator on `device`."""
    g = torch.Generator(device=device).manual_seed(seed)
    return neus.init_renderer(rcfg, g, device)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=os.environ.get("AUDIT_DEVICE"),
                   help="torch device (default: cuda; 'cpu' for the plain twins)")
    arg = p.parse_args(argv)
    pin_precision()
    device = resolve_device(arg.device)
    n_rays = int(os.environ.get("AUDIT_N_RAYS", 512))
    rcfg = audit_config(os.environ.get("AUDIT_PREC", "bf16"))
    if device.type == "cpu":
        rcfg = dataclasses.replace(rcfg, n_samples=64, n_importance=64, up_sample_steps=2)
        n_rays = min(n_rays, 32)
    report = audit(init_params(rcfg, device), rcfg,
                   [ray_batch(n_rays, s) for s in BATCH_SEEDS])
    print(json.dumps(report))
    if os.environ.get("WRITE_REPORT"):
        out = os.environ.get("AUDIT_OUT", os.path.join("reports", "torch", "grad_audit.json"))
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
