"""Neural fields: port of color_neus_tpu/models/fields.py.

Parameters mirror the JAX pytree leaf for leaf: every network is an
nn.ModuleDict of layers, every layer an nn.ParameterDict holding the
weight-norm leaves {v, g, b} (or plain {w, b}), so per-leaf gradient
clipping sees the same tensors as the JAX trainer and weights.py can map
one tree onto the other by name. The *_apply functions are plain
functions of (params, cfg, inputs), as in JAX.

Reference semantics (lib/models/renderers/fields.py): geometric init,
weight norm, softplus(beta=100), skip connection with /sqrt(2), the x3
input / /3 output scale trick, the three colour modes, inv_s = exp(10 v),
the relight residual in inverse-sigmoid space, and the NeRF++ background
net.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from color_neus_torch.models.configs import (
    SDFConfig, ColorConfig, RelightConfig, VarianceConfig, NeRFConfig,
)
from color_neus_torch.ops.embedding import positional_encoding, embedding_dim
from color_neus_torch.ops.transforms import clip, inverse_sigmoid


# ---------------------------------------------------------------------------
# Linear layers (optionally weight-normed)
# ---------------------------------------------------------------------------

def _torch_default_linear(d_in: int, d_out: int, generator, device):
    """nn.Linear's default init: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for
    weight and bias (kept for the colour/relight nets, as in the
    reference)."""
    bound = 1.0 / math.sqrt(d_in)
    w = torch.empty((d_out, d_in), device=device).uniform_(-bound, bound, generator=generator)
    b = torch.empty((d_out,), device=device).uniform_(-bound, bound, generator=generator)
    return w, b


def make_linear(w: torch.Tensor, b: torch.Tensor, weight_norm: bool) -> nn.ParameterDict:
    """Wrap a dense (w [out,in], b [out]) into (optionally) weight-norm
    leaves: w = g * v / ||v||_row, g initialised to the row norms."""
    if not weight_norm:
        return nn.ParameterDict({"w": nn.Parameter(w), "b": nn.Parameter(b)})
    g = torch.linalg.norm(w, dim=1)
    return nn.ParameterDict({"v": nn.Parameter(w), "g": nn.Parameter(g),
                             "b": nn.Parameter(b)})


def resolve_linear(p) -> tuple[torch.Tensor, torch.Tensor]:
    """Weight-norm -> dense (w [out,in], b [out]); norm clipped at 1e-12
    (fields.py:84-86)."""
    if "v" in p:
        v = p["v"]
        w = v * (p["g"] / torch.linalg.norm(v, dim=1).clamp_min(1e-12))[:, None]
    else:
        w = p["w"]
    return w, p["b"]


# The operand dtype of linear_apply's products (JAX's fields.compute_dtype):
# None is f32. Set with compute_dtype().
_COMPUTE_DTYPE = [None]


@contextlib.contextmanager
def compute_dtype(dtype):
    """Run linear_apply's products on operands rounded to `dtype` (e.g.
    torch.bfloat16), summed in f32, with an f32 result; the parameters stay
    f32."""
    _COMPUTE_DTYPE.append(dtype)
    try:
        yield
    finally:
        _COMPUTE_DTYPE.pop()


def linear_apply(p, x: torch.Tensor) -> torch.Tensor:
    w, b = resolve_linear(p)
    dt = _COMPUTE_DTYPE[-1]
    if dt is not None:
        # the f32 product of the rounded operands: exact products, f32 sums
        # and an f32 result, as JAX's dot with preferred_element_type f32;
        # autograd rounds the cotangents at the casts, as JAX's transpose of
        # that dot does (a bf16 torch.matmul would round the result instead)
        return x.to(dt).float() @ w.T.to(dt).float() + b
    return x @ w.T + b


# ---------------------------------------------------------------------------
# SDF network
# ---------------------------------------------------------------------------

def _sdf_dims(cfg: SDFConfig):
    d0 = embedding_dim(cfg.d_in, cfg.multires) if cfg.multires > 0 else cfg.d_in
    return [d0] + [cfg.d_hidden] * cfg.n_layers + [cfg.d_out]


def init_sdf(cfg: SDFConfig, generator, device="cpu") -> nn.ModuleDict:
    """Geometric initialisation (reference fields.py:52-70): the net
    starts as an approximate sphere SDF of radius `bias`. The layer
    before a skip outputs d_hidden - d0 features, so the concat with the
    raw embedding is d_hidden wide."""
    dims = _sdf_dims(cfg)
    n_lin = len(dims) - 1
    layers = {}
    for l in range(n_lin):
        out_dim = dims[l + 1] - dims[0] if (l + 1) in cfg.skip_in else dims[l + 1]

        def normal(shape, std=1.0):
            return std * torch.randn(shape, generator=generator, device=device)

        if cfg.geometric_init:
            if l == n_lin - 1:
                mean = math.sqrt(math.pi) / math.sqrt(dims[l])
                if cfg.inside_outside:
                    mean, bias = -mean, cfg.bias
                else:
                    bias = -cfg.bias
                w = mean + normal((out_dim, dims[l]), 1e-4)
                b = torch.full((out_dim,), bias, device=device)
            elif cfg.multires > 0 and l == 0:
                std = math.sqrt(2) / math.sqrt(out_dim)
                w = torch.zeros((out_dim, dims[l]), device=device)
                w[:, :3] = normal((out_dim, 3), std)
                b = torch.zeros((out_dim,), device=device)
            elif cfg.multires > 0 and l in cfg.skip_in:
                std = math.sqrt(2) / math.sqrt(out_dim)
                w = normal((out_dim, dims[l]), std)
                # zero the PE part of the concatenated raw input (keep xyz)
                w[:, -(dims[0] - 3):] = 0.0
                b = torch.zeros((out_dim,), device=device)
            else:
                std = math.sqrt(2) / math.sqrt(out_dim)
                w = normal((out_dim, dims[l]), std)
                b = torch.zeros((out_dim,), device=device)
        else:
            w, b = _torch_default_linear(dims[l], out_dim, generator, device)
        layers[f"lin{l}"] = make_linear(w, b, cfg.weight_norm)
    return nn.ModuleDict(layers)


def softplus100(x: torch.Tensor) -> torch.Tensor:
    """softplus with beta=100 as jax.nn.softplus(100 x)/100; torch's
    threshold (identity above 100x > 20) differs from the exact value by
    less than 1e-9, below f32 resolution there."""
    return F.softplus(x * 100.0) / 100.0


def sdf_apply(params, cfg: SDFConfig, x: torch.Tensor) -> torch.Tensor:
    """x [N, 3] -> [N, d_out]; channel 0 is the SDF (already /scale)."""
    inputs = x * cfg.scale
    if cfg.multires > 0:
        inputs = positional_encoding(inputs, cfg.multires)
    h = inputs
    n_lin = cfg.n_layers + 1
    inv_sqrt2 = 1.0 / math.sqrt(2.0)
    for l in range(n_lin):
        if l in cfg.skip_in:
            h = torch.cat([h, inputs], dim=-1) * inv_sqrt2
        h = linear_apply(params[f"lin{l}"], h)
        if l < n_lin - 1:
            h = softplus100(h)
    return torch.cat([h[:, :1] / cfg.scale, h[:, 1:]], dim=-1)


def sdf_value(params, cfg: SDFConfig, x: torch.Tensor) -> torch.Tensor:
    """x [N, 3] -> sdf [N, 1]."""
    return sdf_apply(params, cfg, x)[:, :1]


def sdf_with_grad(params, cfg: SDFConfig, x: torch.Tensor):
    """Returns (sdf [N,1], features [N,d_out-1], grad [N,3]).

    The input gradient is one reverse pass with create_graph=True, as the
    reference's autograd.grad (fields.py:105-115): it is itself
    differentiable, so the eikonal and colour paths get second-order
    gradients. Works under torch.no_grad() too (the graph is local)."""
    with torch.enable_grad():
        if not x.requires_grad:
            x = x.detach().requires_grad_(True)
        out = sdf_apply(params, cfg, x)
        grad, = torch.autograd.grad(out[:, 0].sum(), x, create_graph=True)
    return out[:, :1], out[:, 1:], grad


# ---------------------------------------------------------------------------
# Rendering (colour) network
# ---------------------------------------------------------------------------

def _color_in_dim(cfg: ColorConfig) -> int:
    d = cfg.d_in + cfg.d_feature
    if cfg.multires_view > 0:
        d += embedding_dim(3, cfg.multires_view) - 3
    return d


def init_color(cfg: ColorConfig, generator, device="cpu") -> nn.ModuleDict:
    dims = [_color_in_dim(cfg)] + [cfg.d_hidden] * cfg.n_layers + [cfg.d_out]
    layers = {}
    for l in range(len(dims) - 1):
        w, b = _torch_default_linear(dims[l], dims[l + 1], generator, device)
        layers[f"lin{l}"] = make_linear(w, b, cfg.weight_norm)
    return nn.ModuleDict(layers)


def color_apply(params, cfg: ColorConfig, points, normals, view_dirs, features):
    """IDR-style colour MLP; input layout per mode (fields.py:161-174)."""
    if cfg.multires_view > 0:
        view_dirs = positional_encoding(view_dirs, cfg.multires_view)
    if cfg.mode == "idr":
        h = torch.cat([points, view_dirs, normals, features], dim=-1)
    elif cfg.mode == "no_view_dir":
        h = torch.cat([points, normals, features], dim=-1)
    elif cfg.mode == "no_normal":
        h = torch.cat([points, view_dirs, features], dim=-1)
    else:
        raise ValueError(f"no such color mode: {cfg.mode}")
    n_lin = cfg.n_layers + 1
    for l in range(n_lin):
        h = linear_apply(params[f"lin{l}"], h)
        if l < n_lin - 1:
            h = F.relu(h)
    if cfg.squeeze_out:
        h = torch.sigmoid(h)
    return h


# ---------------------------------------------------------------------------
# Single-variance (s) network
# ---------------------------------------------------------------------------

def init_variance(cfg: VarianceConfig, device="cpu") -> nn.ParameterDict:
    return nn.ParameterDict({"variance": nn.Parameter(
        torch.tensor(cfg.init_val, dtype=torch.float32, device=device))})


def variance_inv_s(params) -> torch.Tensor:
    """Scalar inv_s = exp(10 v), unclipped (reference fields.py:286)."""
    return torch.exp(params["variance"] * 10.0)


# ---------------------------------------------------------------------------
# Relight network (Color-NeuS residual branch)
# ---------------------------------------------------------------------------

def _relight_in_dim(cfg: RelightConfig) -> int:
    d = cfg.d_in
    if cfg.include_grad:
        d += 3
    if cfg.multires_view > 0:
        d += embedding_dim(3, cfg.multires_view) - 3
    return d


def init_relight(cfg: RelightConfig, generator, device="cpu") -> nn.ModuleDict:
    layers = {}
    w, b = _torch_default_linear(_relight_in_dim(cfg), cfg.d_hidden, generator, device)
    layers["in_layer"] = make_linear(w, b, weight_norm=False)
    for i in range(cfg.n_layers):
        if i == cfg.y_in_layer - 1:
            d_in = cfg.d_hidden + 3
            d_out = cfg.d_out if cfg.y_in_layer == cfg.n_layers else cfg.d_hidden
        elif i == cfg.n_layers - 1:
            d_in, d_out = cfg.d_hidden, cfg.d_out
        else:
            d_in, d_out = cfg.d_hidden, cfg.d_hidden
        w, b = _torch_default_linear(d_in, d_out, generator, device)
        layers[f"mlp{i}"] = make_linear(w, b, weight_norm=False)
    return nn.ModuleDict(layers)


def relight_apply(params, cfg: RelightConfig, rgb, pts, dirs, gradients):
    """Returns (relit_rgb, delta_relight), both [N, 3]; the residual is
    added in inverse-sigmoid space when cfg.inv_sigmoid
    (fields.py:354-359)."""
    if cfg.multires_view > 0:
        dirs = positional_encoding(dirs, cfg.multires_view)
    feats = [pts, dirs]
    if cfg.include_grad:
        feats.append(gradients)
    h = linear_apply(params["in_layer"], torch.cat(feats, dim=-1))
    for i in range(cfg.n_layers):
        h = F.relu(h)
        if i == cfg.y_in_layer - 1:
            h = linear_apply(params[f"mlp{i}"], torch.cat([rgb, h], dim=-1))
        else:
            h = linear_apply(params[f"mlp{i}"], h)
    drgb = h
    if cfg.inv_sigmoid:
        out = torch.sigmoid(inverse_sigmoid(rgb) + drgb)
    else:
        out = clip(rgb + torch.sigmoid(drgb) - 0.5, 0.0, 1.0)
    return out, drgb


# ---------------------------------------------------------------------------
# NeRF background network (NeRF++ outside-sphere model)
# ---------------------------------------------------------------------------

def init_nerf(cfg: NeRFConfig, generator, device="cpu") -> nn.ModuleDict:
    """The background net (reference fields.py:192-274), torch's default
    linear init: `depth` layers of `width` on the encoded [x/r, 1/r] (the
    encoded input re-enters after each skip), then alpha, feature, one view
    layer of width / 2 and rgb."""
    in_pts = embedding_dim(cfg.d_in, cfg.multires) if cfg.multires > 0 else cfg.d_in
    in_view = (embedding_dim(cfg.d_in_view, cfg.multires_view) if cfg.multires_view > 0
               else cfg.d_in_view)
    W = cfg.width
    layers = {}
    d_prev = in_pts
    for i in range(cfg.depth):
        layers[f"pts{i}"] = make_linear(*_torch_default_linear(d_prev, W, generator, device),
                                        weight_norm=False)
        d_prev = W + in_pts if i in cfg.skips else W
    for name, d_in, d_out in (("views0", in_view + W, W // 2), ("feature", W, W),
                              ("alpha", W, 1), ("rgb", W // 2, 3)):
        layers[name] = make_linear(*_torch_default_linear(d_in, d_out, generator, device),
                                   weight_norm=False)
    return nn.ModuleDict(layers)


def nerf_apply(params, cfg: NeRFConfig, pts, view_dirs):
    """pts [N, d_in] (inverted-sphere coordinates), dirs [N, 3] ->
    (density [N, 1], rgb [N, 3]), both raw."""
    if cfg.multires > 0:
        pts = positional_encoding(pts, cfg.multires)
    if cfg.multires_view > 0:
        view_dirs = positional_encoding(view_dirs, cfg.multires_view)
    h = pts
    for i in range(cfg.depth):
        h = F.relu(linear_apply(params[f"pts{i}"], h))
        if i in cfg.skips:
            h = torch.cat([pts, h], dim=-1)
    alpha = linear_apply(params["alpha"], h)
    feat = linear_apply(params["feature"], h)
    h = F.relu(linear_apply(params["views0"], torch.cat([feat, view_dirs], dim=-1)))
    return alpha, linear_apply(params["rgb"], h)


# ---------------------------------------------------------------------------
# Utilities
# ---------------------------------------------------------------------------

def param_count(params: nn.Module) -> int:
    """Scalars in a parameter tree (JAX's param_count over its leaves)."""
    return sum(p.numel() for p in params.parameters())
