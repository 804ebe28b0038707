"""The fused ray march (ops/kernels/ray_march.py) against the JAX package,
on the CPU at small widths, and the tie rule of the clips on a gradient
path.

(a) ray_march_plain, the march kernel's plain twin, against JAX
    fused_ray_march in interpret mode on all 16 lanes;
(b) RayMarchFunction (plain twins on the CPU) against jax.grad of the JAX
    fused_ray_march: every params leaf through the weight norm, the
    variance, rays_o and rays_d, for a random [R, 16] loss weighting;
(c) a ragged ray count (JAX at tile_rays=2) and an inv_s of ~2000 that puts
    exact q == 1 ties on the rays, where the clip's gradient is 0.5;
(d) neus_alpha, inverse_sigmoid and the relight clip against their JAX
    functions on inputs built to hit the clip bounds exactly.
Widths: tests/test_ray_march.py's SMALL_COLOR, SMALL_NEUS, SMALL_COLOR_VAR,
off the initialisation by seeded noise. Tolerances (measured well below
them): forward atol 1e-5 and rtol 1e-5 on every lane (f32 summation
order; the eikonal numerator sums ~S (|grad| - 1)^2 terms of order 1); grads
atol 1e-4 x (the leaf's largest |JAX grad| + 1e-4) (the second-order SDF
path sums PE terms of both signs), a quarter of JAX's own march-against-core
bound (4e-4) with its floor (a leaf such as the variance at inv_s ~2000 is
a sum of saturated sigmoid slopes, rounding noise of ~1e-9 in both
packages); the tie probes 1e-4 relative (sigmoid rounding of ordinary points).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from color_neus_tpu.models import fields as jfields
from color_neus_tpu.models import neus as jneus
from color_neus_tpu.ops import transforms as jtransforms
from color_neus_tpu.ops.pallas.point_pipeline import resolve_dense
from color_neus_tpu.ops.pallas.ray_march import fused_ray_march as jax_march

from color_neus_torch import pin_precision
from color_neus_torch.models import configs, fields, neus
from color_neus_torch.ops import transforms
from color_neus_torch.ops.kernels import point_pipeline as PP
from color_neus_torch.ops.kernels import ray_march as RM
from color_neus_torch.weights import state_from_numpy
from tests.test_ray_march import SMALL_COLOR, SMALL_COLOR_VAR, SMALL_NEUS, _rays_z

torch.set_num_threads(1)
pin_precision()

FWD_ATOL = 1e-5
FWD_RTOL = 1e-5
GRAD_ATOL = 1e-4
GRAD_FLOOR = 1e-4
CFGS = {"color": SMALL_COLOR, "neus": SMALL_NEUS, "color_variant": SMALL_COLOR_VAR}


def port_cfg(jr) -> configs.RendererConfig:
    """The port's RendererConfig of a JAX one (the fields the port has)."""
    def sub(cls, obj):
        return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})
    top = {f.name: getattr(jr, f.name) for f in dataclasses.fields(configs.RendererConfig)
           if f.name not in ("sdf", "color", "relight", "variance", "nerf")}
    return configs.RendererConfig(
        **top, sdf=sub(configs.SDFConfig, jr.sdf), color=sub(configs.ColorConfig, jr.color),
        relight=sub(configs.RelightConfig, jr.relight),
        variance=sub(configs.VarianceConfig, jr.variance))


def jax_params(jr, seed=0, variance=None, noise=0.05):
    rng = np.random.RandomState(seed)
    params = jneus.init_renderer(jax.random.PRNGKey(seed), jr)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + noise * rng.randn(*np.shape(a))).astype(np.float32), params)
    if variance is not None:
        params["variance"]["variance"] = np.float32(variance)
    return params


def _jax_out16(params, jr, ro, rd, z, tile_rays=2):
    dense = resolve_dense(params, jr)
    inv_s = jfields.variance_inv_s(params["variance"])
    return jax_march(dense, jr, ro, rd, z, inv_s, tile_rays=tile_rays, interpret=True)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _check_march(jr, R, seed, variance=None, tile_rays=2, noise=0.05):
    """Forward and every gradient, port against JAX; returns the port's
    Composite of the rays (for the tie counts)."""
    pr = port_cfg(jr)
    params = jax_params(jr, seed, variance, noise)
    S = jr.n_samples + jr.n_importance
    ro, rd, z = _rays_z(R, S, seed=seed + 1)
    lw = np.random.RandomState(seed + 2).randn(R, 16).astype(np.float32)

    def loss(p, o, d):
        return jnp.sum(lw * _jax_out16(p, jr, o, d, z, tile_rays))

    want = np.asarray(jax.jit(lambda p: _jax_out16(p, jr, ro, rd, z, tile_rays))(params))
    g_p, g_o, g_d = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(params, ro, rd)

    tp = state_from_numpy(params)
    o, d = (torch.tensor(np.asarray(a), requires_grad=True) for a in (ro, rd))
    zt = torch.tensor(np.asarray(z))
    inv_s = fields.variance_inv_s(tp["variance"])
    got = RM.fused_ray_march(tp, pr, o, d, zt, inv_s)
    assert got.shape == (R, 16) and got.requires_grad
    np.testing.assert_allclose(got.detach().numpy(), want, atol=FWD_ATOL, rtol=FWD_RTOL)
    torch.sum(torch.from_numpy(lw) * got).backward()

    def close(a, b, name):
        scale = float(np.abs(b).max()) + GRAD_FLOOR
        np.testing.assert_allclose(a, b, atol=GRAD_ATOL * scale, rtol=0, err_msg=name)

    flat_j = _flat(jax.tree_util.tree_map(np.asarray, g_p))
    names = dict(tp.named_parameters())
    assert set(names) == set(flat_j)
    for k, leaf in names.items():
        close(leaf.grad.numpy(), flat_j[k], k)
    close(o.grad.numpy(), np.asarray(g_o), "rays_o")
    close(d.grad.numpy(), np.asarray(g_d), "rays_d")
    with torch.no_grad():
        pw = PP.resolve_pipeline_weights(tp, pr)
        dists, _, pts, dirs = RM.march_points(o, d, zt, 2.0 / pr.n_samples)
        return RM.composite(PP.point_pipeline_plain(pw, pts, dirs), d, dists, pts, inv_s)


@pytest.mark.parametrize("name", list(CFGS))
def test_march_matches_jax(name):
    _check_march(CFGS[name], R=4, seed=3)


def test_march_ragged_rays_match_jax():
    """R = 5 rays: JAX pads to whole 2-ray tiles, the port takes any R."""
    _check_march(SMALL_COLOR, R=5, seed=5, tile_rays=2)


def test_march_exact_ties_match_jax():
    """inv_s = exp(10 v) ~ 2000 puts exact q == 1 ties on the rays (alpha
    exactly 1 inside the surface); the clip's gradient there is 0.5 in
    both packages. Less noise on the weights keeps the surface the
    geometric init puts on the rays."""
    c = _check_march(SMALL_COLOR, R=8, seed=7, variance=np.log(2000.0) / 10.0, noise=0.01)
    assert int((c.q == 1.0).sum()) > 0


def test_plain_twins_run_in_float64():
    """The chip checks hold the kernels against the plain twins in float64:
    there the twins agree with their f32 runs to f32 rounding."""
    pr = port_cfg(SMALL_COLOR)
    tp = state_from_numpy(jax_params(SMALL_COLOR, seed=9))
    pw = PP.resolve_pipeline_weights(tp, pr)
    pw64 = PP.PipelineWeights(pr, *[[(w.double(), b.double()) for w, b in layers]
                                    for layers in (pw.sdf, pw.color, pw.relight)])
    R, S = 3, pr.n_samples + pr.n_importance
    o, d, z = (torch.tensor(np.asarray(a)) for a in _rays_z(R, S, seed=10))
    s = fields.variance_inv_s(tp["variance"]).detach().reshape(1)
    gbar = torch.from_numpy(np.random.RandomState(11).randn(R, 16).astype(np.float32))
    sd = 2.0 / pr.n_samples
    out32 = RM.ray_march_plain(pw, o, d, z, s, sd)
    out64 = RM.ray_march_plain(pw64, o.double(), d.double(), z.double(), s.double(), sd)
    assert out64.dtype == torch.float64
    np.testing.assert_allclose(out32.numpy(), out64.numpy(), atol=FWD_ATOL, rtol=FWD_RTOL)
    b32 = RM.ray_march_bwd_plain(pw, o, d, z, s, sd, gbar)
    b64 = RM.ray_march_bwd_plain(pw64, o.double(), d.double(), z.double(), s.double(), sd,
                                 gbar.double())
    for a, b in zip(b32[:3], b64[:3]):
        scale = float(b.abs().max())
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=GRAD_ATOL * scale, rtol=0)
    for net, layers in b64[3].items():
        for (a, b), (c, e) in zip(b32[3][net], layers):
            for x, y in ((a, c), (b, e)):
                np.testing.assert_allclose(x.numpy(), y.numpy(),
                                           atol=GRAD_ATOL * float(y.abs().max()), rtol=0)


def test_march_macs_per_point():
    """The bound's count at the full Color-NeuS widths: the point pipeline's
    ~1.45 M forward and ~4.8 M backward multiply-adds per point."""
    full = configs.RendererConfig(color=configs.ColorConfig(mode="no_view_dir", d_in=6,
                                                            multires_view=0))
    pw = PP.resolve_pipeline_weights(neus.init_renderer(full, torch.Generator().manual_seed(0)),
                                     full)
    fwd, bwd = RM.march_macs_per_point(pw)
    assert 1.4e6 < fwd < 1.5e6 and 4.7e6 < bwd < 4.9e6


# ---------------------------------------------------------------------------
# the clips' tie rule
# ---------------------------------------------------------------------------

# rows 0-3: q == 1 exactly (pc rounds to 1, nc below half its ulp); rows 4-5:
# q == 0 exactly (found by search; iter_cos > 0 puts next above prev);
# rows 6-7: ordinary points
TIE_SDF = np.array([0.0, 0.001, -0.002, 0.003, -0.009249277, -0.0092536975, 0.05, -0.01],
                   np.float32)
TIE_COS = np.array([-1, -1, -1, -1, 1, 1, -0.3, -0.7], np.float32)
TIE_DIST = np.array([0.02, 0.02, 0.025, 0.03, 0.00698564, 0.0069944803, 0.01, 0.004],
                    np.float32)
TIE_INV_S = np.float32(2000.0)


def _grads_close(got, want, names):
    for a, b, name in zip(got, want, names):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-30, err_msg=name)


def test_neus_alpha_tie_gradient_matches_jax():
    """jnp.clip gives half the gradient at q == 0 and q == 1; torch.clamp
    would give all of it (twice JAX's gradient at every tie)."""
    args = (TIE_SDF, TIE_COS, TIE_DIST, TIE_INV_S)
    alpha_j = np.asarray(jneus.neus_alpha(*args)[0])
    assert (alpha_j[:4] == 1.0).all() and (alpha_j[4:6] == 0.0).all()
    want = jax.grad(lambda *a: jnp.sum(jneus.neus_alpha(*a)[0]), argnums=(0, 1, 2, 3))(*args)
    t = [torch.tensor(a, requires_grad=True) for a in args]
    alpha, _ = neus.neus_alpha(*t)
    q = (alpha.detach().numpy())
    np.testing.assert_array_equal(q, alpha_j)
    alpha.sum().backward()
    _grads_close([x.grad.numpy() for x in t], want, ("sdf", "iter_cos", "dists", "inv_s"))


def test_inverse_sigmoid_tie_gradient_matches_jax():
    """clip(x, 0, 1) ties at 0 and 1, max(x, eps) ties at eps."""
    x = np.array([0.0, 1.0, 1e-5, 1.0 - 1e-5, 0.3], np.float32)
    want = jax.grad(lambda v: jnp.sum(jtransforms.inverse_sigmoid(v)))(x)
    t = torch.tensor(x, requires_grad=True)
    out = transforms.inverse_sigmoid(t)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jtransforms.inverse_sigmoid(x)))
    out.sum().backward()
    _grads_close([t.grad.numpy()], [want], ("x",))


def test_relight_clip_tie_gradient_matches_jax():
    """fields.relight_apply's clip(gc + sigmoid(delta) - 0.5, 0, 1)
    (inv_sigmoid off) at a tie on each bound: a relight net with a zero
    last layer (delta = 0), so gc = 0 and gc = 1 sit on the bounds."""
    gc = np.repeat(np.array([0.0, 1.0, 0.5, 0.25], np.float32)[:, None], 3, axis=1)
    want = jax.grad(lambda r: jnp.sum(jnp.clip(r + jax.nn.sigmoid(0.0) - 0.5, 0.0, 1.0)))(gc)
    cfg = configs.RelightConfig(d_hidden=8, n_layers=2, y_in_layer=1, inv_sigmoid=False)
    params = fields.init_relight(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for leaf in params[f"mlp{cfg.n_layers - 1}"].values():
            leaf.zero_()
    r = torch.tensor(gc, requires_grad=True)
    pts = torch.full((4, 3), 0.1)
    out, delta = fields.relight_apply(params, cfg, r, pts, pts, pts)
    assert float(delta.detach().abs().max()) == 0.0
    np.testing.assert_array_equal(out.detach().numpy(), gc)
    out.sum().backward()
    _grads_close([r.grad.numpy()], [want], ("gc",))
