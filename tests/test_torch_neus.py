"""color_neus_torch.models.neus / color_neus against the JAX package.

Small widths on the CPU, identical weights (weights.state_from_numpy),
identical rays, perturb 0. The JAX hierarchy runs its Pallas sweep
kernel in interpret mode (fused_sdf='interpret') or its plain path
('off'); the port runs its sweep module (plain version on the CPU) or
fields.sdf_value. Tolerances: z values atol 1e-5 + rtol 1e-5 (f32 sdf
differences of ~1e-6 pass through sample_pdf's cdf inversion, see
test_torch_rays.py); rendered colour, weight sum, eikonal and relight
delta atol 2e-4 and depth 1e-3, the tolerances of test_parity_torch.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from color_neus_tpu.models import configs as jconfigs
from color_neus_tpu.models import neus as jneus
from color_neus_tpu.ops.pallas.sdf_mlp import resolve_sdf_sweep_fn as jax_sweep_fn
from color_neus_tpu.ops.rays import near_far_from_sphere as jnear_far

from color_neus_torch import pin_precision
from color_neus_torch.models import configs, neus
from color_neus_torch.ops.kernels.sdf_rays import resolve_sdf_sweep_fn
from color_neus_torch.weights import state_from_numpy

torch.set_num_threads(1)
pin_precision()


def _cfg_kwargs(kind):
    cn = kind == "color_neus"
    return dict(
        kind=kind, n_samples=16, n_importance=8, up_sample_steps=4, perturb=0.0,
        sweep_dtype="float32",
        sdf=dict(d_hidden=64, n_layers=4, skip_in=(2,), multires=4),
        color=dict(mode="no_view_dir" if cn else "idr", d_in=6 if cn else 9, d_feature=256,
                   d_hidden=64, n_layers=2, multires_view=0 if cn else 4),
        relight=dict(d_hidden=32, n_layers=4, y_in_layer=3),
    )


def _build(mod, kw, **over):
    kw = {**kw, **over}
    return mod.RendererConfig(
        **{k: v for k, v in kw.items() if k not in ("sdf", "color", "relight")},
        sdf=mod.SDFConfig(**kw["sdf"]), color=mod.ColorConfig(**kw["color"]),
        relight=mod.RelightConfig(**kw["relight"]))


def _setup(kind, jax_sdf="off", port_sdf="auto", act="softplus"):
    kw = _cfg_kwargs(kind)
    jcfg = _build(jconfigs, kw, fused_sdf=jax_sdf, sweep_activation=act)
    pcfg = _build(configs, kw, fused_sdf=port_sdf, sweep_activation=act)
    params = jneus.init_renderer(jax.random.PRNGKey(0), jcfg)
    # move the SDF off its geometric init so the hierarchy has structure
    leaves, tree = jax.tree_util.tree_flatten(params["sdf"])
    keys = jax.random.split(jax.random.PRNGKey(7), len(leaves))
    params["sdf"] = jax.tree_util.tree_unflatten(
        tree, [x + 0.02 * jax.random.normal(k, x.shape) for x, k in zip(leaves, keys)])
    tree_np = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, pcfg, params, state_from_numpy(tree_np)


def _rays(n=24, seed=3):
    rng = np.random.RandomState(seed)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = (-2.2 * d + 0.1 * rng.randn(n, 3)).astype(np.float32)
    near, far = jnear_far(jnp.asarray(o), jnp.asarray(d))
    return o, d, np.array(near), np.array(far)


@pytest.mark.parametrize("jax_sdf,port_sdf,act", [
    ("interpret", "auto", "softplus"),
    ("interpret", "auto", "relu"),
    ("off", "off", "softplus"),
])
def test_hierarchical_z_vals_match_jax(jax_sdf, port_sdf, act):
    jcfg, pcfg, jp, pp = _setup("color_neus", jax_sdf, port_sdf, act)
    o, d, near, far = _rays()
    j_sweep = (jax_sweep_fn(jp["sdf"], jcfg.sdf, "interpret", dtype="float32", act=act)
               if jax_sdf == "interpret" else None)
    want = jneus.hierarchical_z_vals(jp, jcfg, *map(jnp.asarray, (o, d, near, far)),
                                     perturb_overwrite=0.0, sdf_rays_fn=j_sweep)
    p_sweep = resolve_sdf_sweep_fn(pp["sdf"], pcfg.sdf, port_sdf, dtype="float32", act=act)
    calls = []

    def counted(*a):
        calls.append(1)
        return p_sweep(*a)

    got = neus.hierarchical_z_vals(pp, pcfg, *map(torch.from_numpy, (o, d, near, far)),
                                   perturb_overwrite=0.0,
                                   sdf_rays_fn=counted if p_sweep is not None else None)
    assert got.shape == (24, 16 + 8) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    if p_sweep is not None:
        assert len(calls) == 1 + (pcfg.up_sample_steps - 1)   # 4 sweeps per step


@pytest.mark.parametrize("kind", ["neus", "color_neus"])
def test_render_rays_matches_jax(kind):
    jcfg, pcfg, jp, pp = _setup(kind)
    o, d, near, far = _rays()
    out_j = jneus.render_rays(jp, jcfg, *map(jnp.asarray, (o, d, near, far)),
                              perturb_overwrite=0.0)
    out_t = neus.render_rays(pp, pcfg,
                             *map(torch.from_numpy, (o, d, near, far)), perturb_overwrite=0.0)
    for k, atol in (("color_fine", 2e-4), ("weight_sum", 2e-4), ("depth", 1e-3),
                    ("gradient_error", 2e-4), ("s_val", 1e-6)):
        np.testing.assert_allclose(out_t[k].detach().numpy(), np.asarray(out_j[k]),
                                   atol=atol, err_msg=k)
    if kind == "color_neus":
        for k in ("delta_relight", "global_color"):
            np.testing.assert_allclose(out_t[k].detach().numpy(), np.asarray(out_j[k]),
                                       atol=2e-4, err_msg=k)

    tr_j = jneus.render_rays_train(jp, jcfg, *map(jnp.asarray, (o, d, near, far)),
                                   perturb_overwrite=0.0)
    tr_t = neus.render_rays_train(pp, pcfg, *map(torch.from_numpy, (o, d, near, far)),
                                  perturb_overwrite=0.0)
    assert set(tr_t) == set(tr_j)
    np.testing.assert_allclose(tr_t["color_fine"].detach().numpy(),
                               np.asarray(tr_j["color_fine"]), atol=2e-4)
    if kind == "color_neus":
        np.testing.assert_allclose(tr_t["delta_sum"].detach().numpy(),
                                   np.asarray(tr_j["delta_sum"]), atol=2e-4 * 24)


def test_kernel_switches():
    kw = _cfg_kwargs("color_neus")
    assert _build(configs, kw, fused_march="on").fused_march == "on"
    assert configs.renderer_config_from_cfg({"FUSED_MARCH": True}).fused_march == "on"
    for acts in ("auto", "save", "recompute"):
        assert configs.renderer_config_from_cfg({"MARCH_ACTS": acts}).march_acts == acts
    with pytest.raises(ValueError):
        configs.renderer_config_from_cfg({"MARCH_ACTS": "sometimes"})
    _build(configs, kw, fused_march="off")
    _build(configs, kw, fused_core="off")
    # fused_core='on' builds; under grad it runs the point pipeline's
    # autograd Function (forward and backward kernels; their plain twins on
    # the CPU), without grad the forward alone
    on = _build(configs, kw, fused_core="on")
    params = neus.init_renderer(on, torch.Generator().manual_seed(0))
    pts = torch.full((4, 3), 0.1, requires_grad=True)
    out = neus.eval_point_pipeline(params, on, pts, pts)
    assert out[0].shape == (4, 1) and out[1].requires_grad
    torch.sum(out[1]).backward()
    assert pts.grad is not None and bool(torch.isfinite(pts.grad).all())
    assert params["sdf"]["lin0"]["v"].grad is not None
    with torch.no_grad():
        assert neus.eval_point_pipeline(params, on, pts, pts)[0].shape == (4, 1)
    # the grid SDF's 3-pass split, ported since: it builds
    assert dataclasses.replace(on, extract_precision="f32x3").extract_precision == "f32x3"
    with pytest.raises(ValueError, match="extract_precision"):
        dataclasses.replace(on, extract_precision="f16")
    with pytest.raises(ValueError):
        _build(configs, kw, fused_sdf="interpret")
    cfg = dataclasses.replace(_build(configs, kw), fused_sdf="on")
    assert cfg.fused_sdf == "on"


@pytest.mark.parametrize("kind", ["neus", "color_neus"])
def test_render_rays_train_fused_march_matches_plain_core(kind):
    """fused_march='on' (the march's autograd Function; its plain twins on
    the CPU) against 'auto' (the plain autograd core) on the same rays and
    weights: every output of the loss path within the render tolerances
    (2e-4), and the gradients of a loss of them on every leaf and on the
    rays within atol 1e-4 x the leaf's largest |grad| (f32, the same
    arithmetic in another order; the march's sums over each ray)."""
    _, pcfg, _, pp = _setup(kind)
    o, d, near, far = _rays()
    rng = np.random.RandomState(4)
    lw = torch.from_numpy(rng.randn(24, 3).astype(np.float32))
    got = {}
    for march in ("on", "auto"):
        cfg = dataclasses.replace(pcfg, fused_march=march)
        pp.zero_grad(set_to_none=True)
        ro, rd = (torch.tensor(a, requires_grad=True) for a in (o, d))
        out = neus.render_rays_train(pp, cfg, ro, rd, torch.from_numpy(near),
                                     torch.from_numpy(far), perturb_overwrite=0.0)
        loss = torch.sum(lw * out["color_fine"]) + torch.sum(out["weight_sum"]) \
            + 0.1 * out["gradient_error"]
        if "delta_sum" in out:
            loss = loss + 0.01 * torch.sum(out["delta_sum"])
        loss.backward()
        got[march] = (out, {k: p.grad for k, p in pp.named_parameters()}, ro.grad, rd.grad)
    (on, g_on, ro_on, rd_on), (auto, g_auto, ro_auto, rd_auto) = got["on"], got["auto"]
    assert set(on) == set(auto) and on["n_samples_total"] == auto["n_samples_total"]
    for k in ("color_fine", "weight_sum", "gradient_error", "s_val", "delta_sum"):
        if k in auto:
            np.testing.assert_allclose(on[k].detach().numpy(), auto[k].detach().numpy(),
                                       atol=2e-4, err_msg=k)
    for k, g in list(g_auto.items()) + [("rays_o", ro_auto), ("rays_d", rd_auto)]:
        mine = {"rays_o": ro_on, "rays_d": rd_on}.get(k, g_on.get(k))
        if g is None:
            assert mine is None or float(mine.abs().max()) == 0.0, k
            continue
        scale = float(g.abs().max())
        np.testing.assert_allclose(mine.numpy(), g.numpy(), atol=1e-4 * scale, rtol=0,
                                   err_msg=k)
