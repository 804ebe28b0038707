"""The render core's keys RAY_CHUNK, COMPUTE_DTYPE and N_OUTSIDE in the
port against the JAX package, on the CPU at small widths, identical
weights (weights.state_from_numpy), identical rays, perturb 0, fused_sdf
off on both sides (the plain hierarchy).

(a) ray_chunk: render_rays chunked (each chunk under
    torch.utils.checkpoint) against the unchunked port (outputs atol
    1e-6, every leaf's gradient of a loss through the colour and the
    eikonal term atol 2e-5: f32, the same arithmetic summed in chunks) and
    against JAX's chunked render_rays (the render tolerances of
    test_torch_neus.py: colour 2e-4, depth 1e-3; gradients atol 3e-3 x the
    leaf's largest |g|, rtol 2e-3, test_torch_trainer.py's); a chunk that
    does not divide R runs the unchunked core, as in JAX. The gradient
    differentiates the SDF's input gradient a second time through the
    recomputation.
(b) compute_dtype bfloat16: the port's outputs and gradients against
    JAX's in bfloat16. Both round the same operands (and, in the backward,
    the same cotangents) to bf16 and sum exact products in f32, in other
    orders, so a value within rounding of a bf16 midpoint can round the
    other way: outputs at the render tolerances (read 8.6e-6 on the
    colour), gradients 1e-2 x the leaf's largest |g| (read 3.6e-3); the
    f32 run sits 2.0e-3 / 8.0e-2 away, outside both. JAX's own check
    against f32 (colour within 0.1) holds too, and the outputs are f32.
(c) n_outside 4, the NeRF++ background at test_renderer.py's
    test_nerf_background_path shape (NeuS and Color-NeuS): the nerf subtree
    carried across by weights.py both ways, outputs (depth over the
    foreground and background z) and every leaf's gradient at f32 against
    JAX's, at the tolerances of (a); the loss path's fused_march on takes
    the plain core there."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from color_neus_tpu.models import configs as jconfigs
from color_neus_tpu.models import neus as jneus
from color_neus_tpu.ops.rays import near_far_from_sphere as jnear_far

from color_neus_torch import pin_precision
from color_neus_torch.models import configs, neus
from color_neus_torch.weights import state_from_numpy, state_to_numpy

torch.set_num_threads(1)
pin_precision()

OUTS = (("color_fine", 2e-4), ("weight_sum", 2e-4), ("depth", 1e-3),
        ("gradient_error", 2e-4), ("s_val", 1e-6))


def _cfg(mod, kind="color_neus", **kw):
    cn = kind == "color_neus"
    nerf = kw.pop("nerf", {})
    return mod.RendererConfig(
        kind=kind, n_samples=8, n_importance=4, up_sample_steps=2, perturb=0.0,
        fused_sdf="off", **kw,
        sdf=mod.SDFConfig(d_hidden=32, n_layers=2, skip_in=(), multires=2),
        color=mod.ColorConfig(mode="no_view_dir" if cn else "idr", d_in=6 if cn else 9,
                              d_feature=256, d_hidden=32, n_layers=1,
                              multires_view=0 if cn else 2),
        relight=mod.RelightConfig(d_hidden=16, n_layers=4, y_in_layer=3),
        nerf=mod.NeRFConfig(**nerf))


def _rays(n=16):
    rng = np.random.RandomState(0)
    d = rng.randn(n, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = (-2.2 * d + 0.05 * rng.randn(n, 3)).astype(np.float32)
    d = d.astype(np.float32)
    near, far = jnear_far(jnp.asarray(o), jnp.asarray(d))
    return o, d, np.asarray(near), np.asarray(far)


def _params(jcfg, seed=0):
    """JAX's init, off the SDF's geometric init, and the port's copy."""
    params = jneus.init_renderer(jax.random.PRNGKey(seed), jcfg)
    leaves, tree = jax.tree_util.tree_flatten(params["sdf"])
    keys = jax.random.split(jax.random.PRNGKey(7), len(leaves))
    params["sdf"] = jax.tree_util.tree_unflatten(
        tree, [x + 0.02 * jax.random.normal(k, x.shape) for x, k in zip(leaves, keys)])
    tree_np = jax.tree_util.tree_map(np.asarray, params)
    return params, state_from_numpy(tree_np)


def _loss(out):
    return out["color_fine"].mean() + out["gradient_error"]


def _port(pp, pcfg, rays):
    pp.zero_grad(set_to_none=True)
    out = neus.render_rays(pp, pcfg, *map(torch.from_numpy, rays), perturb_overwrite=0.0)
    _loss(out).backward()
    return out, {k: p.grad for k, p in pp.named_parameters()}


def _jax(jp, jcfg, rays):
    args = tuple(map(jnp.asarray, rays))

    def loss(p):
        out = jneus.render_rays(p, jcfg, *args, perturb_overwrite=0.0)
        return _loss(out), out
    (_, out), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(jp)
    flat = {}

    def walk(d, prefix):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                flat[prefix + k] = np.asarray(v)
    walk(g, "")
    return out, flat


def _close_outputs(got, want, scale=1.0, keys=OUTS):
    for k, atol in keys:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]),
                                   atol=atol * scale, err_msg=k)


def _close_grads(got, want, rel=3e-3, rtol=2e-3):
    assert set(got) == set(want)
    for k, g in want.items():
        mine = got[k]
        mine = np.zeros_like(g) if mine is None else mine.numpy()
        np.testing.assert_allclose(mine, g, atol=rel * float(np.abs(g).max()), rtol=rtol,
                                   err_msg=k)


@pytest.mark.parametrize("kind,chunk", [("color_neus", 4), ("neus", 4), ("color_neus", 5)],
                         ids=["color_neus-4", "neus-4", "color_neus-5-not-dividing"])
def test_ray_chunk_matches_unchunked_and_jax(kind, chunk):
    rays = _rays(16)
    jcfg = _cfg(jconfigs, kind, ray_chunk=chunk)
    pcfg = _cfg(configs, kind, ray_chunk=chunk)
    jp, pp = _params(jcfg)
    got, g_got = _port(pp, pcfg, rays)
    flat, g_flat = _port(pp, dataclasses.replace(pcfg, ray_chunk=0), rays)
    for k in ("color_fine", "weight_sum", "depth", "weights", "gradient_error", "gradients"):
        np.testing.assert_allclose(got[k].detach().numpy(), flat[k].detach().numpy(),
                                   atol=1e-6, err_msg=k)
    for k, g in g_flat.items():
        np.testing.assert_allclose(g_got[k].numpy(), g.numpy(), atol=2e-5, err_msg=k)
    want, g_want = _jax(jp, jcfg, rays)
    _close_outputs(got, want)
    _close_grads(g_got, g_want)
    assert float(g_got["sdf.lin0.v"].abs().max()) > 0


def test_ray_chunk_bundle_runs_chunked(monkeypatch):
    """R > ray_chunk and a divisor: the loss path's plain core (fused_march
    auto) runs R / ray_chunk checkpointed chunks; otherwise none."""
    calls = []
    real = neus.checkpoint
    monkeypatch.setattr(neus, "checkpoint", lambda *a, **k: calls.append(1) or real(*a, **k))
    rays = _rays(16)
    pcfg = _cfg(configs, ray_chunk=4)
    _, pp = _params(_cfg(jconfigs))
    out = neus.render_rays_train(pp, pcfg, *map(torch.from_numpy, rays), perturb_overwrite=0.0)
    assert len(calls) == 4 and out["color_fine"].shape == (16, 3)
    for chunk in (16, 5, 0):
        calls.clear()
        neus.render_rays_train(pp, dataclasses.replace(pcfg, ray_chunk=chunk),
                               *map(torch.from_numpy, rays), perturb_overwrite=0.0)
        assert not calls, chunk


def test_compute_dtype_bf16_matches_jax():
    rays = _rays(16)
    jcfg = _cfg(jconfigs, compute_dtype="bfloat16")
    pcfg = _cfg(configs, compute_dtype="bfloat16")
    jp, pp = _params(jcfg)
    got, g_got = _port(pp, pcfg, rays)
    assert got["color_fine"].dtype == torch.float32
    want, g_want = _jax(jp, jcfg, rays)
    _close_outputs(got, want)
    _close_grads(g_got, g_want, rel=1e-2, rtol=0)
    f32, _ = _port(pp, dataclasses.replace(pcfg, compute_dtype="float32"), rays)
    diff = float((got["color_fine"] - f32["color_fine"]).abs().max())
    assert 0 < diff < 0.1, diff


@pytest.mark.parametrize("kind", ["neus", "color_neus"])
def test_nerf_background_matches_jax(kind):
    nerf = dict(depth=2, width=32, multires=2, multires_view=2, skips=())
    jcfg = _cfg(jconfigs, kind, n_outside=4, nerf=nerf)
    pcfg = _cfg(configs, kind, n_outside=4, nerf=nerf)
    jp, pp = _params(jcfg)
    assert "nerf" in pp and set(pp["nerf"]) == set(jp["nerf"])
    back = state_to_numpy(pp)["nerf"]
    for k, v in jp["nerf"].items():
        for leaf, x in v.items():
            np.testing.assert_array_equal(back[k][leaf], np.asarray(x))
    port_init = neus.init_renderer(pcfg, torch.Generator().manual_seed(0))
    assert {k: tuple(p.shape) for k, p in port_init["nerf"].named_parameters()} == \
        {k: tuple(p.shape) for k, p in pp["nerf"].named_parameters()}
    rays = _rays(3)
    got, g_got = _port(pp, pcfg, rays)
    S = pcfg.n_samples + pcfg.n_importance
    assert got["weights"].shape == (3, S + 4) and got["depth"].shape == (3,)
    want, g_want = _jax(jp, jcfg, rays)
    _close_outputs(got, want)
    np.testing.assert_allclose(got["weights"].detach().numpy(), np.asarray(want["weights"]),
                               atol=2e-4)
    _close_grads(g_got, g_want)
    assert float(g_got["nerf.pts0.w"].abs().max()) > 0
    march = dataclasses.replace(pcfg, fused_march="on")
    assert not neus._use_fused_march(march)
    tr = neus.render_rays_train(pp, march, *map(torch.from_numpy, rays), perturb_overwrite=0.0)
    np.testing.assert_allclose(tr["color_fine"].detach().numpy(),
                               got["color_fine"].detach().numpy(), atol=1e-6)


def test_render_keys_parse():
    base = {"TYPE": "Color_NeuS", "COLOR": {"MODE": "no_view_dir"}}
    rc = configs.renderer_config_from_cfg(
        {**base, "RAY_CHUNK": 256, "COMPUTE_DTYPE": "bfloat16", "N_OUTSIDE": 32,
         "NERF": {"D": 4, "W": 64}})
    assert (rc.ray_chunk, rc.compute_dtype, rc.n_outside) == (256, "bfloat16", 32)
    assert (rc.nerf.depth, rc.nerf.width) == (4, 64)
    with pytest.raises(ValueError, match="compute_dtype"):
        configs.renderer_config_from_cfg({**base, "COMPUTE_DTYPE": "int8"})
