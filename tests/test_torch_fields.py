"""color_neus_torch fields, PE, transforms and the weight bridge against
the JAX package, at small widths on the CPU.

The JAX params (neus.init_renderer) go through weights.state_from_numpy,
so both sides hold the same f32 weights; inputs come from numpy.
Tolerances: values 1e-5 / input gradients 1e-4 absolute (f32 on both
sides; only the summation order of the matmuls differs — orders of
magnitude below the 2e-4 render tolerance of test_parity_torch.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from color_neus_tpu.models import fields as jfields
from color_neus_tpu.models import neus as jneus
from color_neus_tpu.models.configs import (
    ColorConfig as JColorConfig, RelightConfig as JRelightConfig,
    RendererConfig as JRendererConfig, SDFConfig as JSDFConfig,
)
from color_neus_tpu.ops import embedding as jemb
from color_neus_tpu.ops import transforms as jtr

from color_neus_torch import pin_precision
from color_neus_torch.models import fields
from color_neus_torch.models.configs import ColorConfig, RelightConfig, SDFConfig
from color_neus_torch.ops import embedding, transforms
from color_neus_torch.weights import state_from_numpy, state_to_numpy

torch.set_num_threads(1)
pin_precision()

SDF_KW = dict(d_hidden=64, n_layers=4, skip_in=(2,), multires=4)


def _jax_params(mode="no_view_dir"):
    rcfg = JRendererConfig(
        kind="color_neus", sdf=JSDFConfig(**SDF_KW),
        color=JColorConfig(mode=mode, d_in=9 if mode == "idr" else 6,
                           d_hidden=64, n_layers=2,
                           multires_view=0 if mode == "no_view_dir" else 4),
        relight=JRelightConfig(d_hidden=32))
    params = jneus.init_renderer(jax.random.PRNGKey(0), rcfg)
    return rcfg, jax.tree_util.tree_map(np.asarray, params)


def _pts(n=40, seed=0):
    return np.random.RandomState(seed).uniform(-1.1, 1.1, (n, 3)).astype(np.float32)


def test_weight_bridge_round_trip():
    _, tree = _jax_params()
    mod = state_from_numpy({"renderer": tree})
    back = state_to_numpy(mod)["renderer"]
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b) == len(list(mod.parameters()))
    for path, a in flat_a:
        np.testing.assert_array_equal(a, flat_b[path])
    names = {n for n, _ in mod.named_parameters()}
    assert "renderer.sdf.lin0.v" in names and "renderer.variance.variance" in names


def test_positional_encoding_matches_jax():
    x = _pts()
    got = embedding.positional_encoding(torch.from_numpy(x), 6).numpy()
    want = np.asarray(jemb.positional_encoding(jnp.asarray(x), 6))
    assert got.shape == (40, embedding.embedding_dim(3, 6)) == (40, 39)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_rotations_match_jax():
    rng = np.random.RandomState(1)
    aa = (rng.randn(16, 3) * 0.7).astype(np.float32)
    aa[0] = 0.0  # the Taylor branch
    d6 = rng.randn(16, 6).astype(np.float32)
    np.testing.assert_allclose(transforms.aa_to_rotmat(torch.from_numpy(aa)).numpy(),
                               np.asarray(jtr.aa_to_rotmat(jnp.asarray(aa))), atol=1e-6)
    np.testing.assert_allclose(transforms.rot6d_to_rotmat(torch.from_numpy(d6)).numpy(),
                               np.asarray(jtr.rot6d_to_rotmat(jnp.asarray(d6))), atol=1e-6)
    x = rng.uniform(-0.1, 1.1, (50,)).astype(np.float32)
    np.testing.assert_allclose(transforms.inverse_sigmoid(torch.from_numpy(x)).numpy(),
                               np.asarray(jtr.inverse_sigmoid(jnp.asarray(x))), atol=1e-5)
    np.testing.assert_array_equal(transforms.pose_spherical(30.0, -20.0, 3.0),
                                  jtr.pose_spherical(30.0, -20.0, 3.0))


def test_sdf_values_and_input_grads_match_jax():
    rcfg, tree = _jax_params()
    p = state_from_numpy(tree)
    x = _pts()
    cfg = SDFConfig(**SDF_KW)
    out_j = np.asarray(jfields.sdf_apply(tree["sdf"], rcfg.sdf, jnp.asarray(x)))
    out_t = fields.sdf_apply(p["sdf"], cfg, torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(out_t, out_j, atol=1e-5)

    s_j, f_j, g_j = jfields.sdf_with_grad(tree["sdf"], rcfg.sdf, jnp.asarray(x))
    s_t, f_t, g_t = fields.sdf_with_grad(p["sdf"], cfg, torch.from_numpy(x))
    np.testing.assert_allclose(s_t.detach().numpy(), np.asarray(s_j), atol=1e-5)
    np.testing.assert_allclose(g_t.detach().numpy(), np.asarray(g_j), atol=1e-4)
    assert g_t.requires_grad  # differentiable (second-order path)


@pytest.mark.parametrize("mode", ["idr", "no_view_dir", "no_normal"])
def test_color_modes_match_jax(mode):
    rcfg, tree = _jax_params(mode)
    ccfg = ColorConfig(**{f: getattr(rcfg.color, f) for f in rcfg.color.__dataclass_fields__})
    p = state_from_numpy(tree)
    rng = np.random.RandomState(2)
    pts, nrm, dirs = (rng.randn(30, 3).astype(np.float32) for _ in range(3))
    feat = rng.randn(30, ccfg.d_feature).astype(np.float32)
    want = np.asarray(jfields.color_apply(tree["color"], rcfg.color, *map(jnp.asarray, (pts, nrm, dirs, feat))))
    got = fields.color_apply(p["color"], ccfg, *map(torch.from_numpy, (pts, nrm, dirs, feat)))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)


def test_relight_and_variance_match_jax():
    rcfg, tree = _jax_params()
    p = state_from_numpy(tree)
    rng = np.random.RandomState(3)
    rgb = rng.uniform(0, 1, (30, 3)).astype(np.float32)
    pts, dirs, grads = (rng.randn(30, 3).astype(np.float32) for _ in range(3))
    out_j, d_j = jfields.relight_apply(tree["relight"], rcfg.relight,
                                       *map(jnp.asarray, (rgb, pts, dirs, grads)))
    out_t, d_t = fields.relight_apply(p["relight"], RelightConfig(d_hidden=32),
                                      *map(torch.from_numpy, (rgb, pts, dirs, grads)))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), atol=1e-5)
    np.testing.assert_allclose(d_t.detach().numpy(), np.asarray(d_j), atol=1e-5)
    np.testing.assert_allclose(float(fields.variance_inv_s(p["variance"]).detach()),
                               float(jfields.variance_inv_s(tree["variance"])), rtol=1e-6)


@pytest.mark.parametrize("skip_in,multires", [((4,), 6), ((2,), 4)])
def test_init_sdf_structure(skip_in, multires):
    """Geometric init: same leaf shapes as JAX, the layer before the skip
    outputs d_hidden - d0, zeroed PE columns, and the sphere bias — the
    structure, not the RNG values."""
    n_layers = 8 if skip_in == (4,) else 4
    cfg = SDFConfig(d_hidden=256 if n_layers == 8 else 64, n_layers=n_layers,
                    skip_in=skip_in, multires=multires)
    jcfg = JSDFConfig(d_hidden=cfg.d_hidden, n_layers=n_layers, skip_in=skip_in,
                      multires=multires)
    p = fields.init_sdf(cfg, torch.Generator().manual_seed(0))
    jp = jfields.init_sdf(jax.random.PRNGKey(0), jcfg)
    d0 = 3 + 6 * multires
    for name, layer in p.items():
        for leaf, t in layer.items():
            assert tuple(t.shape) == tuple(jp[name][leaf].shape), (name, leaf)
    s = skip_in[0]
    assert p[f"lin{s - 1}"]["v"].shape[0] == cfg.d_hidden - d0
    assert torch.all(p["lin0"]["v"][:, 3:] == 0) and torch.all(p["lin0"]["v"][:, :3] != 0)
    assert torch.all(p[f"lin{s}"]["v"][:, -(d0 - 3):] == 0)
    last = p[f"lin{n_layers}"]
    assert torch.all(last["b"] == -cfg.bias)
    mean = float(last["v"].detach().mean())
    assert abs(mean - np.sqrt(np.pi) / np.sqrt(cfg.d_hidden)) < 1e-4
    np.testing.assert_allclose(last["g"].detach().numpy(),
                               torch.linalg.norm(last["v"], dim=1).detach().numpy(), rtol=1e-6)
    # the init grows with the radius: negative at the centre, positive out
    # at the edge of the unit sphere
    x = torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.5, 0.0], [0.0, 0.0, 0.95]])
    sdf = fields.sdf_value(p, cfg, x)[:, 0].detach().numpy()
    assert sdf[0] < 0.0 < sdf[2] and sdf[0] < sdf[1] < sdf[2], sdf
