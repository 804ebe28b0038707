"""The placement-sweep module (ops/kernels/sdf_rays.py).

On the CPU: sdf_rays_plain against the JAX package's Pallas kernel
(make_fused_sdf_rays_fn, interpret mode) on the same weights and rays,
both activations, R not a multiple of the kernel's ray tile; atol 1e-5
(both exact f32, only the summation order differs). The CUDA kernel's
own test is tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from color_neus_tpu.models import fields as jfields
from color_neus_tpu.models.configs import SDFConfig as JSDFConfig
from color_neus_tpu.ops.pallas.sdf_mlp import make_fused_sdf_rays_fn as jax_sweep_fn

from color_neus_torch import pin_precision
from color_neus_torch.models.configs import SDFConfig
from color_neus_torch.models.fields import init_sdf, sdf_value
from color_neus_torch.ops.embedding import positional_encoding
from color_neus_torch.ops.kernels import sdf_rays as K
from color_neus_torch.weights import state_from_numpy

torch.set_num_threads(1)
pin_precision()

SDF_KW = dict(d_hidden=64, n_layers=4, skip_in=(2,), multires=4)


def _inputs(R, S, seed=0):
    rng = np.random.RandomState(seed)
    d = rng.randn(R, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = (-2.2 * d + 0.1 * rng.randn(R, 3)).astype(np.float32)
    z = np.sort(rng.uniform(1.0, 3.4, (R, S)), axis=1).astype(np.float32)
    return o, d, z


def _jax_sdf(seed=0):
    p = jfields.init_sdf(jax.random.PRNGKey(seed), JSDFConfig(**SDF_KW))
    # move off the geometric init so every layer matters
    leaves, tree = jax.tree_util.tree_flatten(p)
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), len(leaves))
    leaves = [x + 0.02 * jax.random.normal(k, x.shape) for x, k in zip(leaves, keys)]
    return jax.tree_util.tree_map(np.asarray, jax.tree_util.tree_unflatten(tree, leaves))


@pytest.mark.parametrize("act", ["softplus", "relu"])
def test_plain_sweep_matches_jax_kernel(act):
    tree = _jax_sdf()
    R, S = 100, 16          # JAX ray tile: 1024 // 16 = 64 rays; 100 is ragged
    o, d, z = _inputs(R, S)
    want = jax_sweep_fn(tree, JSDFConfig(**SDF_KW), interpret=True, dtype="float32",
                        act=act)(jnp.asarray(o), jnp.asarray(d), jnp.asarray(z))
    sw = K.resolve_sweep_weights(state_from_numpy(tree), SDFConfig(**SDF_KW),
                                 dtype="float32", act=act)
    got = K.sdf_rays_plain(sw, *map(torch.from_numpy, (o, d, z)))
    assert got.shape == (R, S)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_plain_sweep_equals_fields_and_bf16_rounds():
    """f32 softplus sweep == fields.sdf_value on the same points; the bf16
    emulation differs from it, by about bf16 rounding (2^-8 relative)."""
    tree = _jax_sdf()
    p = state_from_numpy(tree)
    cfg = SDFConfig(**SDF_KW)
    o, d, z = map(torch.from_numpy, _inputs(37, 9, seed=1))
    pts = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3)
    ref = sdf_value(p, cfg, pts).reshape(37, 9).detach()
    f32 = K.sdf_rays_plain(K.resolve_sweep_weights(p, cfg, "float32"), o, d, z)
    bf16 = K.sdf_rays_plain(K.resolve_sweep_weights(p, cfg, "bfloat16"), o, d, z)
    np.testing.assert_allclose(f32.numpy(), ref.numpy(), atol=1e-5)
    err = float((bf16 - ref).abs().max())
    assert 0.0 < err < 3e-2, err


def test_cpu_dispatch_is_plain_and_uncounted():
    p = init_sdf(SDFConfig(**SDF_KW), torch.Generator().manual_seed(0))
    cfg = SDFConfig(**SDF_KW)
    o, d, z = map(torch.from_numpy, _inputs(20, 8, seed=2))
    before = K.launch_sdf_rays.launches
    fn = K.resolve_sdf_sweep_fn(p, cfg, "auto", dtype="bfloat16", act="softplus")
    got = fn(o, d, z)
    want = K.sdf_rays_plain(K.resolve_sweep_weights(p, cfg, "bfloat16"), o, d, z)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert fn.weights.packed is None and fn.weights.dtype == "bfloat16"
    assert K.launch_sdf_rays.launches == before
    assert K.resolve_sdf_sweep_fn(p, cfg, "off") is None
    with pytest.raises(ValueError):
        K.resolve_sdf_sweep_fn(p, cfg, "interpret")
    with pytest.raises(ValueError):   # weights resolved on the CPU cannot launch
        K.launch_sdf_rays(K.resolve_sweep_weights(p, cfg), o, d, z)


def test_packing_layout_reproduces_the_plain_sweep():
    """Evaluate the network from the kernel's packed buffers (the layout
    csrc/sdf_rays.cu reads: f32 blocks row-major, bf16 blocks in mma B
    fragment order, undone here) in plain PyTorch: equal to sdf_rays_plain."""
    cfg = SDFConfig(multires=6)                 # the kernel's width: 8 x 256
    p = init_sdf(cfg, torch.Generator().manual_seed(3))
    o, d, z = map(torch.from_numpy, _inputs(16, 8, seed=3))
    for dtype in ("float32", "bfloat16"):
        sw = K.resolve_sweep_weights(p, cfg, dtype)
        packed, bias = K.pack_sdf_weights(sw.layers, cfg, dtype)
        rnd = (lambda t: t.to(torch.bfloat16).float()) if dtype == "bfloat16" else (lambda t: t)
        pts = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3)
        emb = torch.zeros((pts.shape[0], K.EMB))
        emb[:, :39] = positional_encoding(pts * cfg.scale, cfg.multires)
        w_all, off, act = packed.float(), 0, rnd(emb)
        for l in range(cfg.n_layers):
            k = K.EMB if l == 0 else (K.HID + K.EMB if l == 4 else K.HID)
            block = w_all[off:off + k * K.HID]
            if dtype == "bfloat16":   # [ks, n-tile, g, t, half, pair] -> [k, n]
                block = block.reshape(k // 16, K.HID // 8, 8, 4, 2, 2).permute(0, 4, 3, 5, 1, 2)
            h = act @ block.reshape(k, K.HID) + bias[l]
            off += k * K.HID
            h = torch.clamp_min(h, 0) + torch.log1p(torch.exp(-100 * h.abs())) * 0.01
            if l + 1 == 4:
                act = torch.cat([rnd(h * K._INV_SQRT2), rnd(emb * K._INV_SQRT2)], 1)
            else:
                act = rnd(h)
        got = ((act @ w_all[off:off + K.HID] + bias[-1, 0]) * K.inv_scale(cfg)).reshape(16, 8)
        np.testing.assert_allclose(got.numpy(), K.sdf_rays_plain(sw, o, d, z).numpy(),
                                   atol=1e-5 if dtype == "float32" else 1e-3)
