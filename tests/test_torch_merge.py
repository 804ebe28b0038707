"""The port's counting-rank merge and parameter count against the JAX
package's, on the CPU: models/neus.merge_z_vals against JAX's
merge_z_vals (color_neus_tpu/models/neus.py:136) and against the port's
merge_z_vals_sort, bitwise (JAX's own claim of its pair,
tools/merge_bench.py), with ties between old and new z, with and without
sdf; one hierarchical_z_vals with each merge, bitwise; and
models/fields.param_count against JAX's (fields.py:354) on the same
renderer trees."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from color_neus_tpu.models import configs as jconfigs
from color_neus_tpu.models import fields as jfields
from color_neus_tpu.models import neus as jneus

from color_neus_torch.models import configs, fields, neus
from color_neus_torch.ops.rays import near_far_from_sphere

CASES = [(4, 16, 8, 0), (7, 448, 64, 1), (3, 30, 10, 2)]


def _inputs(R, n, m, seed, ties):
    rng = np.random.RandomState(seed)
    z = np.sort(rng.rand(R, n).astype(np.float32), axis=1)
    zn = np.sort(rng.rand(R, m).astype(np.float32), axis=1)
    if ties:   # every other new z equal to an old one: old before new
        zn[:, ::2] = z[:, :m:2][:, :zn[:, ::2].shape[1]]
        zn = np.sort(zn, axis=1)
    s = rng.randn(R, n).astype(np.float32)
    sn = rng.randn(R, m).astype(np.float32)
    return z, zn, s, sn


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("R,n,m,seed", CASES)
def test_merge_z_vals_matches_jax_and_the_sort(R, n, m, seed, ties):
    z, zn, s, sn = _inputs(R, n, m, seed, ties)
    jz, js = (np.asarray(x) for x in jneus.merge_z_vals(*(jnp.asarray(x) for x in (z, zn, s, sn))))
    tz, ts = neus.merge_z_vals(*(torch.from_numpy(x) for x in (z, zn, s, sn)))
    np.testing.assert_array_equal(tz.numpy(), jz)
    np.testing.assert_array_equal(ts.numpy(), js)
    sz, ss = neus.merge_z_vals_sort(*(torch.from_numpy(x) for x in (z, zn, s, sn)))
    assert torch.equal(tz, sz) and torch.equal(ts, ss)
    nz, none = neus.merge_z_vals(torch.from_numpy(z), torch.from_numpy(zn), None, None)
    assert none is None and torch.equal(nz, sz)


def test_hierarchy_with_either_merge_is_bitwise_equal():
    """hierarchical_z_vals at a small width merges with merge_z_vals as with
    the sort (the default): the same z, bitwise."""
    rcfg = configs.RendererConfig(
        n_samples=16, n_importance=16, up_sample_steps=2,
        sdf=configs.SDFConfig(d_hidden=32, n_layers=4, skip_in=(2,), multires=2))
    g = torch.Generator().manual_seed(0)
    params = neus.init_renderer(rcfg, g)
    d = torch.randn((8, 3), generator=g)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    o = -1.5 * d
    near, far = near_far_from_sphere(o, d)
    got = [neus.hierarchical_z_vals(params, rcfg, o, d, near, far,
                                    generator=torch.Generator().manual_seed(1), merge=merge)
           for merge in (neus.merge_z_vals, neus.merge_z_vals_sort)]
    assert torch.equal(got[0], got[1])


@pytest.mark.parametrize("kind,n_outside", [("color_neus", 0), ("neus", 32)])
def test_param_count_matches_jax(kind, n_outside):
    """The full-width renderer's trees (every leaf of the weight-normed
    nets, the variance, and NeRF++'s net with n_outside)."""
    color = dict(mode="no_view_dir", d_in=6, multires_view=0) if kind == "color_neus" else {}
    rcfg = configs.RendererConfig(kind=kind, n_outside=n_outside,
                                  color=configs.ColorConfig(**color))
    jrcfg = jconfigs.RendererConfig(kind=kind, n_outside=n_outside,
                                    color=jconfigs.ColorConfig(**color))
    port = fields.param_count(neus.init_renderer(rcfg, torch.Generator().manual_seed(0)))
    ref = jfields.param_count(jneus.init_renderer(jax.random.PRNGKey(0), jrcfg))
    assert port == ref > 0
