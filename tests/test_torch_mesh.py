"""Mesh extraction (ops/mesh.py, ops/marching_cubes.py, the grid SDF of
ops/kernels/sdf_mlp.py) against the JAX package, on the CPU.

Tolerances: the grid SDF's plain twin against the JAX kernel in interpret
mode atol 2e-6 (f32, summation order only; |sdf| <= ~1.5); grid values
atol 2e-6 with the active-block masks equal; marching bitwise (the same
algorithm on the same grid); vertex colours atol 1e-5. Within the port,
the sparse and the dense meshes are bitwise equal (sorted vertex sets and
triangle sets), as the JAX package holds its own (test_mesh_sparse.py)."""

import jax
import numpy as np
import pytest
import torch

from color_neus_tpu.models import configs as jconfigs
from color_neus_tpu.models import fields as jfields
from color_neus_tpu.models import neus as jneus
from color_neus_tpu.ops import marching_cubes as jmc
from color_neus_tpu.ops import mesh as jmesh
from color_neus_tpu.ops.pallas.sdf_mlp import make_fused_sdf_fn as jax_fused_sdf_fn

from color_neus_torch import pin_precision
from color_neus_torch.models import configs
from color_neus_torch.ops import marching_cubes as mc
from color_neus_torch.ops import mesh
from color_neus_torch.ops.kernels import sdf_mlp
from color_neus_torch.weights import state_from_numpy

torch.set_num_threads(1)
pin_precision()

BMIN, BMAX = [-0.4] * 3, [0.4] * 3


def _sdf_cfg(mod):
    return mod.SDFConfig(d_hidden=64, n_layers=4, skip_in=(2,), multires=4)


def _sdf_params(seed=0):
    # geometric init: ~|x| - 1/6, an eikonal field the sparse bound covers
    p = jfields.init_sdf(jax.random.PRNGKey(seed), _sdf_cfg(jconfigs))
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), p)


def _renderer(mod, **kw):
    return mod.RendererConfig(sdf=_sdf_cfg(mod), **kw)


@pytest.mark.parametrize("full", [False, True], ids=["small", "full"])
def test_grid_sdf_plain_matches_jax_kernel(full):
    cfg_j = jconfigs.SDFConfig() if full else _sdf_cfg(jconfigs)
    cfg_p = configs.SDFConfig() if full else _sdf_cfg(configs)
    params = jax.tree_util.tree_map(
        np.asarray, jfields.init_sdf(jax.random.PRNGKey(3), cfg_j))
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda a: (a + 0.02 * rng.randn(*a.shape)).astype(np.float32), params)
    pts = (rng.randn(300, 3) * 0.5).astype(np.float32)
    want = np.asarray(jax_fused_sdf_fn(params, cfg_j, tile=256, interpret=True)(pts))
    fn = sdf_mlp.make_fused_sdf_fn(state_from_numpy(params), cfg_p, prec="f32")
    before = sdf_mlp.launch_sdf_points.launches
    got = fn(torch.from_numpy(pts)).numpy()
    assert sdf_mlp.launch_sdf_points.launches == before   # CPU tensors: the plain twin
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
    # a point's value does not depend on the batch it arrives in
    np.testing.assert_array_equal(fn(torch.from_numpy(pts[7:40])).numpy(), got[7:40])
    with pytest.raises(ValueError, match="extract_precision"):
        sdf_mlp.make_fused_sdf_fn(state_from_numpy(params), cfg_p, prec="f16")


def _field(res, seed=0):
    rng = np.random.RandomState(seed)
    ax = np.linspace(-1, 1, res, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    u = 0.55 - np.sqrt(x ** 2 + 1.3 * y ** 2 + z ** 2) + 0.03 * rng.randn(res, res, res)
    return u.astype(np.float32)


def test_marching_matches_jax_bitwise():
    u = _field(20)
    for origin in ((0, 0, 0), (8, 4, 16)):
        v, t = mc.marching_cubes(u, 0.0, origin=origin)
        jv, jt = jmc.marching_cubes(u, 0.0, origin=origin)
        assert len(v) > 100
        np.testing.assert_array_equal(v, jv)
        np.testing.assert_array_equal(t, jt)
        nv, nt = mc.marching_cubes(u, 0.0, backend="numpy", origin=origin)
        jnv, jnt = jmc.marching_cubes(u, 0.0, backend="numpy", origin=origin)
        np.testing.assert_array_equal(nv, jnv)
        np.testing.assert_array_equal(nt, jnt)
    with pytest.raises(ValueError, match="backend"):
        mc.marching_cubes(u, 0.0, backend="gpu")


def test_sparse_grid_matches_jax():
    params = _sdf_params()
    res, f = 64, 4
    want, want_active = jmesh.evaluate_sdf_grid_sparse(
        {"sdf": params}, _renderer(jconfigs), BMIN, BMAX, res, factor=f, return_active=True)
    stats = {}
    got, active = mesh.evaluate_sdf_grid_sparse(
        state_from_numpy({"sdf": params}), _renderer(configs), BMIN, BMAX, res, factor=f,
        return_active=True, stats=stats)
    np.testing.assert_array_equal(active, want_active)
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
    assert 0 < stats["active_fraction"] < 0.6
    assert set(stats) == {"coarse_s", "fine_s", "active_fraction", "heal_rounds"}


def _sorted_rows(v):
    return v[np.lexsort(v.T)]


def _tri_keys(v, t):
    p = np.sort(v[t].reshape(len(t), 9), axis=1)
    return p[np.lexsort(p.T)]


def test_sparse_mesh_bitwise_dense_and_close_to_jax():
    params = _sdf_params()
    pp = state_from_numpy({"sdf": params})
    res = 64
    vd, td = mesh.extract_geometry(pp, _renderer(configs), BMIN, BMAX, res, sparse=False)
    vs, ts = mesh.extract_geometry(pp, _renderer(configs), BMIN, BMAX, res, sparse=True)
    vn, tn = mesh.extract_geometry(pp, _renderer(configs), BMIN, BMAX, res, sparse=False,
                                   overlap=False)
    assert len(vd) > 100 and len(vs) == len(vd) and len(ts) == len(td)
    np.testing.assert_array_equal(_sorted_rows(vs), _sorted_rows(vd))
    np.testing.assert_array_equal(_tri_keys(vs, ts), _tri_keys(vd, td))
    np.testing.assert_array_equal(_sorted_rows(vn), _sorted_rows(vd))
    # against the JAX package: the same mesh up to the f32 rounding of the SDF
    jv, jt = jmesh.extract_geometry({"sdf": params}, _renderer(jconfigs), BMIN, BMAX, res,
                                    sparse=True)
    assert len(jv) == len(vs) and len(jt) == len(ts)
    d = np.sqrt(((_sorted_rows(vs)[:, None] - jv[None]) ** 2).sum(-1)).min(axis=1)
    assert d.max() < 1e-5


@pytest.mark.parametrize("kind,mode", [("color_neus", "no_view_dir"), ("neus", "idr")])
def test_vertex_colors_match_jax(kind, mode):
    def rc(mod):
        color = (mod.ColorConfig(mode="no_view_dir", d_in=6, d_feature=64, d_hidden=32,
                                 n_layers=2, multires_view=0) if mode == "no_view_dir"
                 else mod.ColorConfig(mode="idr", d_in=9, d_feature=64, d_hidden=32,
                                      n_layers=2, multires_view=4))
        return mod.RendererConfig(kind=kind, sdf=mod.SDFConfig(
            d_out=65, d_hidden=64, n_layers=4, skip_in=(2,), multires=4), color=color,
            relight=mod.RelightConfig(d_hidden=32, n_layers=2))
    jr = rc(jconfigs)
    params = jax.tree_util.tree_map(np.asarray, jneus.init_renderer(jax.random.PRNGKey(1), jr))
    verts = (np.random.RandomState(2).randn(300, 3) * 0.3).astype(np.float32)
    want = jmesh.extract_vertex_colors(params, jr, verts, chunk=128)
    got = mesh.extract_vertex_colors(state_from_numpy(params), rc(configs), verts, chunk=128)
    assert got.shape == (300, 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_ply_round_trip(tmp_path):
    rng = np.random.RandomState(0)
    v = rng.randn(50, 3).astype(np.float32)
    t = rng.randint(0, 50, (30, 3))
    c = rng.uniform(0, 1, (50, 3)).astype(np.float32)
    mesh.write_ply(str(tmp_path / "a.ply"), v, t, c)
    mesh.write_ply(str(tmp_path / "b.ply"), v, t)
    rv, rt, rc = mesh.read_ply(str(tmp_path / "a.ply"))
    np.testing.assert_array_equal(rv, v)
    np.testing.assert_array_equal(rt, t)
    np.testing.assert_allclose(rc, np.clip(c * 255, 0, 255).astype(np.uint8) / 255.0)
    assert mesh.read_ply(str(tmp_path / "b.ply"))[2] is None
    # the JAX package reads the port's files
    jv, jt, jc = jmesh.read_ply(str(tmp_path / "a.ply"))
    np.testing.assert_array_equal(jv, v)
    np.testing.assert_array_equal(jc, rc)
