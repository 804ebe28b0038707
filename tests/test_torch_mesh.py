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


def test_grid_sdf_f32x3_twin_matches_jax_split():
    """extract_precision f32x3: the plain twin against JAX's _sdf_layers with
    prec='f32x3' (the kernel body's arithmetic, called eagerly on
    pack_sdf_weights' output: JAX's interpret mode drops prec), full width,
    4096 points off geometric init. One layer on the same f32 input (each
    packed layer, as a one-layer _sdf_layers): atol 1e-6 x its largest
    |output| (the same exact products of the same bf16 hi / lo parts,
    summed in f32 in other orders). The whole net: atol 2e-5. The split's
    own error (the lo part's bf16 rounding, the missing lo.lo, ~2^-16
    relative) depends on the last bits of each layer's f32 input, which
    two summation orders set differently, so two f32x3 chains sit about as
    far apart as each sits from f32 (read 6.0e-6 apart, 1.17e-5 / 1.14e-5
    from f32). That distance from the f32 twin (1.3e-5 at 65,536 points)
    sets chip_smoke.ATOL_GRID['f32x3'] (4e-5) for the kernel against this
    twin, for the same reason."""
    import jax.numpy as jnp
    from chip_smoke import ATOL_GRID
    from color_neus_tpu.ops.embedding import positional_encoding as jpe
    from color_neus_tpu.ops.pallas import sdf_mlp as jsdf
    cfg_j, cfg_p = jconfigs.SDFConfig(), configs.SDFConfig()
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.02 * rng.randn(*a.shape)).astype(np.float32),
        jfields.init_sdf(jax.random.PRNGKey(3), cfg_j))
    pts = rng.uniform(-1.05, 1.05, (4096, 3)).astype(np.float32)
    ws, bs, meta = jsdf.pack_sdf_weights(params, cfg_j)
    emb = jpe(jnp.asarray(pts) * cfg_j.scale, cfg_j.multires)
    emb = jnp.pad(emb, ((0, 0), (0, meta["d0p"] - emb.shape[1])))
    want = np.asarray(jsdf._sdf_layers(meta, meta["n_lin"], ws, bs, emb, prec="f32x3")[:, 0]
                      / cfg_j.scale)
    from color_neus_torch.ops.kernels.sdf_rays import x3_product
    for l, (w, b) in enumerate(zip(ws, bs)):
        x = rng.uniform(-1, 1, (512, w.shape[0])).astype(np.float32)
        one = {"widths": [("dense", w.shape[0], w.shape[0])]}
        ref = np.asarray(jsdf._sdf_layers(one, 1, [w], [b], jnp.asarray(x), prec="f32x3"))
        mine = (x3_product(torch.from_numpy(x), torch.from_numpy(np.asarray(w)))
                + torch.from_numpy(np.asarray(b))).numpy()
        np.testing.assert_allclose(mine, ref, atol=1e-6 * np.abs(ref).max(), rtol=0,
                                   err_msg=f"layer {l}")
    pp = state_from_numpy(params)
    got = sdf_mlp.make_fused_sdf_fn(pp, cfg_p, prec="f32x3")(torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    f32 = sdf_mlp.make_fused_sdf_fn(pp, cfg_p, prec="f32")(torch.from_numpy(pts)).numpy()
    dist = float(np.abs(got - f32).max())
    assert 1e-7 < dist < ATOL_GRID["f32x3"] / 2, dist


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


def test_sparse_mesh_bitwise_dense_f32x3():
    """The res-64 extraction in extract_precision f32x3: sparse == dense
    bitwise, as in f32; the mesh within 1e-4 of the f32 one's vertices."""
    pp = state_from_numpy({"sdf": _sdf_params()})
    r = _renderer(configs, extract_precision="f32x3")
    vd, td = mesh.extract_geometry(pp, r, BMIN, BMAX, 64, sparse=False)
    vs, ts = mesh.extract_geometry(pp, r, BMIN, BMAX, 64, sparse=True)
    assert len(vd) > 100 and len(vs) == len(vd) and len(ts) == len(td)
    np.testing.assert_array_equal(_sorted_rows(vs), _sorted_rows(vd))
    np.testing.assert_array_equal(_tri_keys(vs, ts), _tri_keys(vd, td))
    vf, _ = mesh.extract_geometry(pp, _renderer(configs), BMIN, BMAX, 64, sparse=True)
    assert len(vf) == len(vs)
    d = np.sqrt(((_sorted_rows(vs)[:, None] - vf[None]) ** 2).sum(-1)).min(axis=1)
    assert d.max() < 1e-4


def test_write_glb_matches_jax(tmp_path):
    """write_glb: the BIN chunk bitwise JAX's for the same mesh and colours,
    the JSON chunk JAX's but for the generator's name; read_glb reads the
    counts back; normalize_point_cloud as JAX's."""
    v, t = mc.marching_cubes(_field(12), 0.0)
    rng = np.random.RandomState(1)
    c = rng.uniform(-0.1, 1.1, (len(v), 3)).astype(np.float32)
    for colors in (None, c):
        mesh.write_glb(str(tmp_path / "p.glb"), v, t, colors)
        jmesh.write_glb(str(tmp_path / "j.glb"), v, t, colors)
        (gp, bp), (gj, bj) = (mesh.read_glb(str(tmp_path / f)) for f in ("p.glb", "j.glb"))
        assert bp == bj
        assert gp["asset"].pop("generator") == "color_neus_torch"
        assert gj["asset"].pop("generator") == "color_neus_tpu"
        assert gp == gj
        assert gp["accessors"][0]["count"] == len(v) and gp["accessors"][1]["count"] == 3 * len(t)
        assert len(gp["accessors"]) == (2 if colors is None else 3)
    with pytest.raises(ValueError, match="glTF"):
        (tmp_path / "bad.glb").write_bytes(b"glTF" + b"\0" * 16)
        mesh.read_glb(str(tmp_path / "bad.glb"))
    pts = rng.randn(50, 3).astype(np.float32) * 3 + 1
    np.testing.assert_allclose(mesh.normalize_point_cloud(pts), jmesh.normalize_point_cloud(pts),
                               atol=1e-7, rtol=0)


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
