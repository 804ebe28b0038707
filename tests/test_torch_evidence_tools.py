"""The port's evidence tools (color_neus_torch/tools/: grad_audit,
quality_gate, dtu_blob_e2e, eval_views, mesh_compare) against the JAX
package's tools of the same names (tools/*.py), on the CPU.

Small widths (SDF 4 x 32 multires 2, colour / relight 2 x 32, 8 rays,
16 + 16 samples in 2 rounds, f32). Tolerances: the audit loss atol 2e-4
(test_parity_torch.py's colour tolerance), its gradients atol 3e-3 x the
leaf's max |g| and rtol 2e-3 (ROADMAP's parity tolerances); metrics on
the same arrays rtol 1e-6; the blob scene's cameras atol 1e-5 and its
images within 1 / 255; per-view PSNR within 1e-3 dB (both tools round to
3 decimals)."""

import importlib.util
import json
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from color_neus_tpu.models import configs as jconfigs
from color_neus_tpu.models import neus as jneus
from color_neus_tpu.ops.rays import near_far_from_sphere as jnear_far
from color_neus_tpu.utils import metrics as jmetrics

from color_neus_torch import pin_precision
from color_neus_torch.data.image_io import read_png
from color_neus_torch.models import configs
from color_neus_torch.ops.mesh import write_ply
from color_neus_torch.runtime import TrainLoop
from color_neus_torch.tools import dtu_blob_e2e as DBE
from color_neus_torch.tools import eval_views as EV
from color_neus_torch.tools import grad_audit as GA
from color_neus_torch.tools import mesh_compare as MC
from color_neus_torch.tools import quality_gate as QG
from color_neus_torch.utils.checkpoint import save_checkpoint
from color_neus_torch.utils.config import config_from_dict
from color_neus_torch.weights import state_from_numpy, state_to_numpy

torch.set_num_threads(2)
pin_precision()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RAYS = 8


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _renderer(mod, **over):
    """The small audit renderer in either package (fused_* off)."""
    kw = dict(kind="color_neus", n_samples=16, n_importance=16, up_sample_steps=2,
              march_bwd_precision="f32stash", fused_sdf="off", fused_core="off",
              fused_march="off",
              sdf=mod.SDFConfig(d_hidden=32, n_layers=4, skip_in=(2,), multires=2),
              color=mod.ColorConfig(mode="no_view_dir", d_in=6, multires_view=0, d_hidden=32,
                                    n_layers=2),
              relight=mod.RelightConfig(d_hidden=32, n_layers=2))
    return mod.RendererConfig(**{**kw, **over})


@pytest.fixture(scope="module")
def audit_setup():
    jcfg, pcfg = _renderer(jconfigs), _renderer(configs)
    jparams = jneus.init_renderer(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, pcfg, jparams, tree


def _jax_audit_grad(jcfg, params, o, d):
    """tools/grad_audit.py:106-118's loss, fused_* off, under highest."""
    def loss_fn(p, o, d):
        near, far = jnear_far(o, d)
        out = jneus.render_rays_train(p, jcfg, o, d, near, far, key=jax.random.PRNGKey(2),
                                      perturb_overwrite=0.0)
        return (jnp.mean(out["color_fine"]) + out["gradient_error"]
                + jnp.mean(out["weight_sum"]) + jnp.mean(out["delta_sum"]) ** 2)
    with jax.default_matmul_precision("highest"):
        return jax.jit(jax.value_and_grad(loss_fn))(params, jnp.asarray(o), jnp.asarray(d))


def _flatten(prefix, tree, out):
    """tools/grad_audit.py's _flatten."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(f"{prefix}/{k}" if prefix else k, v, out)
    else:
        out[prefix] = np.asarray(tree, np.float64)


@pytest.mark.parametrize("seed", GA.BATCH_SEEDS)
def test_audit_loss_and_gradient_match_jax(audit_setup, seed):
    jcfg, pcfg, jparams, tree = audit_setup
    o, d = GA.ray_batch(N_RAYS, seed)
    want_loss, want = _jax_audit_grad(jcfg, jparams, o, d)
    want_flat = {}
    _flatten("", jax.device_get(want), want_flat)
    params = state_from_numpy(tree)
    rays = GA.to_device((o, d), "cpu")
    loss = float(GA.audit_loss(params, pcfg, rays, GA.ORACLE).detach())
    np.testing.assert_allclose(loss, float(want_loss), atol=2e-4, rtol=0)
    got = GA.leaf_grads(params, pcfg, rays, GA.ORACLE)
    assert set(got) == set(want_flat)
    for name, g in got.items():
        scale = float(np.abs(want_flat[name]).max())
        np.testing.assert_allclose(g, want_flat[name], atol=3e-3 * scale, rtol=2e-3,
                                   err_msg=name)


def test_leaf_names_and_groups_match_jax(audit_setup):
    _jcfg, pcfg, jparams, tree = audit_setup
    want = {}
    _flatten("", jax.device_get(jparams), want)
    got = GA.leaf_grads(state_from_numpy(tree), pcfg,
                        GA.to_device(GA.ray_batch(N_RAYS, 1), "cpu"), GA.ORACLE)
    assert sorted(got) == sorted(want)
    assert {n.split("/")[0] for n in got} == {"color", "relight", "sdf", "variance"}
    for name in want:
        assert got[name].shape == want[name].shape, name


@pytest.mark.parametrize("arm", [GA.FUSED_MARCH, GA.FUSED_CORE], ids=["march", "core"])
def test_audit_report_keys_match_r5(audit_setup, arm):
    _jcfg, pcfg, _jparams, tree = audit_setup
    with open(os.path.join(REPO, "reports", "r5", "grad_audit.json")) as f:
        r5 = json.load(f)
    rep = GA.audit(state_from_numpy(tree), pcfg, [GA.ray_batch(N_RAYS, s)
                                                  for s in GA.BATCH_SEEDS], arm)
    assert list(rep) == list(r5)
    assert set(rep["groups"]) == set(r5["groups"])
    for g in rep["groups"].values():
        assert list(g) == list(r5["groups"]["sdf"])
        assert all(np.isfinite(v) for v in g.values())
    assert list(rep["worst_leaf"]) == list(r5["worst_leaf"])
    # on the CPU the fused arm is the kernels' plain twins in f32, within
    # summation order of the oracle (pass_2x_floor is not asserted: at 8
    # rays a leaf's two oracle gradients can point apart, g1.g2 < 0, and
    # JAX's ratio divides by sqrt(max(g1.g2, 0)))
    for g in rep["groups"].values():
        assert g["max_rel_err"] <= 1e-4 and g["min_cos"] >= 1 - 1e-6
    assert rep["platform"] == "cpu" and isinstance(rep["pass_2x_floor"], bool)
    assert rep["samples_per_ray"] == 32 and rep["n_rays"] == N_RAYS
    json.dumps(rep)


def test_statistics_split_bias_from_noise():
    rng = np.random.RandomState(0)
    n = 20000
    g = {"sdf/lin0/v": rng.randn(n), "color/lin0/v": rng.randn(n)}
    bias = {k: 0.05 * rng.randn(n) for k in g}
    # a fixed bias: the same error on both batches
    groups, worst = GA.statistics({k: g[k] + bias[k] for k in g}, g, g,
                                  {k: g[k] + bias[k] for k in g})
    for k, grp in (("sdf/lin0/v", "sdf"), ("color/lin0/v", "color")):
        want = np.linalg.norm(bias[k]) / np.linalg.norm(g[k])
        assert groups[grp]["max_err_batch_cos"] == pytest.approx(1.0, abs=1e-9)
        assert groups[grp]["max_systematic_err_ratio"] == pytest.approx(want, rel=1e-9)
        assert groups[grp]["max_xla_cross_batch_rel"] == 0.0   # one oracle gradient
    assert worst["leaf"] in g
    # independent noise on the two batches: decorrelated, no systematic part
    noise = [{k: 0.05 * rng.randn(n) for k in g} for _ in range(2)]
    groups, _ = GA.statistics({k: g[k] + noise[0][k] for k in g}, g, g,
                              {k: g[k] + noise[1][k] for k in g})
    for grp in groups.values():
        assert abs(grp["max_err_batch_cos"]) < 0.05
        assert grp["max_systematic_err_ratio"] < 0.2 * 0.05
        assert grp["max_rel_err"] == pytest.approx(0.05, rel=0.05)


def test_gate_metrics_match_numpy_and_jax():
    rng = np.random.RandomState(0)
    gt = rng.uniform(0, 1, (24, 20, 3)).astype(np.float32)
    rgb = (gt + 0.05 * rng.randn(*gt.shape)).astype(np.float32)   # beyond [0, 1]: clipped
    psnr, s = QG.image_metrics(rgb, gt)
    rgbc = np.clip(rgb, 0, 1)
    np.testing.assert_allclose(psnr, jmetrics.mse2psnr(float(np.mean((rgbc - gt) ** 2))),
                               rtol=1e-6)
    np.testing.assert_allclose(s, float(jmetrics.ssim(jnp.asarray(rgbc), jnp.asarray(gt))),
                               rtol=1e-6)
    verts = rng.randn(500, 3).astype(np.float32)
    np.testing.assert_allclose(QG.surface_error(verts, "sphere"),
                               np.abs(np.linalg.norm(verts, axis=1) - 0.5), rtol=1e-6)
    from color_neus_tpu.data.synthetic import blob_sdf as jblob_sdf
    np.testing.assert_allclose(QG.surface_error(verts, "blob"), np.abs(jblob_sdf(verts)),
                               rtol=1e-6)


def _jax_thresholds():
    """{scene: ((psnr, err) at >= 1000 steps, (psnr, err) below)}, read from
    the JAX tool's source (quality_gate.py:156-166: blob first, sphere)."""
    with open(os.path.join(REPO, "tools", "quality_gate.py")) as f:
        src = f.read()
    pat = (r"gate_psnr = ([\d.]+) if steps >= 1000 else ([\d.]+)\s+"
           r"gate_err = ([\d.]+) if steps >= 1000 else ([\d.]+)")
    (b, s) = [tuple(map(float, m)) for m in re.findall(pat, src)]
    return {scene: ((v[0], v[2]), (v[1], v[3])) for scene, v in (("blob", b), ("sphere", s))}


@pytest.mark.parametrize("scene", ["sphere", "blob"])
@pytest.mark.parametrize("steps", [999, 1000, 5000])
def test_gate_thresholds_match_jax(scene, steps):
    above, below = _jax_thresholds()[scene]
    assert QG.thresholds(scene, steps) == (above if steps >= 1000 else below)


TINY = {
    "DATASET": {"TYPE": "Synthetic", "N_IMGS": 4, "H": 16, "W": 16},
    "MODEL": {"N_RAYS": 64, "RENDERER": {
        "TYPE": "Color_NeuS", "N_SAMPLES": 16, "N_IMPORTANCE": 8, "UP_SAMPLE_STEPS": 2,
        "PERTURB": 0.0, "EXTRACT_SPARSE": True,
        "SDF": {"D_HIDDEN": 32, "N_LAYERS": 4, "SKIP_IN": [2], "MULTIRES": 2},
        "COLOR": {"MODE": "no_view_dir", "D_IN": 6, "D_HIDDEN": 32, "N_LAYERS": 2,
                  "MULTIRES_VIEW": 0},
        "RELIGHT": {"D_HIDDEN": 32, "N_LAYERS": 2}},
        "LOSS": {"LAMBDA_MASK": 0.1}},
    "TRAIN": {"BATCH_SIZE": 4, "ITERATIONS": 3, "LOG_INTERVAL": 1, "SAVE_INTERVAL": 100,
              "OPTIMIZE": {"WARM_UP": 1}, "GRAD_CLIP": {"NORM": 1.0}},
}


def test_gate_tiny_cpu_run_gives_jax_verdict_keys(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with open(os.path.join(REPO, "reports", "r5", "qg1k_relu.json")) as f:
        want = json.load(f)
    verdict = QG.gate(config_from_dict(TINY), steps=10, res=32, device="cpu")
    assert list(verdict) == list(want)
    assert verdict["steps"] == 10 and verdict["platform"] == "cpu"
    assert verdict["gates"] == {"psnr_min": 30.5, "radial_err_mean_max": 0.033}
    assert verdict["n_verts"] > 0 and np.isfinite(verdict["psnr"])
    assert isinstance(verdict["pass"], bool) and verdict["matmul_precision"] == "highest"
    assert os.path.isdir(tmp_path / "exp")


def test_blob_dtu_writer_matches_jax(tmp_path):
    jdbe = _jax_tool("dtu_blob_e2e")
    _, poses, focal, hw = DBE.write_blob_dtu(str(tmp_path / "port"), 3, 16, 16)
    _, jposes, jfocal, jhw = jdbe.write_blob_dtu(str(tmp_path / "jax"), 3, 16, 16)
    np.testing.assert_allclose(poses, jposes, atol=1e-6)
    np.testing.assert_allclose(focal, jfocal)
    assert hw == jhw
    scene = os.path.join("DTU", "dtu_scan901")
    with np.load(tmp_path / "port" / scene / "cameras_sphere.npz") as a, \
            np.load(tmp_path / "jax" / scene / "cameras_sphere.npz") as b:
        assert sorted(a.files) == sorted(b.files) and len(a.files) == 6
        for k in a.files:
            np.testing.assert_allclose(a[k], b[k], atol=1e-5, err_msg=k)
    for sub in ("image", "mask"):
        for i in range(3):
            got = read_png(str(tmp_path / "port" / scene / sub / f"{i:03d}.png"))
            ref = read_png(str(tmp_path / "jax" / scene / sub / f"{i:03d}.png"))
            assert got.shape == ref.shape
            assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1, (sub, i)


def test_gt_surface_points_match_jax():
    jdbe = _jax_tool("dtu_blob_e2e")
    got, want = DBE.gt_surface_points(48), jdbe.gt_surface_points(48)
    assert got.dtype == want.dtype and len(got) > 1000
    np.testing.assert_array_equal(got, want)


def test_eval_views_matches_jax(tmp_path, monkeypatch, capsys):
    """A 3-step port run's checkpoint through both tools, the JAX one on
    JAX's loop with the port's parameters carried across."""
    from color_neus_tpu.runtime import TrainLoop as JTrainLoop
    from color_neus_tpu.utils.checkpoint import save_pytree
    from color_neus_tpu.utils.config import get_config as jget_config
    monkeypatch.chdir(tmp_path)
    cfg_path = str(tmp_path / "tiny.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(TINY, f)
    loop = TrainLoop(config_from_dict(TINY), device="cpu")
    loop.run(3)
    ckpt = str(tmp_path / "port.npz")
    save_checkpoint(ckpt, loop.state, loop.generator)
    got = EV.main(["--cfg", cfg_path, "--reload", ckpt, "--n", "2", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got

    jloop = JTrainLoop(jget_config(cfg_path), exp_id="carry", require_clean_git=False)
    state = dict(jloop.state)
    state["params"] = jax.tree_util.tree_map(jnp.asarray, state_to_numpy(loop.state.params))
    jckpt = str(tmp_path / "jax.npz")
    save_pytree(jckpt, {"state": state, "prng_key": jloop.key})
    want = _jax_tool("eval_views").main(["--cfg", cfg_path, "--reload", jckpt, "--n", "2"])
    assert list(got) == list(want) and got["n_views"] == want["n_views"] == 2
    for a, b in zip(got["views"], want["views"]):
        assert a["cam"] == b["cam"]
        assert abs(a["psnr"] - b["psnr"]) <= 1e-3 + 1e-9, (a, b)
        assert abs(a["ssim"] - b["ssim"]) <= 1e-4, (a, b)


def test_mesh_compare_prints_jax_line(tmp_path, monkeypatch, capsys):
    rng = np.random.RandomState(3)
    pred, gt = str(tmp_path / "pred.ply"), str(tmp_path / "gt.ply")
    write_ply(pred, rng.randn(700, 3).astype(np.float32), np.zeros((0, 3), np.int32))
    write_ply(gt, 1.1 * rng.randn(900, 3).astype(np.float32), np.array([[0, 1, 2]]))
    for extra in ([], ["--normalize", "--n", "500"]):
        d = MC.main([pred, gt, *extra, "--device", "cpu"])
        line = capsys.readouterr().out.strip()
        monkeypatch.setattr(sys, "argv", ["mesh_compare.py", pred, gt, *extra])
        _jax_tool("mesh_compare").main()
        jline = capsys.readouterr().out.strip()
        assert line == jline
        np.testing.assert_allclose(d, float(jline.split(" = ")[1]), rtol=2e-6)
