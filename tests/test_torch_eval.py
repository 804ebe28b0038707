"""The port's evaluation path on the CPU: the full-image render against the
JAX package, checkpoints, the recorder, the metrics, and the
train -> evaluate command line.

Tolerances: the rendered image atol 2e-4 and depth atol 1e-3 (the render
parity tolerance of test_torch_neus.py: f32 sweeps and MLPs summed in
another order, then compositing); PSNR rtol 1e-6, SSIM and Chamfer
atol 1e-6 (f32 reductions in another order); checkpoints bitwise."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from color_neus_tpu.models import configs as jconfigs
from color_neus_tpu.models import trainer as JTR
from color_neus_tpu.models.camera import CameraConfig as JCameraConfig
from color_neus_tpu.ops.transforms import pose_spherical
from color_neus_tpu.utils import metrics as jmetrics

from color_neus_torch import pin_precision
from color_neus_torch.models import configs
from color_neus_torch.models import trainer as TR
from color_neus_torch.models.camera import CameraConfig
from color_neus_torch.ops.mesh import read_ply
from color_neus_torch.runtime import TrainLoop
from color_neus_torch.utils import metrics, recorder
from color_neus_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from color_neus_torch.utils.config import config_from_dict
from color_neus_torch.weights import state_from_numpy

torch.set_num_threads(1)
pin_precision()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = W = 16
N_CAMS = 3

TINY_CFG = {
    "DATASET": {"TYPE": "Synthetic", "N_IMGS": 4, "H": 16, "W": 16},
    "MODEL": {"N_RAYS": 64, "RENDERER": {
        "TYPE": "Color_NeuS", "N_SAMPLES": 16, "N_IMPORTANCE": 8, "UP_SAMPLE_STEPS": 2,
        "EXTRACT_SPARSE": True,
        "SDF": {"D_HIDDEN": 64, "N_LAYERS": 4, "SKIP_IN": [2], "MULTIRES": 4},
        "COLOR": {"MODE": "no_view_dir", "D_IN": 6, "D_HIDDEN": 64, "N_LAYERS": 2,
                  "MULTIRES_VIEW": 0},
        "RELIGHT": {"D_HIDDEN": 32}},
        "LOSS": {"LAMBDA_MASK": 0.1}},
    "TRAIN": {"BATCH_SIZE": 4, "ITERATIONS": 3, "LOG_INTERVAL": 1,
              "OPTIMIZE": {"WARM_UP": 1}, "GRAD_CLIP": {"NORM": 1.0}},
}


def _renderer(mod, kind):
    color = (mod.ColorConfig(mode="no_view_dir", d_in=6, d_feature=256, d_hidden=32,
                             n_layers=2, multires_view=0) if kind == "color_neus"
             else mod.ColorConfig(mode="idr", d_in=9, d_feature=256, d_hidden=32, n_layers=2,
                                  multires_view=4))
    return mod.RendererConfig(
        kind=kind, n_samples=16, n_importance=8, up_sample_steps=2, perturb=0.0,
        fused_sdf="off" if mod is jconfigs else "auto", sweep_dtype="float32",
        sdf=mod.SDFConfig(d_hidden=64, n_layers=4, skip_in=(2,), multires=4),
        color=color, relight=mod.RelightConfig(d_hidden=32, n_layers=2))


@pytest.mark.parametrize("kind", ["color_neus", "neus"])
def test_render_image_matches_jax(kind):
    kw = dict(eval_ray_size=100, normalize_dir=True)
    cam = dict(H=H, W=W, n_cams=N_CAMS)
    jcfg = JTR.TrainerConfig(**kw, camera=JCameraConfig(**cam),
                             renderer=_renderer(jconfigs, kind))
    pcfg = TR.TrainerConfig(**kw, camera=CameraConfig(**cam), renderer=_renderer(configs, kind))
    poses = np.stack([pose_spherical(120.0 * i, -30.0, 3.0) for i in range(N_CAMS)])
    poses[:, :, 1:3] *= -1
    poses = poses.astype(np.float32)
    focal = np.array([1.2 * W, 1.2 * W], np.float32)
    jstate = JTR.init_state(jax.random.PRNGKey(0), jcfg, init_focal_np=focal)
    jparams = jax.tree_util.tree_map(np.asarray, jstate["params"])
    want_rgb, want_depth = JTR.render_image(jparams, JTR.make_scene(np.zeros(3), 1.0, poses),
                                            jcfg, 1, H, W, jax.random.PRNGKey(1))
    rgb, depth = TR.render_image(state_from_numpy(jparams),
                                 TR.make_scene(np.zeros(3), 1.0, poses, "cpu"), pcfg, 1, H, W,
                                 generator=None)
    assert rgb.shape == (H, W, 3) and depth.shape == (H, W)
    np.testing.assert_allclose(rgb, want_rgb, atol=2e-4, rtol=0)
    np.testing.assert_allclose(depth, want_depth, atol=1e-3, rtol=0)


def test_checkpoint_round_trip(tmp_path):
    loop = TrainLoop(config_from_dict(TINY_CFG), device="cpu")
    loop.run(2)
    path = str(tmp_path / "ck" / "state.npz")
    save_checkpoint(path, loop.state, loop.generator)
    assert not os.path.exists(path + ".tmp")
    other = TrainLoop(config_from_dict({**TINY_CFG, "TRAIN": {**TINY_CFG["TRAIN"],
                                                              "MANUAL_SEED": 7}}),
                      device="cpu")
    load_checkpoint(path, other.state, other.generator)
    assert other.state.step == loop.state.step == 2
    assert torch.equal(other.generator.get_state(), loop.generator.get_state())
    mine = dict(loop.state.params.named_parameters())
    theirs = dict(other.state.params.named_parameters())
    assert mine.keys() == theirs.keys()
    n_optim = 0
    for name, p in mine.items():
        assert torch.equal(p, theirs[name]), name
        st, st2 = loop.state.optimizer.state.get(p, {}), other.state.optimizer.state.get(
            theirs[name], {})
        assert st.keys() == st2.keys(), name
        for k in st:
            assert torch.equal(torch.as_tensor(st[k]), torch.as_tensor(st2[k])), (name, k)
            n_optim += 1
    assert n_optim > 0
    # the two continue identically
    torch.testing.assert_close(loop.run(3), other.run(3), rtol=0, atol=0)

    wide = {**TINY_CFG, "MODEL": {**TINY_CFG["MODEL"], "RENDERER": {
        **TINY_CFG["MODEL"]["RENDERER"], "SDF": {"D_HIDDEN": 32, "N_LAYERS": 4,
                                                 "SKIP_IN": [2], "MULTIRES": 4}}}}
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(path, TrainLoop(config_from_dict(wide), device="cpu").state)


def test_recorder_layout_and_git_rule(tmp_path, monkeypatch):
    monkeypatch.setattr(recorder, "_git_dirty", lambda: True)
    cfg = config_from_dict(TINY_CFG)
    with pytest.raises(RuntimeError, match="dirty"):
        recorder.Recorder("named", cfg, root=str(tmp_path))
    for exp_id in ("default", "eval", "eval_Color_NeuS_83"):
        recorder.Recorder(exp_id, cfg, root=str(tmp_path), timestamp="t")
    rec = recorder.Recorder("named", cfg, root=str(tmp_path), require_clean_git=False,
                            timestamp="t")
    for sub in ("log", "checkpoints", "viz_image", "meshes"):
        assert os.path.isdir(os.path.join(rec.exp_path, sub))
    with open(rec.find_resume_cfg(rec.exp_path)) as f:
        assert yaml.safe_load(f) == cfg.to_dict()
    # record_checkpoint / resume_checkpoint round trip through the exp dir
    loop = TrainLoop(cfg, device="cpu")
    loop.run(1)
    assert rec.record_checkpoint(loop.state, loop.generator) == rec.ckpt_path()
    other = TrainLoop(cfg, device="cpu")
    resumed = recorder.Recorder("named", None, resume_path=rec.exp_path,
                                require_clean_git=False)
    resumed.resume_checkpoint(other.state, other.generator)
    assert other.state.step == 1
    assert torch.equal(other.generator.get_state(), loop.generator.get_state())


def test_metrics_match_jax():
    rng = np.random.RandomState(0)
    a = rng.uniform(0, 1, (24, 20, 3)).astype(np.float32)
    b = np.clip(a + 0.05 * rng.randn(*a.shape), 0, 1).astype(np.float32)
    for mine, ref in ((metrics.PSNR(), jmetrics.PSNR()), (metrics.SSIM(), jmetrics.SSIM()),
                      (metrics.LPIPS(), jmetrics.LPIPS())):
        mine.feed(a, b)
        ref.feed(a, b)
        np.testing.assert_allclose(mine.avg, ref.avg, rtol=1e-6, atol=1e-6)
        assert str(mine).split(":")[0] == str(ref).split(":")[0]
    pa, pb = rng.randn(500, 3).astype(np.float32), rng.randn(300, 3).astype(np.float32)
    np.testing.assert_allclose(metrics.chamfer_distance(pa, pb),
                               jmetrics.chamfer_distance(pa, pb), rtol=1e-5, atol=1e-6)
    lm, jlm = metrics.LossMetric(), jmetrics.LossMetric()
    for d in ({"loss": 1.0, "x": 2.0}, {"loss": 3.0, "x": 0.5}):
        lm.feed(d)
        jlm.feed(d)
    assert str(lm) == str(jlm) and lm.items() == jlm.items()


def test_train_then_evaluate_cli(tmp_path):
    cfg_path = tmp_path / "tiny.yml"
    cfg_path.write_text(yaml.safe_dump(TINY_CFG))
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}

    def run(*args):
        out = subprocess.run([sys.executable, "-m", *args, "--device", "cpu"], cwd=tmp_path,
                             capture_output=True, text=True, timeout=300, env=env)
        assert out.returncode == 0, out.stderr
        return out.stderr

    log = run("color_neus_torch.train", "--cfg", str(cfg_path), "--iterations", "2",
              "--exp_id", "default")
    assert "training done" in log
    (exp,) = [d for d in os.listdir(tmp_path / "exp") if d.startswith("default_")]
    ckpt = tmp_path / "exp" / exp / "checkpoints" / "state.npz"
    assert ckpt.exists()
    log = run("color_neus_torch.evaluate", "--cfg", str(cfg_path), "--reload", str(ckpt),
              "-rr", "32")
    assert "loaded pretrained state (step 2)" in log and "meshes written" in log
    (ev,) = [d for d in os.listdir(tmp_path / "exp") if d.startswith("eval_")]
    mesh_dir = tmp_path / "exp" / ev / "meshes"
    v, t, c = read_ply(str(mesh_dir / "00000002_mesh.ply"))
    v2, t2, c2 = read_ply(str(mesh_dir / "00000002_color.ply"))
    assert len(v) > 0 and c is None and c2.shape == v.shape
    np.testing.assert_array_equal(v, v2)
    np.testing.assert_array_equal(t, t2)
    assert t.min() >= 0 and t.max() < len(v)
