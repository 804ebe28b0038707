"""color_neus_torch.models.trainer and runtime against the JAX package.

One train step from injected pixels at a step > 0 (the warm-up lr is 0
at step 0), small widths, perturb 0, identical weights, with the port's
fused_core auto and on and fused_march on, and with learnt cameras
(LEARN_FOCAL / LEARN_R / LEARN_T, POSE_MODE 3d) on the plain core and
through the fused march's ray gradients: the loss, every
leaf's clipped gradient (atol 3e-3 * the leaf's max |g|, rtol 2e-3, the
gradient tolerance of test_parity_torch.py), the Adam moments (the same
tolerance on mu / 0.1 and sqrt(nu / 0.01), which equal the gradient
after one step), and the updated parameters within 2 * lr_t, the most
one Adam step can move an element. The JAX side is composed from its
public functions."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from color_neus_tpu.models import configs as jconfigs
from color_neus_tpu.models import neus as jneus
from color_neus_tpu.models import trainer as JTR
from color_neus_tpu.models.camera import CameraConfig as JCameraConfig
from color_neus_tpu.models.camera import focal_apply as jfocal_apply
from color_neus_tpu.models.camera import pose_apply as jpose_apply
from color_neus_tpu.ops.rays import near_far_from_sphere as jnear_far
from color_neus_tpu.ops.rays import rays_for_pixels as jrays_for_pixels
from color_neus_tpu.ops.transforms import pose_spherical

from color_neus_torch import pin_precision, resolve_device
from color_neus_torch.models import configs
from color_neus_torch.models import trainer as TR
from color_neus_torch.models.camera import CameraConfig
from color_neus_torch.runtime import TrainLoop
from color_neus_torch.utils.config import config_from_dict
from color_neus_torch.weights import state_from_numpy

torch.set_num_threads(1)
pin_precision()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = W = 16
N_CAMS = 4
STEP = 5          # warm-up 10: lr_t = lr * 5 / 10


def _renderer(mod, fused_sdf, **kw):
    return mod.RendererConfig(
        kind="color_neus", n_samples=16, n_importance=8, up_sample_steps=2, perturb=0.0,
        fused_sdf=fused_sdf, sweep_dtype="float32", **kw,
        sdf=mod.SDFConfig(d_hidden=64, n_layers=4, skip_in=(2,), multires=4),
        color=mod.ColorConfig(mode="no_view_dir", d_in=6, d_feature=256, d_hidden=64,
                              n_layers=2, multires_view=0),
        relight=mod.RelightConfig(d_hidden=32, n_layers=4, y_in_layer=3))


def _cfgs(fused_core="auto", fused_march="auto", learn_cams=False):
    kw = dict(n_rays=32, include_mask=True, mask_rate=(0.5, 0.8), iterations=100,
              warm_up=10, lr=5e-4)
    cam = dict(H=H, W=W, n_cams=N_CAMS, pose_mode="3d" if learn_cams else "6d",
               focal_order=2, learn_focal=learn_cams, learn_r=learn_cams,
               learn_t=learn_cams)
    # the JAX side runs its march kernel in interpret mode against the
    # port's march
    jcfg = JTR.TrainerConfig(**kw, camera=JCameraConfig(**cam), renderer=_renderer(
        jconfigs, "off", fused_march="interpret" if fused_march == "on" else "auto"))
    pcfg = TR.TrainerConfig(**kw, camera=CameraConfig(**cam), renderer=_renderer(
        configs, "auto", fused_core=fused_core, fused_march=fused_march))
    return jcfg, pcfg


def _scene():
    rng = np.random.RandomState(0)
    poses = np.stack([pose_spherical(360.0 * i / N_CAMS, -30.0, 3.0) for i in range(N_CAMS)])
    poses[:, :, 1:3] *= -1
    yy, xx = np.mgrid[0:H, 0:W]
    blob = (((yy - H / 2) ** 2 + (xx - W / 2) ** 2) < (H / 3) ** 2).astype(np.float32)
    masks = np.tile(blob[None], (N_CAMS, 1, 1))
    images = (rng.uniform(0.2, 0.9, (N_CAMS, H, W, 3)) * masks[..., None]).astype(np.float32)
    focal = np.array([1.2 * W, 1.2 * W], np.float32)
    return poses.astype(np.float32), images, masks, focal


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("fused_core,fused_march,learn_cams", [
    pytest.param("auto", "auto", False, id="auto"), pytest.param("on", "auto", False, id="on"),
    pytest.param("auto", "on", False, id="march-on"),
    pytest.param("auto", "auto", True, id="auto-cams-3d"),
    pytest.param("auto", "on", True, id="march-on-cams-3d")])
def test_train_step_matches_jax(fused_core, fused_march, learn_cams):
    """The port's step with the plain autograd core (auto), with the
    point pipeline's autograd Function (fused_core on) and with the fused
    march's (fused_march on; plain twins on the CPU) against the same JAX
    step: the plain core (JAX's fused_core and fused_march resolve to it on
    the CPU), or JAX's march kernel in interpret mode for fused_march on.
    With learnt cameras the focal and pose leaves get their gradient
    through the rays (the march's rays_o / rays_d gradients with
    fused_march on) and are held like every other leaf."""
    jcfg, pcfg = _cfgs(fused_core, fused_march, learn_cams)
    poses, images, masks, focal = _scene()
    jstate = JTR.init_state(jax.random.PRNGKey(0), jcfg, init_focal_np=focal)
    jparams = jstate["params"]
    if learn_cams:
        # off the pose init: JAX's 3d rotation has a NaN gradient at aa = 0
        # (test_pose_3d_gradient_at_init)
        noise = np.random.RandomState(2)
        jparams = {**jparams, "pose": {k: v + 0.05 * noise.randn(*v.shape).astype(np.float32)
                                       for k, v in jparams["pose"].items()}}
    jscene = JTR.make_scene(np.zeros(3), 1.0, poses)
    rng = np.random.RandomState(1)
    cam_sel = rng.randint(0, N_CAMS, 32)
    py, px = rng.randint(3, H - 3, 32), rng.randint(3, W - 3, 32)
    sel_mask = masks[cam_sel, py, px]
    img_ids = np.arange(N_CAMS)

    def loss_fn(params):
        f = jfocal_apply(params["focal"], jcfg.camera)
        c2w = jpose_apply(params["pose"], jcfg.camera, jscene["init_c2w"], jnp.asarray(img_ids))
        ro, rd = jrays_for_pixels(c2w[cam_sel], f, jnp.asarray(px), jnp.asarray(py), H, W,
                                  normalize=jcfg.normalize_dir, opengl=jcfg.opengl)
        ro = (ro - jscene["origin"]) / jscene["radius"]
        near, far = jnear_far(ro, rd)
        render = jneus.render_rays_train(params["renderer"], jcfg.renderer, ro, rd, near, far)
        render["rgb_map_gt"] = jnp.asarray(images)[cam_sel, py, px]
        render["mask"] = jnp.asarray(sel_mask)
        return JTR.compute_loss(jcfg, render)[0]

    loss_j, grads = jax.jit(jax.value_and_grad(loss_fn))(jparams)
    tx = JTR.make_optimizer(jcfg)
    opt_state = tuple(s._replace(count=jnp.asarray(STEP, jnp.int32))
                      if isinstance(s, optax.ScaleByScheduleState) else s
                      for s in tx.init(jparams))
    updates, new_opt = tx.update(grads, opt_state, jparams)
    new_j = _flat(jax.tree_util.tree_map(np.asarray, optax.apply_updates(jparams, updates)))
    clipped_j = _flat(JTR.clip_per_leaf(jcfg.grad_clip_norm).update(grads, None)[0])
    adam = next(s for s in new_opt if isinstance(s, optax.ScaleByAdamState))
    mu_j, nu_j = _flat(adam.mu), _flat(adam.nu)

    params = state_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    state = TR.TrainState(params, TR.make_optimizer(pcfg, params), step=STEP)
    scene = TR.make_scene(np.zeros(3), 1.0, poses, "cpu")
    aux = TR.train_step_pixels(state, scene, pcfg, torch.from_numpy(images),
                               torch.from_numpy(img_ids), torch.from_numpy(cam_sel),
                               torch.from_numpy(py), torch.from_numpy(px),
                               torch.from_numpy(sel_mask), generator=None)
    assert state.step == STEP + 1
    lr_t = float(JTR.neus_lr_schedule(jcfg)(STEP))
    np.testing.assert_allclose(aux["lr"], lr_t, rtol=1e-6)
    assert lr_t > 0
    np.testing.assert_allclose(float(aux["loss"]), float(loss_j), rtol=1e-4, atol=1e-6)

    names = dict(params.named_parameters())
    assert set(names) == set(clipped_j)
    for name, p in names.items():
        g_j = clipped_j[name]
        g_t = p.grad.numpy() if p.grad is not None else np.zeros_like(g_j)
        scale = float(np.abs(g_j).max())
        tol = dict(atol=3e-3 * scale, rtol=2e-3, err_msg=name)
        np.testing.assert_allclose(g_t, g_j, **tol)
        st = state.optimizer.state.get(p, {})
        mu_t = st["exp_avg"].numpy() if st else np.zeros_like(g_j)
        nu_t = st["exp_avg_sq"].numpy() if st else np.zeros_like(g_j)
        np.testing.assert_allclose(mu_t / 0.1, mu_j[name] / 0.1, **tol)
        np.testing.assert_allclose(np.sqrt(nu_t / 0.01), np.sqrt(nu_j[name] / 0.01), **tol)
        np.testing.assert_allclose(p.detach().numpy(), new_j[name], atol=2 * lr_t, rtol=1e-6,
                                   err_msg=name)
    cams = ("focal.fx", "focal.fy", "pose.r", "pose.t")
    if learn_cams:    # learnt camera leaves: a gradient, held above
        assert all(float(np.abs(clipped_j[n]).max()) > 0 for n in cams)
    else:             # frozen camera leaves: no gradient, no move
        for name in cams:
            assert names[name].grad is None
            np.testing.assert_array_equal(names[name].detach().numpy(), new_j[name])


def test_pose_3d_gradient_at_init():
    """At a 3d pose leaf's init (aa = 0) the JAX package's rotation gives a
    NaN gradient (0/0 in the untaken branch of its where); the port's is
    finite and equals JAX's at aa ~1e-5 to atol 1e-4, the continuous limit."""
    from color_neus_tpu.ops import transforms as jtr
    from color_neus_torch.ops import transforms
    w = np.random.RandomState(3).randn(4, 3, 3).astype(np.float32)

    def jloss(aa):
        return jnp.sum(jtr.aa_to_rotmat(aa) * w)
    assert np.isnan(np.asarray(jax.grad(jloss)(jnp.zeros((4, 3))))).all()
    aa = torch.zeros(4, 3, requires_grad=True)
    torch.sum(transforms.aa_to_rotmat(aa) * torch.from_numpy(w)).backward()
    near = 1e-5 * np.random.RandomState(4).randn(4, 3).astype(np.float32)
    want = np.asarray(jax.grad(jloss)(jnp.asarray(near)))
    assert np.isfinite(want).all()
    np.testing.assert_allclose(aa.grad.numpy(), want, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(transforms.aa_to_rotmat(torch.zeros(2, 3)).numpy(),
                                  np.tile(np.eye(3, dtype=np.float32), (2, 1, 1)))


def test_schedules_and_loss_match_jax():
    jcfg, pcfg = _cfgs()
    for s in (0, 3, 10, 55, 100, 140):
        np.testing.assert_allclose(TR.neus_lr_schedule(pcfg)(s),
                                   float(JTR.neus_lr_schedule(jcfg)(s)), rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(TR.nerf_lr_schedule(pcfg)(s * 1000),
                                   float(JTR.nerf_lr_schedule(jcfg)(s * 1000)), rtol=1e-6)
    assert TR.neus_lr_schedule(pcfg)(0) == 0.0
    rng = np.random.RandomState(2)
    R, S = 8, 4
    render = {
        "rgb_map_gt": rng.uniform(0, 1, (R, 3)), "color_fine": rng.uniform(0, 1, (R, 3)),
        "gradient_error": np.float32(0.2), "weight_sum": rng.uniform(0, 1, (R, 1)),
        "mask": (rng.uniform(0, 1, R) > 0.5), "delta_relight": rng.randn(R, S, 3) * 0.1,
    }
    render = {k: np.asarray(v, np.float32) for k, v in render.items()}
    for form in ("delta_relight", "delta_sum"):
        r = dict(render)
        if form == "delta_sum":
            r["delta_sum"] = r.pop("delta_relight").sum(axis=(1, 2))
            r["n_samples_total"] = S
        lj, dj = JTR.compute_loss(jcfg, {k: jnp.asarray(v) for k, v in r.items()})
        lt, dt = TR.compute_loss(pcfg, {k: torch.as_tensor(v) for k, v in r.items()})
        for k in dj:
            np.testing.assert_allclose(float(dt[k]), float(dj[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(TR._mask_rate_at(pcfg, 37)),
                               float(JTR._mask_rate_at(jcfg, jnp.asarray(37))), rtol=0)


def test_sgd_steps_match_jax():
    """OPTIMIZE.TYPE sgd: three steps of the port's update (apply_gradients:
    the per-leaf clip, the schedule's lr at the device step, DeviceSGD)
    against JAX's make_optimizer('sgd') chain on the same weights and the
    same seeded gradients, from step 9 across the warm-up's end (lr 4.5e-4,
    5e-4, then the cosine): every leaf within atol 1e-6 (f32, the same
    arithmetic: p - g * lr)."""
    import dataclasses
    jcfg, pcfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, optimizer="sgd", grad_clip_norm=0.5)
    pcfg = dataclasses.replace(pcfg, optimizer="sgd", grad_clip_norm=0.5)
    jparams = JTR.init_state(jax.random.PRNGKey(0), jcfg)["params"]
    params = state_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    state = TR.TrainState(params, TR.make_optimizer(pcfg, params), step=9)
    assert isinstance(state.optimizer, TR.DeviceSGD) and pcfg.grad_clip_enabled
    tx = JTR.make_optimizer(jcfg)
    opt_state = tuple(s._replace(count=jnp.asarray(9, jnp.int32))
                      if isinstance(s, optax.ScaleByScheduleState) else s
                      for s in tx.init(jparams))
    rng = np.random.RandomState(5)
    names = [n for n, _ in params.named_parameters()]
    for _ in range(3):
        grads = {n: np.asarray(rng.randn(*p.shape) * rng.choice([0.01, 1.0]), np.float32)
                 for n, p in params.named_parameters()}
        jgrads = jax.tree_util.tree_map(np.zeros_like, jparams)
        for n in names:
            node = jgrads
            *path, leaf = n.split(".")
            for k in path:
                node = node[k]
            node[leaf] = grads[n]
        updates, opt_state = tx.update(jgrads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for n, p in params.named_parameters():
            p.grad = torch.tensor(grads[n])
        TR.apply_gradients(state, pcfg)
        want = _flat(jax.tree_util.tree_map(np.asarray, jparams))
        for n, p in params.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[n], atol=1e-6, rtol=0,
                                       err_msg=n)
    assert state.step == 12 and int(state.step_t) == 12


def test_per_leaf_clip():
    from torch import nn
    m = nn.ParameterDict({"a": nn.Parameter(torch.zeros(4)), "b": nn.Parameter(torch.zeros(2))})
    m["a"].grad = torch.full((4,), 10.0)
    m["b"].grad = torch.tensor([0.1, 0.1])
    TR.clip_per_leaf(m, 1.0)
    np.testing.assert_allclose(float(torch.linalg.norm(m["a"].grad)), 1.0, rtol=1e-6)
    np.testing.assert_allclose(m["b"].grad.numpy(), [0.1, 0.1], rtol=1e-6)


TINY_CFG = {
    "DATASET": {"TYPE": "Synthetic", "N_IMGS": 4, "H": 16, "W": 16},
    "MODEL": {"N_RAYS": 64, "RENDERER": {
        "TYPE": "Color_NeuS", "N_SAMPLES": 16, "N_IMPORTANCE": 8, "UP_SAMPLE_STEPS": 2,
        "SDF": {"D_HIDDEN": 64, "N_LAYERS": 4, "SKIP_IN": [2], "MULTIRES": 4},
        "COLOR": {"MODE": "no_view_dir", "D_IN": 6, "D_HIDDEN": 64, "N_LAYERS": 2,
                  "MULTIRES_VIEW": 0},
        "RELIGHT": {"D_HIDDEN": 32}},
        "LOSS": {"LAMBDA_MASK": 0.1}},
    "TRAIN": {"BATCH_SIZE": 4, "ITERATIONS": 3, "LOG_INTERVAL": 1,
              "OPTIMIZE": {"WARM_UP": 1}, "GRAD_CLIP": {"NORM": 1.0}},
}


def test_train_loop_cpu():
    loop = TrainLoop(config_from_dict(TINY_CFG), device="cpu")
    before = {n: p.detach().clone() for n, p in loop.state.params.named_parameters()}
    losses = loop.run()
    assert losses.shape == (3,) and bool(torch.isfinite(losses).all())
    assert loop.state.step == 3
    after = dict(loop.state.params.named_parameters())
    assert not torch.equal(before["renderer.sdf.lin0.v"], after["renderer.sdf.lin0.v"])
    for n in ("focal.fx", "pose.r", "pose.t"):
        assert torch.equal(before[n], after[n])


def test_entry_points_need_cuda_or_cpu(tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
    import yaml
    cfg_path = tmp_path / "tiny.yml"
    cfg_path.write_text(yaml.safe_dump(TINY_CFG))
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-m", "color_neus_torch.train", "--cfg", str(cfg_path),
                          "--iterations", "2", "--device", "cpu"],
                         cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    assert "step 2 | loss" in out.stderr and "training done" in out.stderr


@pytest.mark.parametrize("pose_mode,focal_order,fx_only", [
    ("6d", 2, False), ("3d", 1, False), ("3d", 2, True)])
def test_camera_matches_jax(pose_mode, focal_order, fx_only):
    """focal_apply / pose_apply values and gradients (learnable) vs JAX;
    atol 1e-5 (f32, 4x4 products summed in another order)."""
    from color_neus_tpu.models import camera as jcam
    from color_neus_torch.models import camera
    kw = dict(learn_focal=True, learn_r=True, learn_t=True, fx_only=fx_only,
              focal_order=focal_order, pose_mode=pose_mode, H=24, W=32, n_cams=3)
    jc, pc = jcam.CameraConfig(**kw), camera.CameraConfig(**kw)
    init_f = np.array([40.0, 36.0], np.float32)
    poses, *_ = _scene()
    rng = np.random.RandomState(5)
    jf = jcam.init_focal(jc, init_f)
    jp = jcam.init_pose(jc)
    jp = {k: v + 0.1 * rng.randn(*v.shape).astype(np.float32) for k, v in jp.items()}
    ids = np.array([2, 0])

    def f_j(f, p):
        c2w = jcam.pose_apply(p, jc, jnp.asarray(poses[:3]), jnp.asarray(ids))
        return jnp.sum(jcam.focal_apply(f, jc)) * 1e-2 + jnp.sum(c2w * c2w), c2w

    (val_j, c2w_j), (gf_j, gp_j) = jax.value_and_grad(f_j, argnums=(0, 1), has_aux=True)(jf, jp)
    pf = camera.init_focal(pc, init_f)
    pp = state_from_numpy({k: np.asarray(v) for k, v in jp.items()})
    np.testing.assert_allclose(camera.focal_apply(pf, pc).detach().numpy(),
                               np.asarray(jcam.focal_apply(jf, jc)), rtol=1e-6)
    c2w = camera.pose_apply(pp, pc, torch.from_numpy(poses[:3]), torch.from_numpy(ids))
    val = torch.sum(camera.focal_apply(pf, pc)) * 1e-2 + torch.sum(c2w * c2w)
    val.backward()
    np.testing.assert_allclose(c2w.detach().numpy(), np.asarray(c2w_j), atol=1e-5)
    np.testing.assert_allclose(float(val.detach()), float(val_j), rtol=1e-5)
    for k in jf:
        np.testing.assert_allclose(pf[k].grad.numpy(), np.asarray(gf_j[k]), atol=1e-5)
    for k in ("r", "t"):
        np.testing.assert_allclose(pp[k].grad.numpy(), np.asarray(gp_j[k]), atol=1e-4)
