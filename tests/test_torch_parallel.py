"""color_neus_torch.parallel: the data-parallel step on a 2-rank gloo group
on the CPU, against the JAX package's sharded step and the port's own
one-process step.

Two worker processes (tests/_torch_mp_worker.py, which imports torch and
the port only) join a gloo group on 127.0.0.1 through parallel.init and
write their results; the JAX side runs here, on 2 of the 8 virtual CPU
devices tests/conftest.py sets up: render_rays_train(..., mesh=
make_mesh(2)) with the rays under constrain_rays, its march kernel in
interpret mode for fused_march on (as test_torch_trainer.py's
test_train_step_matches_jax, whose tolerances the JAX comparison keeps).
Against the port's one-process step on the same pixels the tolerances
are tight: only the split of each sum over the two ranks differs."""

import glob
import json
import os
import socket
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from color_neus_tpu.models import configs as jconfigs
from color_neus_tpu.models import neus as jneus
from color_neus_tpu.models import trainer as JTR
from color_neus_tpu.models.camera import CameraConfig as JCameraConfig
from color_neus_tpu.models.camera import focal_apply as jfocal_apply
from color_neus_tpu.models.camera import pose_apply as jpose_apply
from color_neus_tpu.ops.rays import near_far_from_sphere as jnear_far
from color_neus_tpu.ops.rays import rays_for_pixels as jrays_for_pixels
from color_neus_tpu.ops.transforms import pose_spherical
from color_neus_tpu.parallel import constrain_rays, make_mesh

from color_neus_torch import parallel, pin_precision
from color_neus_torch.runtime import TrainLoop
from color_neus_torch.utils import logger as logger_mod
from color_neus_torch.utils.config import config_from_dict
from tests import _torch_mp_worker as W

torch.set_num_threads(1)
pin_precision()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_mp_worker.py")
TIMEOUT = 300      # seconds for a group's processes; then they are killed
JAX_CASES = ("auto", "core-on", "march-on", "cams")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(rank, world, port):
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS",)}
    env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
    return env


def _run_group(cmds, cwd):
    """Start one process per rank, wait for all within TIMEOUT (kill all
    when it runs out) and return their outputs; every one must exit 0.
    Their output goes to files: a rank blocked on a full pipe would hold
    the others in a collective."""
    port = _free_port()
    files = [tempfile.TemporaryFile("w+") for _ in cmds]
    procs = [subprocess.Popen(cmd, cwd=cwd, env=_env(r, len(cmds), port), stdout=f,
                              stderr=subprocess.STDOUT, text=True)
             for r, (cmd, f) in enumerate(zip(cmds, files))]
    try:
        for p in procs:
            p.wait(timeout=TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for f in files:
        f.seek(0)
        outs.append(f.read())
        f.close()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out[-6000:]}"
    return outs


def _jax_cfg(case):
    c = W.CASES[case]
    return JTR.TrainerConfig(
        **W.trainer_kwargs(case), camera=JCameraConfig(**W.camera_kwargs(case)),
        renderer=W.renderer_config(
            jconfigs, "off", fused_march="interpret" if c["fused_march"] == "on" else "auto",
            perturb=c["perturb"]))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _write_inputs(case, path):
    """The JAX package's initial parameters of the case (off the pose init
    with learnt cameras: JAX's 3d rotation has a NaN gradient at aa = 0),
    the scene and 32 pixels, seeded."""
    H, W_, n = W.H, W.W, W.N_CAMS
    rng = np.random.RandomState(0)
    poses = np.stack([pose_spherical(360.0 * i / n, -30.0, 3.0) for i in range(n)])
    poses[:, :, 1:3] *= -1
    yy, xx = np.mgrid[0:H, 0:W_]
    blob = (((yy - H / 2) ** 2 + (xx - W_ / 2) ** 2) < (H / 3) ** 2).astype(np.float32)
    masks = np.tile(blob[None], (n, 1, 1))
    images = (rng.uniform(0.2, 0.9, (n, H, W_, 3)) * masks[..., None]).astype(np.float32)
    focal = np.array([1.2 * W_, 1.2 * W_], np.float32)
    jparams = JTR.init_state(jax.random.PRNGKey(0), _jax_cfg(case),
                             init_focal_np=focal)["params"]
    if W.CASES[case]["learn_cams"]:
        noise = np.random.RandomState(2)
        jparams = {**jparams, "pose": {k: v + 0.05 * noise.randn(*v.shape).astype(np.float32)
                                       for k, v in jparams["pose"].items()}}
    pix = np.random.RandomState(1)
    cam_sel = pix.randint(0, n, W.N_RAYS)
    py, px = pix.randint(3, H - 3, W.N_RAYS), pix.randint(3, W_ - 3, W.N_RAYS)
    flat = {f"params/{k.replace('.', '/')}": v for k, v in
            _flat(jax.tree_util.tree_map(np.asarray, jparams)).items()}
    np.savez(path, **flat, poses=poses.astype(np.float32), images=images,
             img_ids=np.arange(n), cam_sel=cam_sel, py=py, px=px,
             sel_mask=masks[cam_sel, py, px])


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The two workers' results: {"ranks": [rank_0.json, rank_1.json],
    "steps": [steps_0.npz, steps_1.npz], "dir": their directory}."""
    d = tmp_path_factory.mktemp("dp")
    for case in W.CASES:
        _write_inputs(case, str(d / f"inputs_{case}.npz"))
    outs = _run_group([[sys.executable, WORKER, str(d)]] * 2, cwd=str(d))
    ranks = []
    for r in range(2):
        with open(d / f"rank_{r}.json") as f:
            ranks.append(json.load(f))
    steps = [dict(np.load(d / f"steps_{r}.npz")) for r in range(2)]
    return {"ranks": ranks, "steps": steps, "dir": d, "outs": outs}


def _case_result(steps, case):
    p = f"{case}/"
    out = {"loss": float(steps[p + "loss"]), "lr": float(steps[p + "lr"]),
           "grads": {}, "params": {}}
    for k, v in steps.items():
        if k.startswith(p + "grads/"):
            out["grads"][k[len(p + "grads/"):]] = v
        elif k.startswith(p + "params/"):
            out["params"][k[len(p + "params/"):]] = v
    return out


def _jax_step(case, inputs):
    """JAX's sharded step on the injected pixels: loss, clipped gradients
    and updated parameters, flat by leaf name."""
    jcfg = _jax_cfg(case)
    mesh = make_mesh(2)
    jparams = jax.tree_util.tree_map(jnp.asarray, inputs["params"])
    cam_sel, py, px = (jnp.asarray(inputs[k]) for k in ("cam_sel", "py", "px"))
    images = jnp.asarray(inputs["images"])
    scene = JTR.make_scene(np.zeros(3), 1.0, inputs["poses"])

    def loss_fn(params):
        f = jfocal_apply(params["focal"], jcfg.camera)
        c2w = jpose_apply(params["pose"], jcfg.camera, scene["init_c2w"],
                          jnp.asarray(inputs["img_ids"]))
        ro, rd = jrays_for_pixels(c2w[cam_sel], f, px, py, W.H, W.W,
                                  normalize=jcfg.normalize_dir, opengl=jcfg.opengl)
        ro, rd = constrain_rays(ro, mesh), constrain_rays(rd, mesh)
        ro = (ro - scene["origin"]) / scene["radius"]
        near, far = jnear_far(ro, rd)
        render = jneus.render_rays_train(params["renderer"], jcfg.renderer, ro, rd, near, far,
                                         mesh=mesh)
        render["rgb_map_gt"] = constrain_rays(images[cam_sel, py, px], mesh)
        render["mask"] = constrain_rays(jnp.asarray(inputs["sel_mask"]), mesh)
        return JTR.compute_loss(jcfg, render)[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jparams)
    tx = JTR.make_optimizer(jcfg)
    opt_state = tuple(s._replace(count=jnp.asarray(W.STEP, jnp.int32))
                      if isinstance(s, optax.ScaleByScheduleState) else s
                      for s in tx.init(jparams))
    updates, _ = tx.update(grads, opt_state, jparams)
    return {"loss": float(loss),
            "grads": _flat(JTR.clip_per_leaf(jcfg.grad_clip_norm).update(grads, None)[0]),
            "params": _flat(jax.tree_util.tree_map(np.asarray,
                                                   optax.apply_updates(jparams, updates)))}


def _assert_step_close(got, want, loss_rtol, grad_atol, grad_rtol, lr):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=loss_rtol, atol=1e-7)
    assert set(got["grads"]) == set(want["grads"])
    for name, g in want["grads"].items():
        scale = float(np.abs(g).max())
        np.testing.assert_allclose(got["grads"][name], g, atol=grad_atol * scale,
                                   rtol=grad_rtol, err_msg=name)
        np.testing.assert_allclose(got["params"][name], want["params"][name], atol=2 * lr,
                                   rtol=1e-6, err_msg=name)


def test_ray_shard_and_with_mesh():
    x = torch.arange(12).reshape(6, 2)
    assert [parallel.ray_shard(x, r, 3).tolist() for r in range(3)] == \
        [x[0:2].tolist(), x[2:4].tolist(), x[4:6].tolist()]
    assert torch.equal(parallel.ray_shard(x, 0, 1), x)
    assert parallel.ray_shard(None, 1, 2) is None
    with pytest.raises(ValueError, match="do not split evenly"):
        parallel.ray_shard(x, 0, 4)
    cfg = W.port_cfg("auto")
    assert cfg.mesh is None
    mesh = parallel.Mesh(1, 4, "gloo")
    assert parallel.with_mesh(cfg, mesh).mesh == mesh and not mesh.capturable
    assert parallel.Mesh(0, 2, "nccl").capturable
    with pytest.raises(ValueError, match="not divisible by 3 ranks"):
        parallel.with_mesh(cfg, parallel.Mesh(0, 3, "gloo"))
    # outside a group: one process of rank 0
    assert (parallel.rank(), parallel.world(), parallel.is_rank0()) == (0, 1, True)
    with pytest.raises(RuntimeError, match="parallel.init"):
        parallel.make_mesh()


def test_train_loop_raises_on_indivisible_rays():
    """A loop on 3 ranks with 64 rays raises before any collective."""
    cfg = config_from_dict(W.loop_cfg(6))
    with pytest.raises(ValueError, match="n_rays=64 not divisible by 3 ranks"):
        TrainLoop(cfg, device="cpu", mesh=parallel.Mesh(0, 3, "gloo"))


def test_init_reads_the_torchrun_environment(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="missing RANK, WORLD_SIZE, MASTER_ADDR"):
        parallel.init(device="cpu")


def test_logger_quiet_on_other_ranks(monkeypatch):
    """Ranks other than 0 log warnings and errors only."""
    seen = []

    class Sink:
        level = 0

        def handle(self, record):
            seen.append(record.levelname)
    log = logger_mod.logger
    monkeypatch.setattr(log, "handlers", [Sink()])
    log.info("rank 0 info")
    monkeypatch.setattr(logger_mod, "is_rank0", lambda: False)
    log.info("dropped")
    log.warning("kept")
    assert seen == ["INFO", "WARNING"]


def test_gather_and_allreduce(group):
    """gather_rays stacks the ranks' rows in rank order and hands each rank
    the gradient of its own rows (torch.distributed.nn's all_gather would
    hand it the sum over the ranks, twice as large here); allreduce_grads
    sums every leaf, a leaf without a gradient on rank 1 as zeros. The
    workers joined over gloo on the CPU and imported no JAX."""
    for r, rec in enumerate(group["ranks"]):
        assert (rec["rank"], rec["world"], rec["backend"], rec["device"]) == \
            (r, 2, "gloo", "cpu")
        assert rec["capturable"] is False and rec["imports_jax"] == []
        c = rec["collectives"]
        assert c["gather_forward"]
        assert c["gather_grad"] == c["gather_grad_want"]
        assert c["allreduce_a"] == [3.0] * 3 and c["allreduce_b"] == [3.0] * 2


@pytest.mark.parametrize("case", JAX_CASES)
def test_sharded_step_matches_jax(group, case):
    """The port's 2-rank step against JAX's mesh=make_mesh(2) step on the
    same pixels and parameters: test_train_step_matches_jax's tolerances
    (loss rtol 1e-4; clipped grads atol 3e-3 * the leaf's max |g|, rtol
    2e-3; parameters within 2 lr_t). Both ranks return the same."""
    inputs = W.load_inputs(str(group["dir"] / f"inputs_{case}.npz"))
    want = _jax_step(case, inputs)
    for steps in group["steps"]:
        got = _case_result(steps, case)
        assert got["lr"] > 0
        _assert_step_close(got, want, 1e-4, 3e-3, 2e-3, got["lr"])


@pytest.mark.parametrize("case", list(W.CASES))
def test_sharded_step_matches_one_process(group, case):
    """The port's 2-rank step against its own one-process step on the same
    pixels (perturb 1 on "perturb": the same generator, each rank keeping
    its rows of the global noise): loss rtol 1e-6, clipped grads atol
    1e-5 * max |g| and rtol 1e-5, parameters within 2 lr_t; the two
    ranks' losses, gradients and parameters bitwise equal."""
    want = W.port_step(case, W.load_inputs(str(group["dir"] / f"inputs_{case}.npz")))
    got0, got1 = (_case_result(s, case) for s in group["steps"])
    _assert_step_close(got0, want, 1e-6, 1e-5, 1e-5, want["lr"])
    assert got0["loss"] == got1["loss"]
    for kind in ("grads", "params"):
        for name, v in got0[kind].items():
            np.testing.assert_array_equal(v, got1[kind][name], err_msg=f"{kind} {name}")


def test_loop_resume_is_bitwise_and_replicas_agree(group):
    """TrainLoop on 2 ranks: 6 steps straight against 3, stop, resume from
    the checkpoint, 3 more: every loss and the final parameters, Adam
    state and generator bitwise equal; the replicas' parameters bitwise
    equal across the ranks after every bundle; the losses equal across
    the ranks."""
    a, b = (rec["loops"] for rec in group["ranks"])
    for lp in (a, b):
        assert len(lp["straight"]) == 6 and lp["resumed_at"] == 3
        assert lp["head"] + lp["tail"] == lp["straight"]
        assert lp["final_params_equal"] and lp["final_optim_equal"] and lp["generator_equal"]
    for key in ("straight", "head", "tail", "sigterm_losses"):
        assert a[key] == b[key], key
    for run in ("straight", "head", "tail", "sigterm"):
        assert a["digests"][run] and a["digests"][run] == b["digests"][run], run
    assert a["digests"]["straight"] == a["digests"]["head"] + a["digests"]["tail"]


def test_loop_only_rank0_writes(group):
    """One experiment directory per run, picked by rank 0 and broadcast;
    only rank 0 holds a recorder; one checkpoint, one validation image and
    each scalar once (rank 0's)."""
    a, b = (rec["loops"] for rec in group["ranks"])
    assert a["exp_paths"] == b["exp_paths"]
    assert a["recorder"] == [True] * 4 and b["recorder"] == [False] * 4
    exp = group["dir"] / "exp"
    assert sorted(p.split("_")[0] for p in os.listdir(exp)) == ["resume", "sigterm",
                                                                "straight"]
    straight = os.path.join(group["dir"], a["exp_paths"]["straight"])
    assert os.listdir(os.path.join(straight, "checkpoints")) == ["state.npz"]
    assert os.listdir(os.path.join(straight, "viz_image")) == ["img_3.png"]
    with open(os.path.join(straight, "tensorboard", "scalars.jsonl")) as f:
        rows = [(r["tag"], r["step"]) for r in map(json.loads, f)]
    assert rows and len(rows) == len(set(rows)) and {s for _, s in rows} == {3, 6}
    with open(os.path.join(straight, "log", "train.log")) as f:
        assert "rays sharded over 2 ranks (gloo)" in f.read()


def test_sigterm_on_one_rank_stops_both(group):
    """SIGTERM to rank 1 alone after its second bundle: both ranks stop at
    step 6 (the stop flag agreed by all_reduce MAX), rank 0 checkpoints
    there."""
    a, b = (rec["loops"] for rec in group["ranks"])
    assert a["sigterm_step"] == b["sigterm_step"] == 6
    assert len(a["sigterm_losses"]) == 6
    ck = os.path.join(group["dir"], a["exp_paths"]["sigterm"], "checkpoints", "state.npz")
    with np.load(ck) as f:
        assert int(f["step"]) == 6


def test_train_cli_distributed_world_one(tmp_path):
    """python -m color_neus_torch.train --distributed --device cpu in the
    environment torchrun sets, one rank over gloo: it trains, checkpoints
    and leaves the group; -g is refused beside --distributed."""
    cfg_path = tmp_path / "tiny.yml"
    cfg_path.write_text(yaml.safe_dump(W.loop_cfg(3)))
    cmd = [sys.executable, "-m", "color_neus_torch.train", "--cfg", str(cfg_path),
           "--device", "cpu"]
    (out,) = _run_group([cmd + ["--distributed"]], cwd=str(tmp_path))
    assert "rays sharded over 1 ranks (gloo)" in out and "step 3 | loss" in out
    (exp,) = glob.glob(str(tmp_path / "exp" / "default_*"))
    with np.load(os.path.join(exp, "checkpoints", "state.npz")) as f:
        assert int(f["step"]) == 3
    bad = subprocess.run(cmd + ["--distributed", "-g", "0"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120, env=_env(0, 1, _free_port()))
    assert bad.returncode != 0 and "-g picks the card" in bad.stderr
