"""The port's train runtime on the CPU: resume, stop, SIGTERM, the
scalars, the snapshots, the camera plots and `train --resume`, with the
JAX package's runtime as the reference where the two write the same
thing (tests/test_runtime.py is the JAX side's counterpart).

A stopped-and-resumed run must end bitwise equal to a straight one: the
checkpoint holds the parameters, Adam's state, the step and the
generator's state, and the schedules are functions of the step."""

import faulthandler
import glob
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
import yaml

from color_neus_tpu.runtime import TrainLoop as JaxTrainLoop
from color_neus_tpu.utils import misc as jmisc
from color_neus_tpu.utils import viztools as jviztools
from color_neus_tpu.utils.config import Config as JaxConfig

from color_neus_torch import pin_precision
from color_neus_torch.runtime import TrainLoop
from color_neus_torch.utils import misc, recorder, viztools
from color_neus_torch.utils.config import config_from_dict, get_config
from color_neus_torch.utils.recorder import Recorder

torch.set_num_threads(1)
pin_precision()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_cfg(iterations=6, **train):
    """tests/test_runtime.py's tiny_cfg: LOG_INTERVAL 2 and SAVE_INTERVAL 3
    do not line up, so the JAX loop runs one step per dispatch too."""
    return {
        "DATASET": {"TYPE": "Synthetic", "N_IMGS": 4, "H": 12, "W": 12},
        "DATA_PRESET": {"INCLUDE_MASK": True},
        "MODEL": {
            "TYPE": "NeuS_Trainer", "PRETRAINED": None,
            "N_RAYS": 64, "EVAL_RAY_SIZE": 72,
            "NORMALIZE_DIR": True, "FOCAL_ORDER": 2,
            "LEARN_FOCAL": False, "LEARN_R": False, "LEARN_T": False,
            "MASK_RATE": [0.5, 0.8], "POSE_MODE": "6d",
            "RENDERER": {
                "TYPE": "Color_NeuS", "N_SAMPLES": 8, "N_IMPORTANCE": 4,
                "UP_SAMPLE_STEPS": 2, "PERTURB": 1.0, "FUSED_SDF": "off",
                "SDF": {"D_HIDDEN": 32, "N_LAYERS": 2, "SKIP_IN": [],
                        "MULTIRES": 2, "D_OUT": 257},
                "COLOR": {"MODE": "no_view_dir", "D_IN": 6, "D_HIDDEN": 32,
                          "N_LAYERS": 1, "MULTIRES_VIEW": 0, "D_FEATURE": 256},
                "RELIGHT": {"D_HIDDEN": 16, "N_LAYERS": 4, "Y_IN_LAYER": 3},
                "DEVIATION": {"INIT_VAL": 0.3},
            },
            "LOSS": {"RGB_LOSS_TYPE": "mse", "LAMBDA_FINE": 1.0,
                     "LAMBDA_EIKONAL": 0.1, "LAMBDA_MASK": 0.1,
                     "LAMBDA_RELIGHT": 1.0},
        },
        "TRAIN": {
            "BATCH_SIZE": 2, "ITERATIONS": iterations,
            "OPTIMIZE": {"TYPE": "adam", "LR": 5e-4, "SCHEDULER_TYPE": "NEUS",
                         "WARM_UP": 2, "LR_ALPHA": 0.05},
            "LOG_INTERVAL": 2, "SAVE_INTERVAL": 3,
            "VIZ_IMAGE_INTERVAL": 1000, "VIZ_MESH_INTERVAL": 1000,
            "MANUAL_SEED": 1, "CONV_REPEATABLE": True,
            "GRAD_CLIP_ENABLED": True, "GRAD_CLIP": {"TYPE": 2, "NORM": 1.0},
            **train,
        },
    }


def _loop(exp_id="t", iterations=6, resume=None, **train):
    return TrainLoop(config_from_dict(tiny_cfg(iterations, **train)), device="cpu",
                     exp_id=exp_id, resume=resume)


def _assert_states_equal(a, b):
    pa, pb = dict(a.state.params.named_parameters()), dict(b.state.params.named_parameters())
    assert pa.keys() == pb.keys()
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
        sa, sb = a.state.optimizer.state.get(pa[k], {}), b.state.optimizer.state.get(pb[k], {})
        assert sa.keys() == sb.keys(), k
        for s in sa:
            assert torch.equal(torch.as_tensor(sa[s]), torch.as_tensor(sb[s])), (k, s)
    assert a.state.step == b.state.step
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def _scalars(loop):
    with open(os.path.join(loop.recorder.exp_path, "tensorboard", "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_resume_continues(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    loop1 = _loop(iterations=4)
    loop1.run()
    loop2 = _loop(iterations=8, resume=loop1.recorder.exp_path)
    assert loop2.state.step == 4 and loop2.recorder.exp_path == loop1.recorder.exp_path
    losses = loop2.run()
    assert loop2.state.step == 8 and losses.shape == (4,)
    # the resumed run's scalars continue the same file
    steps = sorted({s["step"] for s in _scalars(loop2)})
    assert steps == [2, 4, 6, 8]


def test_resume_is_bitwise_deterministic(tmp_path, monkeypatch):
    """Stop at step 3, resume from the directory with its dump_cfg.yaml:
    every parameter, Adam moment, the step and the generator at step 6
    equal the straight run's bitwise, and so do the losses of steps 4-6."""
    monkeypatch.chdir(tmp_path)
    straight = _loop("straight")
    losses = straight.run()
    stopped = _loop("stopped")
    assert stopped.run(stop_after=3).shape == (3,)
    assert stopped.state.step == 3
    exp = stopped.recorder.exp_path
    cfg = get_config(Recorder.find_resume_cfg(exp))
    assert cfg.to_dict() == config_from_dict(tiny_cfg()).to_dict()
    resumed = TrainLoop(cfg, device="cpu", resume=exp)
    assert resumed.state.step == 3
    rest = resumed.run()
    _assert_states_equal(straight, resumed)
    assert torch.equal(rest, losses[3:])


def test_sigterm_checkpoints_and_stops(tmp_path, monkeypatch):
    """SIGTERM during run: a checkpoint at the next step boundary and a
    clean return; a loop resumed from the directory starts at that step.
    The handlers in place before run are back after it. The test holds
    itself to 120 s (faulthandler ends a hung process)."""
    # signal handlers are set in the main thread only; elsewhere the
    # SIGTERM would end the process
    assert threading.current_thread() is threading.main_thread()
    monkeypatch.chdir(tmp_path)
    faulthandler.dump_traceback_later(120, exit=True)
    try:
        loop = _loop(iterations=100000)
        before = signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)
        timer = threading.Timer(2.0, lambda: os.kill(os.getpid(), signal.SIGTERM))
        t0 = time.perf_counter()
        timer.start()
        losses = loop.run()
        timer.join(10)
        assert not timer.is_alive() and time.perf_counter() - t0 < 60
        assert (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)) == before
        step = loop.state.step
        assert 0 < step < 100000 and losses.shape == (step,)
        resumed = _loop(iterations=100000, resume=loop.recorder.exp_path)
        assert resumed.state.step == step
        _assert_states_equal(loop, resumed)
    finally:
        faulthandler.cancel_dump_traceback_later()


def test_run_restores_handlers_when_a_step_raises(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    loop = _loop()
    before = signal.getsignal(signal.SIGINT)

    def boom():
        raise RuntimeError("step failed")
    monkeypatch.setattr(loop, "training_step", boom)
    with pytest.raises(RuntimeError, match="step failed"):
        loop.run()
    assert signal.getsignal(signal.SIGINT) is before


def test_scalar_tags_match_jax(tmp_path, monkeypatch):
    """The same tiny run through both runtimes writes the same (tag, step)
    pairs to scalars.jsonl; the values differ (other random streams)."""
    monkeypatch.chdir(tmp_path)
    jloop = JaxTrainLoop(JaxConfig.wrap(tiny_cfg(5)), exp_id="jax")
    assert jloop.k_steps == 1
    jloop.run()
    with open(os.path.join(jloop.recorder.exp_path, "tensorboard", "scalars.jsonl")) as f:
        want = sorted((r["tag"], r["step"]) for r in map(json.loads, f))
    loop = _loop("port", iterations=5)
    loop.run()
    assert sorted((r["tag"], r["step"]) for r in _scalars(loop)) == want
    assert {s for _, s in want} == {2, 4, 5}


def test_scalar_writer_rank_zero_only(tmp_path, monkeypatch):
    w = recorder.ScalarWriter(str(tmp_path))
    w.add_scalar("a", 1.0, 1)
    # the writer's gate is parallel.is_rank0 (recorder imports it)
    monkeypatch.setattr(recorder, "is_rank0", lambda: False)
    w.add_scalar("b", 2.0, 2)
    w.close()
    with open(w.path) as f:
        assert [json.loads(line)["tag"] for line in f] == ["a"]
    monkeypatch.undo()
    assert recorder.is_rank0()


def test_snapshots(tmp_path):
    loop = TrainLoop(config_from_dict(tiny_cfg(2)), device="cpu")
    loop.run()
    rec = Recorder("default", None, root=str(tmp_path), snapshot=2, timestamp="t")
    for _ in range(5):
        rec.record_checkpoint(loop.state, loop.generator)
    snaps = sorted(os.path.basename(p) for p in glob.glob(os.path.join(rec.ckpt_dir, "state_*")))
    assert snaps == ["state_00000002.npz"] and os.path.isfile(rec.ckpt_path())
    assert Recorder.find_resume_cfg("x/y") == os.path.join("x/y", "dump_cfg.yaml")


def test_pose_plots(tmp_path, monkeypatch):
    """With LEARN_R, the loop draws the camera plots every 50 log steps
    into the image sink; without matplotlib it logs one line and skips."""
    monkeypatch.chdir(tmp_path)
    cfg = tiny_cfg(50, LOG_INTERVAL=1, SAVE_INTERVAL=1000)
    cfg["MODEL"]["LEARN_R"] = True
    drawn = []
    monkeypatch.setattr(recorder.ScalarWriter, "add_image",
                        lambda self, tag, img, step: drawn.append((tag, img.shape, step)))
    loop = TrainLoop(config_from_dict(cfg), device="cpu", exp_id="default")
    assert loop.pose_plots
    loop.run(49)
    assert drawn == []
    loop.run(50)
    assert [(t, s) for t, _, s in drawn] == [("poses", 50), ("poses_track", 50)]
    assert all(len(shape) == 3 and shape[2] == 3 for _, shape, _ in drawn)
    import importlib.util
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib" else real(name, *a))
    assert not TrainLoop(config_from_dict(cfg), device="cpu", exp_id="default").pose_plots


def test_viztools_and_misc_match_jax():
    rng = np.random.RandomState(0)
    c2ws = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    c2ws[:, :3, 3] = rng.randn(5, 3)
    np.testing.assert_array_equal(viztools.plot_camera_scene(c2ws, 1.5, "s"),
                                  jviztools.plot_camera_scene(c2ws, 1.5, "s"))
    np.testing.assert_array_equal(viztools.plot_cameras_track(c2ws, "t"),
                                  jviztools.plot_cameras_track(c2ws, "t"))
    cfg = tiny_cfg()
    assert misc.format_cfg(cfg) == jmisc.format_cfg(cfg)

    class Args:
        cfg, iterations = "x.yml", 3
    assert misc.format_args_cfg(Args(), cfg) == jmisc.format_args_cfg(Args(), cfg)
    np.testing.assert_array_equal(misc.CONST.PYRENDER_EXTRINSIC, jmisc.CONST.PYRENDER_EXTRINSIC)
    assert (misc.CONST.PI, misc.CONST.INT_MAX) == (jmisc.CONST.PI, jmisc.CONST.INT_MAX)
    with pytest.raises(AttributeError, match="immutable"):
        misc.CONST.PI = 3


def test_train_resume_cli(tmp_path):
    """train, then train --resume <exp dir> as subprocesses: the resumed
    run reads dump_cfg.yaml, starts at the checkpoint's step, keeps
    snapshots and writes a profile trace."""
    cfg_path = tmp_path / "tiny.yml"
    cfg_path.write_text(yaml.safe_dump(tiny_cfg(2)))
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}

    def run(*args):
        out = subprocess.run([sys.executable, "-m", "color_neus_torch.train", *args,
                              "--device", "cpu"], cwd=tmp_path, capture_output=True,
                             text=True, timeout=300, env=env)
        assert out.returncode == 0, out.stderr
        return out.stderr

    run("--cfg", str(cfg_path), "--exp_id", "default", "--snapshot", "1")
    (exp,) = glob.glob(str(tmp_path / "exp" / "default_*"))
    assert os.path.isfile(os.path.join(exp, "dump_cfg.yaml"))
    assert os.path.isfile(os.path.join(exp, "checkpoints", "state_00000002.npz"))
    log = run("--resume", exp, "--iterations", "4", "--profile", str(tmp_path / "prof"))
    assert "resumed at step 2" in log and "training on cpu: steps 2..4" in log
    assert "step 4 | loss" in log
    with np.load(os.path.join(exp, "checkpoints", "state.npz")) as ck:
        assert int(ck["step"]) == 4
    with open(tmp_path / "prof" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    out = subprocess.run([sys.executable, "-m", "color_neus_torch.train"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode != 0 and "--resume" in out.stderr
