"""Several training steps per dispatch (trainer.make_train_multi_step and
TrainLoop's bundles) on the CPU, against the JAX package where it has the
same function.

Everything a step reads from the step count is computed on the device in
f32 from the state's counter: the schedules are held within one f32 ulp
(rtol 1.2e-7) of JAX's lr_schedule, the masked samplers' share and their
in-mask ray count exactly. On the CPU a bundle is a loop of single steps,
so a bundle of 3 must equal 3 single full-data steps bitwise (parameters,
Adam's state, the generator, the losses), and a bundled TrainLoop stopped
and resumed must equal a straight one bitwise. The bundling rule is the
JAX TrainLoop's (color_neus_tpu/runtime.py:104-109)."""

import copy
import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from color_neus_tpu.models import trainer as JTR
from color_neus_tpu.ops import rays as jrays
from color_neus_tpu.runtime import TrainLoop as JaxTrainLoop
from color_neus_tpu.utils.config import Config as JaxConfig

from color_neus_torch import pin_precision
from color_neus_torch.models import trainer as TR
from color_neus_torch.ops import rays
from color_neus_torch.runtime import TrainLoop, bundle_steps
from color_neus_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from color_neus_torch.utils.config import config_from_dict, get_config
from color_neus_torch.utils.recorder import Recorder

from tests.test_torch_runtime import _assert_states_equal, tiny_cfg
from tests.test_torch_trainer import TINY_CFG, _cfgs

torch.set_num_threads(1)
pin_precision()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ULP_RTOL = 1.2e-7     # one f32 ulp relative


@pytest.mark.parametrize("scheduler", ["NEUS", "NERF"])
def test_device_schedules_match_jax(scheduler):
    """The schedule of the device counter (a 0-d int64 tensor) against
    JAX's lr_schedule at the warm-up's edges, mid-run and the last step."""
    jcfg, pcfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, scheduler=scheduler, iterations=300000, warm_up=5000,
                               decay_steps=250000)
    pcfg = dataclasses.replace(pcfg, scheduler=scheduler, iterations=300000, warm_up=5000,
                               decay_steps=250000)
    w, it = pcfg.warm_up, pcfg.iterations
    for s in (0, 1, w - 1, w, w + 1, 12345, it // 2, it - 1, it):
        got = TR.lr_schedule(pcfg)(torch.tensor(s, dtype=torch.int64))
        assert got.dtype == torch.float32 and got.shape == ()
        want = np.asarray(JTR.lr_schedule(jcfg)(jnp.asarray(s, jnp.int32)))
        np.testing.assert_allclose(got.numpy(), want, rtol=ULP_RTOL, atol=0, err_msg=str(s))
    if scheduler == "NEUS":
        assert float(TR.lr_schedule(pcfg)(torch.tensor(0))) == 0.0


def test_device_mask_share_and_in_mask_count_match_jax():
    """The share at the step (JAX _mask_rate_at) and the exact sampler's
    in-mask ray count (int(share * n_rays) in f32, JAX rays.py:164-167),
    both exactly, at steps across a DTU-length run."""
    jcfg, pcfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, iterations=100000)
    pcfg = dataclasses.replace(pcfg, iterations=100000)
    n_rays = 1024
    yy, xx = np.mgrid[0:32, 0:32]
    m = (((yy - 15.5) ** 2 + (xx - 15.5) ** 2) < 13.0 ** 2).astype(np.float32)
    masks = np.tile(m[None], (4, 1, 1))          # 2124 pixels in, 1972 out
    g = torch.Generator().manual_seed(0)
    for s in (0, 1, 7, 333, 12345, 50000, 77777, 99999, 100000):
        share = TR._mask_rate_at(pcfg, torch.tensor(s, dtype=torch.int64))
        want = np.asarray(JTR._mask_rate_at(jcfg, jnp.asarray(s, jnp.int32)))
        assert share.dtype == torch.float32
        np.testing.assert_array_equal(share.numpy(), want, err_msg=str(s))
        n_in_j = int(jnp.asarray(jnp.asarray(want) * n_rays, jnp.int32))
        *_, sel = rays.sample_pixels_masked_exact(g, torch.from_numpy(masks), n_rays, share)
        *_, sel_j = jrays.sample_pixels_masked_exact(jax.random.PRNGKey(s), jnp.asarray(masks),
                                                     n_rays, jnp.asarray(want))
        assert int(sel.sum()) == int(np.asarray(sel_j).sum()) == n_in_j, s


def _loop(fused_core="auto", fused_march="auto"):
    cfg = copy.deepcopy(TINY_CFG)
    cfg["MODEL"]["RENDERER"].update(FUSED_CORE=fused_core, FUSED_MARCH=fused_march)
    cfg["TRAIN"]["ITERATIONS"] = 10
    return TrainLoop(config_from_dict(cfg), device="cpu")


@pytest.mark.parametrize("fused_core,fused_march", [
    pytest.param("auto", "auto", id="auto"), pytest.param("on", "auto", id="core-on"),
    pytest.param("auto", "on", id="march-on")])
def test_bundle_equals_single_steps_bitwise(fused_core, fused_march):
    """make_train_multi_step(k=3) against 3 full_data_steps from the same
    state and generator state: parameters, Adam's state, the step, the
    generator and the losses bitwise; loss_mean the losses' mean and the
    aux the last step's (JAX's contract, trainer.py:390-393)."""
    a, b = _loop(fused_core, fused_march), _loop(fused_core, fused_march)
    a.run(1)                       # off lr 0, with Adam's state created
    b.run(1)
    _assert_states_equal(a, b)
    multi = TR.make_train_multi_step(a.tcfg, a.n_imgs, a.batch_size, 3)
    state, aux, losses = multi(a.state, a.scene, a.images, a.masks, a.generator)
    assert state is a.state and state.step == 4 and int(state.step_t) == 4
    singles = [TR.full_data_step(b.state, b.scene, b.tcfg, b.images, b.masks, b.batch_size,
                                 b.generator) for _ in range(3)]
    _assert_states_equal(a, b)
    assert int(b.state.step_t) == 4
    assert torch.equal(losses, torch.stack([s["loss"] for s in singles]))
    assert torch.equal(aux["loss_mean"], torch.mean(losses))
    assert set(aux) == set(singles[-1]) | {"loss_mean"}
    for k, v in singles[-1].items():
        assert torch.equal(aux[k], v), k
    assert float(aux["lr"]) > 0


def test_k_steps_rule_matches_jax(tmp_path, monkeypatch):
    """bundle_steps against the JAX TrainLoop's expression on every shipped
    config (all line up at LOG_INTERVAL 10) and on configs whose intervals
    do not; the JAX TrainLoop itself on two tiny configs."""
    def jax_rule(t):               # color_neus_tpu/runtime.py:104-109, verbatim
        log_int = max(t.get("LOG_INTERVAL", 10), 1)
        intervals = [t.get("SAVE_INTERVAL", 10000), t.get("VIZ_IMAGE_INTERVAL", 10000),
                     t.get("VIZ_MESH_INTERVAL", 10000), t["ITERATIONS"]]
        return log_int if all(i % log_int == 0 for i in intervals) else 1

    paths = sorted(glob.glob(os.path.join(REPO, "config", "*.yml")))
    assert len(paths) >= 10
    for path in paths:
        t = get_config(path)["TRAIN"]
        assert bundle_steps(t) == jax_rule(t) == 10, path
    for t in ({"LOG_INTERVAL": 10, "SAVE_INTERVAL": 25, "ITERATIONS": 100},
              {"LOG_INTERVAL": 4, "VIZ_MESH_INTERVAL": 6, "ITERATIONS": 8},
              {"LOG_INTERVAL": 10, "SAVE_INTERVAL": 100, "ITERATIONS": 105}):
        assert bundle_steps(t) == jax_rule(t) == 1, t
    monkeypatch.chdir(tmp_path)
    for cfg, k in ((tiny_cfg(8, LOG_INTERVAL=2, SAVE_INTERVAL=4), 2), (tiny_cfg(6), 1)):
        assert JaxTrainLoop(JaxConfig.wrap(cfg), exp_id="jax").k_steps == k
        loop = TrainLoop(config_from_dict(cfg), device="cpu")
        assert loop.k_steps == k and (loop.multi_step is None) == (k == 1)


def _bundled(exp_id=None, iterations=8, resume=None):
    cfg = tiny_cfg(iterations, LOG_INTERVAL=2, SAVE_INTERVAL=4)
    return TrainLoop(config_from_dict(cfg), device="cpu", exp_id=exp_id, resume=resume)


def test_bundled_stop_resume_is_bitwise(tmp_path, monkeypatch):
    """Bundles of 2: stop_after=3 stops at the bundle boundary 4 with a
    checkpoint; a loop resumed from the directory runs bundles to 8 and
    ends bitwise equal to a straight bundled run, losses included."""
    monkeypatch.chdir(tmp_path)
    straight = _bundled()
    assert straight.k_steps == 2
    losses = straight.run()
    assert losses.shape == (8,) and straight.state.step == 8
    stopped = _bundled("stopped")
    part = stopped.run(stop_after=3)
    assert stopped.state.step == 4 and part.shape == (4,)
    exp = stopped.recorder.exp_path
    resumed = TrainLoop(get_config(Recorder.find_resume_cfg(exp)), device="cpu", resume=exp)
    assert resumed.state.step == 4 and int(resumed.state.step_t) == 4
    rest = resumed.run()
    _assert_states_equal(straight, resumed)
    assert torch.equal(torch.cat([part, rest]), losses)


def test_run_ends_at_iterations_off_the_bundle_grid():
    """run(n) with n not a multiple of k: bundles while a whole one fits,
    then single steps, ending at exactly n; the device counter follows."""
    loop = _bundled(iterations=8)
    calls = []
    bundle, single = loop.training_bundle, loop.training_step
    loop.training_bundle = lambda: calls.append("b") or bundle()
    loop.training_step = lambda: calls.append("s") or single()
    losses = loop.run(5)
    assert loop.state.step == 5 and int(loop.state.step_t) == 5 and losses.shape == (5,)
    assert calls == ["b", "b", "s"]
    losses = loop.run(8)           # off the grid: one step to 6, then a bundle
    assert loop.state.step == 8 and losses.shape == (3,) and calls[3:] == ["s", "b"]


def test_a_load_moves_what_a_captured_bundle_reads(tmp_path):
    """A checkpoint load replaces the optimizer's state and its lr tensor,
    which a captured graph reads by address: the bundle's bound changes,
    so the next CUDA bundle captures anew. The load sets both step
    counts."""
    loop = _bundled(iterations=8)
    loop.run(2)
    path = str(tmp_path / "state.npz")
    save_checkpoint(path, loop.state, loop.generator)
    loop.run(4)
    before = [t.data_ptr() for t in TR._captured_tensors(loop.state, loop.scene, loop.images,
                                                         loop.masks)]
    load_checkpoint(path, loop.state, loop.generator)
    after = [t.data_ptr() for t in TR._captured_tensors(loop.state, loop.scene, loop.images,
                                                        loop.masks)]
    assert len(before) == len(after) and before != after
    assert loop.state.step == 2 and int(loop.state.step_t) == 2
