"""The port's step and extraction instruments (color_neus_torch/tools/:
bench_step, bench_ab, profile_step, trace_profile, march_ablate,
mesh_extraction_timing, extract_probe, merge_bench, eval_fused_check)
against the JAX round's (bench.py, tools/*.py), on the CPU.

build_bench's TrainerConfig equals the one JAX's build_bench hands its
step builder, field by field (the port's fused_march 'on' against JAX's
'auto', which resolves to on on the TPU: the one difference, asserted),
and its poses, images and masks equal JAX's bitwise (both drawn from
RandomState(0)); a 4-ray step of 1 runs with a finite loss and advances
the state; flops_per_step equals the count written out from the widths.
Every tool that has a CPU path prints JAX's keys (chip_smoke.JAX_TOOL_KEYS,
each checked to be in the JAX tool's source) at a tiny size with --device
cpu; march_ablate raises without a card. Timings on the CPU are not
checked."""

import dataclasses
import importlib
import importlib.util
import json
import os
import re

import numpy as np
import pytest
import torch

import chip_smoke
from color_neus_torch.models.configs import _UNPORTED_KEYS
from color_neus_torch.tools import bench_step as BS

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOOL_FILE = {"bench_ab": "tools/bench_ab.py", "profile_step": "tools/profile_step.py",
                 "trace_profile": "tools/trace_profile.py",
                 "march_ablate": "tools/march_ablate.py",
                 "mesh_extraction_timing": "tools/mesh_extraction_timing.py",
                 "extract_probe": "tools/extract_probe.py", "merge_bench": "tools/merge_bench.py",
                 "eval_fused_check": "tools/tpu_eval_fused_check.py"}


def _jax_bench(monkeypatch, n_rays=4):
    """JAX's build_bench, its step builder replaced by one that keeps the
    TrainerConfig it is given: (cfg, args, flops)."""
    from color_neus_tpu.models import trainer as jtrainer
    seen = {}

    def keep(cfg, *a, **k):
        seen["cfg"] = cfg
        return None
    monkeypatch.setattr(jtrainer, "make_train_multi_step", keep)
    spec = importlib.util.spec_from_file_location("jax_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _, args, flops = mod.build_bench(n_rays, 1)
    return seen["cfg"], args, flops


def _fields_equal(port, ref, path=""):
    """Every field of the port's dataclass that the JAX one has, equal
    (nested dataclasses field by field); returns the compared paths."""
    seen = []
    for f in dataclasses.fields(port):
        if not hasattr(ref, f.name):
            continue
        a, b = getattr(port, f.name), getattr(ref, f.name)
        name = f"{path}{f.name}"
        if dataclasses.is_dataclass(a):
            seen += _fields_equal(a, b, name + ".")
            continue
        if name == "renderer.fused_march":
            assert (a, b) == ("on", "auto"), (a, b)   # the trap the module note names
        else:
            assert (tuple(a) if isinstance(a, (list, tuple)) else a) == \
                (tuple(b) if isinstance(b, (list, tuple)) else b), (name, a, b)
        seen.append(name)
    return seen


def test_build_bench_config_and_data_match_jax(monkeypatch):
    jcfg, (jstate, jscene, jimages, jmasks, _key), _ = _jax_bench(monkeypatch)
    step_fn, (state, scene, images, masks, gen), _ = BS.build_bench(4, 1, device="cpu")
    seen = _fields_equal(step_fn.cfg, jcfg)
    assert {"n_rays", "mask_rate", "camera.pose_mode", "renderer.n_samples",
            "renderer.march_acts", "renderer.color.mode", "renderer.sdf.d_hidden"} <= set(seen)
    for key, default in _UNPORTED_KEYS.items():   # JAX's TPU keys at their defaults
        assert getattr(jcfg.renderer, key.lower()) == default
    for k in ("origin", "radius", "init_c2w"):
        np.testing.assert_array_equal(scene[k].numpy(), np.asarray(jscene[k]))
    np.testing.assert_array_equal(images.numpy(), np.asarray(jimages))
    np.testing.assert_array_equal(masks.numpy(), np.asarray(jmasks))
    assert scene["init_c2w"].dtype == images.dtype == masks.dtype == torch.float32


def test_build_bench_raises_on_tpu_keys():
    for kw in ({"march_tile": 64}, {"thin_dots": "mxu"}):
        with pytest.raises(NotImplementedError):
            BS.build_bench(4, 1, device="cpu", **kw)


def test_bench_step_runs_and_advances():
    """A 4-ray call of 1 step: a finite loss, the counters and Adam's
    moments advance (step 0 runs at lr 0 under the warm-up, as in JAX);
    two more steps (time_step's untimed and timed calls) move the weights."""
    step_fn, args, _ = BS.build_bench(4, 1, device="cpu")
    state = args[0]
    before = [p.detach().clone() for p in state.params.parameters()]
    loss = BS.call(step_fn, args)
    assert np.isfinite(loss) and loss > 0
    assert state.step == 1 and int(state.step_t) == 1
    moments = [st["exp_avg"] for st in state.optimizer.state.values()]
    assert moments and any(float(m.abs().max()) > 0 for m in moments)
    times = BS.time_step(step_fn, args, rounds=1)
    assert len(times) == 1 and times[0] > 0 and state.step == 3
    moved = sum(not torch.equal(a, p.detach()) for a, p in zip(before, state.params.parameters()))
    assert moved > 0.5 * len(before)


def test_flops_per_step_is_the_width_count():
    """2 R (512 (fwd + bwd) + 448 sweep) multiply-adds at the real widths
    (PE 39, the skip's 217, colour's 262 input, relight's 33 and 259): the
    save mode's backward without the recompute."""
    n_rays = 4
    _, _, flops = BS.build_bench(n_rays, 1, device="cpu")
    hid = 39 * 256 + 2 * 256 * 256 + 256 * 217 + 4 * 256 * 256   # SDF layers 0-7
    sdf = hid + 256 * 257
    colour = 262 * 256 + 3 * 256 * 256 + 256 * 3
    relight = 33 * 256 + 2 * 256 * 256 + 259 * 256 + 256 * 3
    fwd = sdf + hid + colour + relight
    bwd = 2 * (colour + relight) + hid + 2 * 256 * 257 + 4 * hid + 2 * 39 * 256
    sweep = hid + 256 * 1
    assert flops == 2 * n_rays * (512 * (fwd + bwd) + (256 + 3 * 64) * sweep)


@pytest.mark.parametrize("tool", sorted(JAX_TOOL_FILE))
def test_jax_tool_keys_are_jax_s(tool):
    """Each key chip_smoke holds the port's tools to is one the JAX tool
    writes: a quoted name in its source, or an f-string of it
    (f"vertex_colors_{mode}_max_abs_err")."""
    with open(os.path.join(REPO, JAX_TOOL_FILE[tool])) as f:
        src = f.read()
    templates = [re.sub(r"\\\{[^}]*\\\}", ".+", re.escape(t))
                 for t in re.findall(r'f"([^"]*\{[^"]*)"', src)]
    top, _, nested = chip_smoke.JAX_TOOL_KEYS[tool]
    for k in top + nested:
        assert (f'"{k}"' in src or f"'{k}'" in src
                or any(re.fullmatch(t, k) for t in templates)), (tool, k)


CPU_RUNS = {
    "bench_ab": {"AB_KEY": "march_acts", "AB_A": "save", "AB_B": "recompute", "AB_ROUNDS": "1",
                 "BENCH_N_RAYS": "4", "BENCH_K_STEPS": "1"},
    "profile_step": {"PROF_N_RAYS": "4", "PROF_ITERS": "1"},
    "trace_profile": {"PROF_N_RAYS": "4", "TRACE_BUNDLES": "1", "TRACE_K_STEPS": "1"},
    "mesh_extraction_timing": {"MET_RES": "32", "MET_PREC": "bf16"},
    "extract_probe": {"EP_RES": "16", "EP_REPS": "1"},
    "merge_bench": {"MB_R": "8"},
    "eval_fused_check": {"EFC_RES": "16", "EFC_VERTS": "500"},
}


@pytest.mark.parametrize("tool", sorted(CPU_RUNS))
def test_tool_prints_jax_keys_on_the_cpu(tool, monkeypatch, capsys, tmp_path):
    for k, v in CPU_RUNS[tool].items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("TRACE_DIR", str(tmp_path))
    mod = importlib.import_module(f"color_neus_torch.tools.{tool}")
    rep = mod.main(["--device", "cpu"])
    printed = chip_smoke.last_json(capsys.readouterr().out)
    assert printed == json.loads(json.dumps(rep))
    assert chip_smoke.jax_keys_missing(tool, printed) == []
    if tool == "eval_fused_check":
        assert printed["pass"] is True
    if tool == "merge_bench":
        assert printed["z_equal"] and printed["sdf_equal"] and printed["hierarchy_z_equal"]
    if tool == "mesh_extraction_timing":   # the bf16 arm beside its f32 reference
        assert printed["f32_reference"]["max_abs_sdf_err_vs_f32"] < 0.05
        assert printed["res32"]["n_verts"] == printed["res32"]["n_verts_sparse"] > 0
    if tool == "trace_profile":   # the saved trace parses again
        monkeypatch.setenv("PARSE_ONLY", "1")
        monkeypatch.setenv("N_STEPS", "1")
        again = mod.main([])
        assert again["top_ops_ms_per_step"] == printed["top_ops_ms_per_step"]


def test_march_ablate_raises_on_the_cpu():
    from color_neus_torch.tools import march_ablate
    with pytest.raises(RuntimeError, match="card"):
        march_ablate.run(4, 1, torch.device("cpu"))
    with pytest.raises(RuntimeError):
        march_ablate.main(["--device", "cpu"])
