"""The march's ablation builds (csrc/point_pipeline_tile.cuh RM_ABLATE,
ops/kernels/build.py ABLATIONS, timed by color_neus_torch/tools/
march_ablate.py on the card) rehearsed on the CPU, as
tests/test_torch_ray_march_emulated.py rehearses the kernels: the source
compiled by the host compiler against tests/cuda_emu/cuda_runtime.h.

In each MARCH_BWD_PRECISION mode, each variant's switch (-DRM_ABLATE=1..4,
build.ABLATE, with the mode's flags) compiles, and its save pair runs to
the end on one case (2 rays x 27 samples on one block: one forward and one
backward tile; a skipped barrier would hang it) and leaves the mode's
default build's outputs (an ablated output is garbage, so only the
difference is checked: each switch is live). The f32stash default build,
compiled without the switch, holds the plain twins on the same case at
test_torch_ray_march_emulated.py's limits (the other modes' default builds
are held to their twins by test_torch_bwd_precision_march_emulated.py).
That file holds the default source on its own cases; the default build's
emulated outputs were bitwise those of the source before the switch when
it was added."""

import concurrent.futures as cf

import pytest
import torch

from color_neus_torch.ops.kernels import build
from tests.test_torch_ray_march_emulated import _compile, _run, case_inputs, check_result

CASE = ("color_neus", 2, 27, 0.76, 0.005, 9)


def _flat(res) -> torch.Tensor:
    out, stash, rays_hat, s_hat, grads = res[:5]
    parts = [out, stash, rays_hat, torch.as_tensor(s_hat).reshape(1)]
    parts += [t for layers in grads.values() for wb in layers for t in wb]
    return torch.cat([t.reshape(-1) for t in parts])


@pytest.mark.parametrize("mode", ["f32stash", "bf16", "f32"])
def test_ablation_builds_compile_run_and_differ(tmp_path, mode):
    names = {"default": build.MODE_BUILDS[mode][1]} | {
        v: build.ABLATIONS[lib][1] for v, lib in build.ablation_names(mode).items()
        if v != "full"}
    assert set(names) == {"default", "no_pullback", "no_unflatten", "pullback_only", "no_wgrad"}
    case = case_inputs(*CASE, mode=mode)
    for name in names:
        (tmp_path / name).mkdir()
        (tmp_path / f"run_{name}").mkdir()
    with cf.ThreadPoolExecutor(len(names)) as pool:
        exes = dict(zip(names, pool.map(lambda kv: _compile(tmp_path / kv[0], defines=kv[1]),
                                        names.items())))
        runs = dict(zip(names, pool.map(
            lambda n: _run(exes[n], tmp_path / f"run_{n}", *case, blocks=1, save=True),
            names)))
    if mode == "f32stash":
        check_result(runs["default"], case, CASE[3], save=True)
    base = _flat(runs["default"]).nan_to_num(nan=1e30)
    for name in names:
        if name != "default":
            got = _flat(runs[name]).nan_to_num(nan=1e30)
            assert not torch.equal(got, base), f"{name}: the switch changed nothing"


@pytest.mark.parametrize("mode", ["f32stash", "bf16", "f32"])
def test_ablation_names_and_flags(mode):
    """Each MARCH_BWD_PRECISION mode has the five ablation builds of the
    march's source, named by the mode's suffix, with the mode's PP_PREC and
    the variant's RM_ABLATE (march_ablate's ABL_PREC picks them)."""
    prec = {"f32stash": None, "bf16": 1, "f32": 2}[mode]
    names = build.ablation_names(mode)
    assert list(names) == ["full", "no_pullback", "no_unflatten", "pullback_only", "no_wgrad"]
    infix = {"f32stash": "", "bf16": "_bf16s", "f32": "_f32s"}[mode]
    for k, (variant, name) in enumerate(names.items()):
        assert name == f"ray_march_abl{infix}_{variant}"
        src, flags = build.ABLATIONS[name]
        assert src == "ray_march"
        want = (() if prec is None else (f"-DPP_PREC={prec}",)) + (f"-DRM_ABLATE={k}",)
        assert flags == want, (name, flags)
    assert len(build.ABLATIONS) == 15 and len(set(build.ABLATIONS)) == 15
