"""The MARCH_BWD_PRECISION instantiations of the point-pipeline kernels
(csrc/point_pipeline.cu built with PP_PREC 1, 'bf16', and 2, 'f32'; the
march's in tests/test_torch_bwd_precision_march_emulated.py, on this
file's _compile), compiled for the CPU and held against their plain twins
in the same mode.

As tests/test_torch_point_pipeline_emulated.py and
tests/test_torch_ray_march_emulated.py do for the default f32stash: the
source runs through a host C++ compiler against tests/cuda_emu/
cuda_runtime.h (one std::thread per CUDA thread, the software wgmma and
bulk copies), with -DPP_PREC selecting the mode's kernels, on 2 blocks at 2
tiles a weight-grad batch, and the plain twins run with bf16=True in the
same march_bwd_precision. Every output, pts / dirs (rays) cotangent and
leaf is held as those files hold f32stash: the pipeline within RTOL_BF16 of
its largest |twin| (and within a tenth of the twin's gap where the bf16
twin is more than 1e-2 from the f32 one), the march's backward against
the twin in float64 (RTOL_BF16 plus twice the f32 twin's own distance).
'f32' computes the SDF chain in f32 FMAs, so its SDF outputs and leaves are
held tighter, within RTOL_F32 (read <= 5.6e-6 on the pipeline); its colour
and relight chains stay bf16.

Mutants that must fail: 'bf16' with the tangent pre-gates zt stored in
f32 (f32stash's store; the bf16 twin's SDF leaves then read ~4e-3 off,
against <= 7.4e-4 for the source), and 'f32' with the activation operands
of its SDF products rounded to bf16 (the SDF leaves ~1e-2 off). Skips
without a C++20 compiler."""

import dataclasses
import os
import re
import shutil
import subprocess

import pytest
import torch

from color_neus_torch import pin_precision
from color_neus_torch.ops.kernels import point_pipeline as PP
from tests import test_torch_point_pipeline_emulated as EP

pin_precision()

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "color_neus_torch", "csrc")
PREC = {"bf16": 1, "f32": 2}
RTOL_BF16 = EP.RTOL_BF16
RTOL_F32 = 1e-4
# the tangent pre-gates' store (backward_tile) and f32's store: the bf16 mutant
ZT_STORE = "z[r * HID + c] = PREC == PREC_BF16 ? round_bf16(acc) : acc;"
ZT_STORE_MUTANT = "z[r * HID + c] = acc;"
# f32_product's activation operands, and the same rounded to bf16: the f32 mutant
F32_A = "const float av[4] = {a.x, a.y, a.z, a.w};"
F32_A_MUTANT = ("const float av[4] = {round_bf16(a.x), round_bf16(a.y), round_bf16(a.z), "
                "round_bf16(a.w)};")
MUTANTS = {"bf16": (ZT_STORE, ZT_STORE_MUTANT), "f32": (F32_A, F32_A_MUTANT)}


def _compile(out, source, harness, mode, mutate=False):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the emulated kernels")
    with open(os.path.join(CSRC, f"{source}.cu")) as f:
        src = re.sub(r"<<<.*?>>>", "", f.read(), flags=re.S)   # launches run on host threads
    with open(os.path.join(CSRC, "point_pipeline_tile.cuh")) as f:
        tile = f.read()
    if mutate:
        line, mutant = MUTANTS[mode]
        assert tile.count(line) == 1, f"the {mode} mutant's line moved"
        tile = tile.replace(line, mutant)
    src = src.replace('#include "point_pipeline_tile.cuh"', tile)
    with open(os.path.join(HERE, "cuda_emu", harness)) as f:
        src += f.read()
    path = out / "emu.cpp"
    path.write_text(src)
    exe = str(out / "emu")
    proc = subprocess.run([cxx, "-std=c++20", "-O2", "-pthread", "-Wno-unknown-pragmas",
                           f"-DPP_PREC={PREC[mode]}", "-I", os.path.join(HERE, "cuda_emu"),
                           "-I", CSRC, "-x", "c++", str(path), "-o", exe],
                          capture_output=True, text=True)
    if proc.returncode != 0 and "barrier" in proc.stderr:
        pytest.skip("the host compiler lacks C++20 <barrier>")
    assert proc.returncode == 0, proc.stderr
    return exe


@pytest.fixture(scope="module")
def pipeline_emulators(tmp_path_factory):
    return {mode: _compile(tmp_path_factory.mktemp(f"emu_pp_{mode}"), "point_pipeline",
                           "harness.cpp", mode) for mode in PREC}


def _in_mode(pw, mode):
    return PP.PipelineWeights(dataclasses.replace(pw.rcfg, march_bwd_precision=mode),
                              pw.sdf, pw.color, pw.relight)


def _sdf_part(name) -> bool:
    return name in ("sdf", "grad") or name.startswith("sdf layer")


def _pipeline_errors(exe, tmp_path, mode, kind, relight=None):
    pw, pts, dirs, cots, gbar = EP._case(kind, relight or {})
    pw = _in_mode(pw, mode)
    kernel = EP._run(exe, tmp_path, pw, pts, dirs, gbar, blocks=2)
    return EP._errors(kernel, EP._plain(pw, pts, dirs, cots, True),
                      EP._plain(pw, pts, dirs, cots, False))


@pytest.mark.parametrize("kind", ["color_neus", "neus"])
@pytest.mark.parametrize("mode", list(PREC))
def test_emulated_pipeline_mode_matches_its_twin(pipeline_emulators, tmp_path, mode, kind):
    errs = _pipeline_errors(pipeline_emulators[mode], tmp_path, mode, kind)
    worst_sdf = max(e for name, (e, _) in errs.items() if _sdf_part(name))
    print(f"{mode} {kind}: worst SDF output / leaf {worst_sdf:.3e} from the twin")
    for name, (err, gap) in errs.items():
        limit = RTOL_F32 if mode == "f32" and _sdf_part(name) else RTOL_BF16
        assert err <= limit, f"{name}: {err:.3e} from the {mode} twin, above {limit:g}"
        assert gap <= 1e-2 or err < 0.1 * gap, \
            f"{name}: {err:.3e} from the {mode} twin, not below a tenth of its f32 gap {gap:.3e}"


@pytest.mark.parametrize("mode", list(PREC))
def test_emulated_mode_mutant_fails(tmp_path_factory, tmp_path, mode):
    """'bf16' storing zt in f32, 'f32' rounding its SDF products' activation
    operands to bf16: each runs, and an SDF leaf leaves the mode's twin by
    more than the limit its source holds."""
    exe = _compile(tmp_path_factory.mktemp(f"emu_pp_{mode}_mutant"), "point_pipeline",
                   "harness.cpp", mode, mutate=True)
    errs = _pipeline_errors(exe, tmp_path, mode, "color_neus")
    worst = max(e for name, (e, _) in errs.items() if name.startswith("sdf layer"))
    assert worst > (RTOL_F32 if mode == "f32" else RTOL_BF16), errs
