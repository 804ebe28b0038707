"""The MARCH_BWD_PRECISION instantiations of the point-pipeline kernels
(csrc/point_pipeline.cu built with PP_PREC 1, 'bf16', and 2, 'f32'; the
march's in tests/test_torch_bwd_precision_march_emulated.py, on this
file's _compile), compiled for the CPU and held against their plain twins
in the same mode.

As tests/test_torch_point_pipeline_emulated.py and
tests/test_torch_ray_march_emulated.py do for the default f32stash: the
source runs through a host C++ compiler against tests/cuda_emu/
cuda_runtime.h (a block's CUDA threads as fibers, the software wgmma and
bulk copies), with -DPP_PREC selecting the mode's kernels, on 2 blocks at 2
tiles a weight-grad batch, and the plain twins run with bf16=True in the
same march_bwd_precision. Every output, pts / dirs (rays) cotangent and
leaf is held as those files hold f32stash: the pipeline within RTOL_BF16 of
its largest |twin| (and within a tenth of the twin's gap where the bf16
twin is more than 1e-2 from the f32 one), the march's backward against
the twin in float64 (RTOL_BF16 plus twice the f32 twin's own distance).
'f32' computes the SDF chain in f32 as JAX's Precision.HIGHEST does, six
bf16 passes on the software wgmma, so its SDF outputs and leaves are held
tighter, within RTOL_F32 (read <= 8.1e-6 on the pipeline; the SIMT design
before it read <= 5.6e-6), its SDF features (the colour net's input,
from the forward's scratch) too against the twin's and the float64
twin's; its colour and relight chains stay bf16, and the few points whose
SDF outputs round to another bf16 value than the twin's leave their
comparison (_pipeline_errors).

Mutants that must fail: 'bf16' with the tangent pre-gates zt stored in
f32 (f32stash's store; the bf16 twin's SDF leaves then read ~4e-3 off,
against <= 7.4e-4 for the source); 'f32' with the activation operands of
its SDF products rounded to bf16 (load_a3 splitting bf16(x): mid and lo
zero); 'f32' with only the hi Hi pass of its products (the weight grads'
flush keeps its six). Skips without a C++20 compiler. split3, the host's
split of the weights, and the three-part images are checked without one."""

import dataclasses
import os
import re
import shutil
import subprocess

import numpy as np
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
FWD_ROWS = 128   # points in a forward tile (csrc/point_pipeline_tile.cuh)
# 'f32': the most flip points (_pipeline_errors) of _case's 130: two f32
# sums ~1e-6 of the features' largest apart round ~1 value in 10^4 apart
# (read 2 / 5 of 130 points, color_neus / neus); features off by more
# flip more points
FLIP_POINTS_MAX = 13
# the tangent pre-gates' store (backward_tile) and f32's store: the bf16 mutant
ZT_STORE = "z[r * HID + c] = PREC == PREC_BF16 ? round_bf16(acc) : acc;"
ZT_STORE_MUTANT = "z[r * HID + c] = acc;"
# load_a3's activation operands (csrc/mlp_common.cuh), and the same rounded
# to bf16: the f32 mutant
F32_A = "float u = x[i].x, v = x[i].y;"
F32_A_MUTANT = "float u = round_bf16(x[i].x), v = round_bf16(x[i].y);"
MUTANTS = {"bf16": (ZT_STORE, ZT_STORE_MUTANT), "f32": (F32_A, F32_A_MUTANT)}
# hp_step's six passes, and the last of them alone (hi Hi)
F32_PASSES = "for (int i = 0; i < 6; ++i)"
F32_ONE_PASS = "for (int i = 5; i < 6; ++i)"


def _compile(out, source, harness, mode, mutant=None, defines=()):
    """The emulator of csrc/<source>.cu in `mode` with `harness`; mutant:
    (line, replacement) in point_pipeline_tile.cuh or mlp_common.cuh (a
    mutated mlp_common.cuh is written beside emu.cpp, where its quoted
    include finds it first); defines: further -D macros."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the emulated kernels")
    with open(os.path.join(CSRC, f"{source}.cu")) as f:
        src = re.sub(r"<<<.*?>>>", "", f.read(), flags=re.S)   # launches run on host threads
    with open(os.path.join(CSRC, "point_pipeline_tile.cuh")) as f:
        tile = f.read()
    if mutant is not None:
        line, replacement = mutant
        with open(os.path.join(CSRC, "mlp_common.cuh")) as f:
            common = f.read()
        assert tile.count(line) + common.count(line) == 1, f"the {mode} mutant's line moved"
        tile = tile.replace(line, replacement)
        if line in common:
            (out / "mlp_common.cuh").write_text(common.replace(line, replacement))
    src = src.replace('#include "point_pipeline_tile.cuh"', tile)
    with open(os.path.join(HERE, "cuda_emu", harness)) as f:
        src += f.read()
    path = out / "emu.cpp"
    path.write_text(src)
    exe = str(out / "emu")
    proc = subprocess.run([cxx, "-std=c++20", "-O2", "-pthread", "-Wno-unknown-pragmas",
                           f"-DPP_PREC={PREC[mode]}", *[f"-D{d}" for d in defines],
                           "-I", os.path.join(HERE, "cuda_emu"), "-I", CSRC, "-x", "c++",
                           str(path), "-o", exe], capture_output=True, text=True)
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
    return name in ("sdf", "grad", "features", "features f64") or name.startswith("sdf layer")


def kernel_features(tmp_path, blocks, n_sdf, rows, gates=True):
    """The emulated forward's SDF features (the last SDF layer's 256
    outputs, [N, 256]) from its scratch as it ended (the harnesses'
    scratch_fwd.f32: per block the gates of its last 128-point tile, then
    their features; csrc/point_pipeline_tile.cuh fwd_scratch_floats).
    n_sdf: the SDF's linear layers; rows: [N] (block, row of its tile) of
    each point, every point in its block's last tile; gates False: the
    scratch holds the features alone (the march's save entry in 'f32')."""
    scratch = np.fromfile(tmp_path / "scratch_fwd.f32", np.float32).reshape(blocks, -1)
    tile = FWD_ROWS * PP.HID
    first = n_sdf - 1 if gates else 0
    feat = scratch[:, first * tile:(first + 1) * tile].reshape(blocks, FWD_ROWS, PP.HID)
    b, r = rows
    return torch.from_numpy(feat[b, r].copy())


def twin_sdf_outputs(pw, pts, dirs):
    """The twin's (gradient [N, 3], features [N, 256]): the SDF outputs the
    colour and relight nets take, in pts' dtype (f32 arithmetic in 'f32')."""
    outs, st = PP._forward(pw, pts, dirs, True)
    return outs[1], st.cs[0][:, -pw.rcfg.color.d_feature:]


def flip_points(kernel, twin):
    """Per point: whether any of its SDF outputs in `kernel` (gradient,
    features) rounds to another bf16 value than in `twin`, the colour
    and relight nets' operand."""
    def bf16(t):
        return t.float().to(torch.bfloat16)
    return torch.stack([(bf16(a) != bf16(b)).any(dim=1) for a, b in zip(kernel, twin)]).any(0)


def _pipeline_errors(exe, tmp_path, mode, kind, relight=None, off_flips=False):
    """(EP._errors of the emulated kernels against the twins in `mode`,
    the count of flip points). 'f32' adds the kernel's features against
    the twin's ("features") and the float64 twin's ("features f64"), as
    (error, 0); its flip points are those whose SDF gradient or features
    round to another bf16 value than the twin's (flip_points: an f32 sum
    within rounding of a bf16 midpoint, which the kernel's six-pass sums
    and the twin's matmuls round apart). They enter the bf16 colour and
    relight nets one bf16 ulp apart, where a relu mask downstream may
    flip. off_flips: every entry but sdf, grad and the features from a
    second run whose flip points' cotangents are 0 (as _case zeroes the
    relu kinks'), their colour and relight outputs left out."""
    pw, pts, dirs, cots, gbar = EP._case(kind, relight or {})
    pw = _in_mode(pw, mode)
    blocks = 2
    kernel = EP._run(exe, tmp_path, pw, pts, dirs, gbar, blocks=blocks)
    errs = EP._errors(kernel, EP._plain(pw, pts, dirs, cots, True),
                      EP._plain(pw, pts, dirs, cots, False))
    if mode != "f32":
        return errs, 0
    n = pts.shape[0]
    assert n <= blocks * FWD_ROWS, "a block's scratch holds its last tile only"
    i = np.arange(n)
    feat = kernel_features(tmp_path, blocks, len(pw.sdf), ((i // FWD_ROWS) % blocks, i % FWD_ROWS))
    pw64 = PP.PipelineWeights(pw.rcfg, *[[(w.double(), b.double()) for w, b in layers]
                                         for layers in (pw.sdf, pw.color, pw.relight)])
    grad, twin = twin_sdf_outputs(pw, pts, dirs)
    errs["features"] = (EP._rel(feat, twin), 0.0)
    errs["features f64"] = (EP._rel(feat.double(), twin_sdf_outputs(pw64, pts.double(),
                                                                    dirs.double())[1]), 0.0)
    flips = flip_points((kernel[0][:, 1:4], feat), (grad, twin))
    if off_flips and bool(flips.any()):
        keep = ~flips
        cots = [c * keep[:, None] for c in cots]
        kernel = EP._run(exe, tmp_path, pw, pts, dirs, gbar * keep[:, None], blocks=blocks)

        def rows(r):
            return (r[0][keep], *r[1:])
        nets = EP._errors(rows(kernel), rows(EP._plain(pw, pts, dirs, cots, True)),
                          rows(EP._plain(pw, pts, dirs, cots, False)))
        errs.update((name, e) for name, e in nets.items() if name not in ("sdf", "grad"))
    return errs, int(flips.sum())


@pytest.mark.parametrize("kind", ["color_neus", "neus"])
@pytest.mark.parametrize("mode", list(PREC))
def test_emulated_pipeline_mode_matches_its_twin(pipeline_emulators, tmp_path, mode, kind):
    errs, flips = _pipeline_errors(pipeline_emulators[mode], tmp_path, mode, kind, off_flips=True)
    worst_sdf = max(e for name, (e, _) in errs.items() if _sdf_part(name))
    print(f"{mode} {kind}: worst SDF output / leaf {worst_sdf:.3e} from the twin, "
          f"{flips} flip points")
    assert flips <= FLIP_POINTS_MAX, f"{flips} points' SDF outputs round apart from the twin's"
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
                   "harness.cpp", mode, mutant=MUTANTS[mode])
    errs, _ = _pipeline_errors(exe, tmp_path, mode, "color_neus")
    worst = max(e for name, (e, _) in errs.items() if name.startswith("sdf layer"))
    assert worst > (RTOL_F32 if mode == "f32" else RTOL_BF16), errs


def test_emulated_f32_one_pass_mutant_fails(tmp_path_factory, tmp_path):
    """'f32' with its products' hi Hi pass alone (hp_step's last): it
    runs, and an SDF leaf leaves the twin by more than RTOL_F32."""
    exe = _compile(tmp_path_factory.mktemp("emu_pp_f32_one_pass"), "point_pipeline",
                   "harness.cpp", "f32", mutant=(F32_PASSES, F32_ONE_PASS))
    errs, _ = _pipeline_errors(exe, tmp_path, "f32", "color_neus")
    worst = max(e for name, (e, _) in errs.items() if name.startswith("sdf layer"))
    print(f"f32 with hi Hi alone: worst SDF leaf {worst:.3e} from the twin")
    assert worst > RTOL_F32, errs


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_split3_is_exact_and_bf16(scale):
    """split3's parts sum to w exactly on random normal f32 values (over
    many binades) and each part is bf16-representable."""
    g = torch.Generator().manual_seed(7)
    w = torch.randn(20000, generator=g) * scale * torch.exp2(
        torch.randint(-20, 21, (20000,), generator=g).float())
    assert bool((w.abs() >= torch.finfo(torch.float32).tiny).all())
    parts = PP.split3(w)
    total = sum(p.double() for p in parts)
    assert torch.equal(total, w.double())
    for p in parts:
        assert p.dtype == torch.float32
        assert torch.equal(p.to(torch.bfloat16).float(), p)
    hi, mid, lo = parts
    assert bool((mid.abs() <= 2.0 ** -8 * hi.abs()).all())
    assert bool((lo.abs() <= 2.0 ** -8 * mid.abs()).all())


def test_f32_images_hold_three_parts():
    """In 'f32' every SDF slot's image (forward and reverse; the
    features' too) is one slab a k16 step of its product: row n of step
    s's slab holds split3's hi, mid and lo of the weights' k 16 s .. 16 s
    + 16 (exact in bf16, summing to the weights:
    test_split3_is_exact_and_bf16) at 32-byte offsets, in the 128-byte
    swizzle, then zeros; the colour and relight slots are the f32stash
    images unchanged."""
    pw, *_ = EP._case("color_neus", {})
    images = {m: PP._pack_images(_in_mode(pw, m)) for m in ("f32stash", "f32")}
    _, wide = PP._layout(pw)
    slab = PP.SLAB_ROWS * PP.SLAB_K
    for w_slot, wt_slot, wp in wide:
        for slot, mat in ((w_slot, wp.T), (wt_slot, wp)):
            n = PP._slabs(mat.float()).numel() // slab
            if PP._is_sdf_slot(w_slot):
                rows, depth = mat.shape
                chunks, steps = -(-rows // PP.SLAB_ROWS), depth // 16
                o = int(images["f32"][1][slot]) * slab
                got = images["f32"][0][o:o + chunks * steps * slab].reshape(
                    chunks, steps, PP.SLAB_ROWS, 8, 8).float()
                # undo the swizzle: row r's 16-byte chunk c sits at c ^ (r % 8)
                r = torch.arange(PP.SLAB_ROWS)
                c = torch.arange(8)[None, :] ^ (r % 8)[:, None]
                plain = torch.empty_like(got)
                plain[:, :, r[:, None], c] = got
                plain = plain.permute(0, 2, 1, 3, 4).reshape(chunks * PP.SLAB_ROWS, steps,
                                                             64)[:rows]
                for p, part in enumerate(PP.split3(mat)):
                    assert torch.equal(plain[:, :, 16 * p:16 * p + 16],
                                       part.reshape(rows, steps, 16))
                assert float(plain[:, :, 48:].abs().max()) == 0.0
            else:
                o32, o = (int(images[m][1][slot]) * slab for m in ("f32", "f32stash"))
                assert torch.equal(images["f32"][0][o32:o32 + n * slab],
                                   images["f32stash"][0][o:o + n * slab])
