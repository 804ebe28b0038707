"""The tensor cores' truncation on the CPU: the six-pass f32 products of
row 7's f32 chain (csrc/mlp_chain.cu chain_f32_kernel) and of row 5's
MARCH_BWD_PRECISION f32 entry (csrc/point_pipeline_tile.cuh hp_product),
each compiled against tests/cuda_emu/cuda_runtime.h with
EMU_WGMMA_TRUNCATE (the software wgmma sums an instruction exactly and
rounds it to f32 toward zero once, as the card's tensor cores truncate:
chip_smoke.py phase 9 reads the card against that model) and held against
float64.

Both kernels sum each k16 step's six bf16 passes in a fresh accumulator
and nudge the sum half an ulp (mlp::unbias_truncated) before it joins the
f32 total, so that the truncation leaves no bias in expectation. Held,
as chip_smoke.py phase 9 holds the card (chain_error_stats,
chain_bias_limit): the signed error toward |float64|, (y - r) sign(r)
over r's RMS, of each chain layer (3 layers of 512 rows, each on the
float64 chain's previous output rounded to f32) and of row 5's SDF
features (the last SDF layer's 256 outputs of 256 points); its mean
within F32_BIAS_FACTOR x the plain f32 twin's largest (PyTorch's f32
matmul, round to nearest), the twin's mean floored at CHAIN_SE_FLOOR of
its standard errors and CHAIN_RMS_FLOOR of its RMS (unbiased, it reads
its own noise); its RMS within F32_BIAS_FACTOR x the twin's. Read: the
chain's layers |mean| <= 2.1e-9 against limits of 5.7e-9 (softplus) and
5.8e-9 (none), RMS 0.32-0.44x the twin's; without the nudge -3.4e-8 a
layer; row 5's features -2.2e-8 against a limit of 1.6e-7 (the twin reads
-7.8e-8, 70 standard errors: its bias, not noise), -3.1e-7 without the
nudge.
Mutants that must fail: each kernel without the nudge (a step's truncated
sum added as it is). Skips without a C++20 compiler."""

import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from chip_smoke import F32_BIAS_FACTOR, chain_bias_limit, chain_error_stats
from color_neus_torch.ops.kernels import mlp_chain as MC
from color_neus_torch.ops.kernels import point_pipeline as PP
from tests import test_torch_bwd_precision_emulated as BP
from tests import test_torch_mlp_chain_emulated as EC
from tests import test_torch_point_pipeline_emulated as EP

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "color_neus_torch", "csrc")
TRUNCATE = "EMU_WGMMA_TRUNCATE"
ROWS, LAYERS = 512, 3
POINTS, BLOCKS = 256, 2
# the nudge of each kernel's step sums, and the same sum added as it is
CHAIN_UNNUDGED = ("tot[c][i] += mlp::unbias_truncated_ffma(acc[i]);", "tot[c][i] += acc[i];")
PIPELINE_UNNUDGED = ("tot[i] += unbias_truncated(acc[i]);", "tot[i] += acc[i];")


def _compile_chain(out, mutant=None):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the emulated kernels")
    with open(os.path.join(CSRC, "mlp_chain.cu")) as f:
        src = re.sub(r"<<<.*?>>>", "", f.read(), flags=re.S)
    if mutant is not None:
        assert src.count(mutant[0]) == 1, "the chain mutant's line moved"
        src = src.replace(*mutant)
    with open(os.path.join(HERE, "cuda_emu", "harness_chain.cpp")) as f:
        src += f.read()
    path = out / "emu.cpp"
    path.write_text(src)
    exe = str(out / "emu")
    proc = subprocess.run([cxx, "-std=c++20", "-O2", "-pthread", "-Wno-unknown-pragmas",
                           f"-D{TRUNCATE}", "-I", os.path.join(HERE, "cuda_emu"), "-I", CSRC,
                           "-x", "c++", str(path), "-o", exe], capture_output=True, text=True)
    if proc.returncode != 0 and "barrier" in proc.stderr:
        pytest.skip("the host compiler lacks C++20 <barrier>")
    assert proc.returncode == 0, proc.stderr
    return exe


@pytest.fixture(scope="module")
def chain_emulator(tmp_path_factory):
    return _compile_chain(tmp_path_factory.mktemp("emu_chain_truncate"))


def _bias_failures(records) -> list:
    """records: [(label, kernel stats, twin stats)]; what breaks the gate."""
    bias = chain_bias_limit([t for _, _, t in records])
    bad = []
    for label, k, t in records:
        print(f"{label}: mean {k['mean']:.3e} (twin {t['mean']:.3e}, se {t['se']:.1e}; limit "
              f"{bias:.2e}) | RMS {k['rms']:.3e} (twin {t['rms']:.3e})")
        if abs(k["mean"]) > bias:
            bad.append(f"{label}: mean signed error {k['mean']:.3e} above {bias:.3e}")
        if k["rms"] > F32_BIAS_FACTOR * t["rms"]:
            bad.append(f"{label}: RMS error {k['rms']:.3e} above {F32_BIAS_FACTOR:g}x the "
                       f"twin's {t['rms']:.3e}")
    return bad


def _chain_records(exe, tmp_path, act):
    """Per layer l = 1 .. LAYERS, as phase 9 holds the card: the emulated
    chain's layer (an L = 1 run) and the plain f32 twin's on the float64
    chain's previous output rounded to f32, against float64."""
    x, w = EC._inputs(300 + MC.act_id(act), ROWS)
    wt = torch.from_numpy(w)
    r, records = torch.from_numpy(x).double(), []
    for layer in range(1, LAYERS + 1):
        xin = r.float()
        out, _ = EC._run(exe, tmp_path, xin.numpy(), w, MC.act_id(act), 1.0,
                         EC.probe_values()[:8], layers=1)
        ref = MC.chain_plain(xin.double(), wt.double(), 1, act, bf16=False, gate_w=1.0)
        twin = MC.chain_plain(xin, wt, 1, act, bf16=False, gate_w=1.0)
        records.append((f"{act} layer {layer}", chain_error_stats(torch.from_numpy(out), ref),
                        chain_error_stats(twin, ref)))
        r = MC.chain_plain(r, wt.double(), 1, act, bf16=False, gate_w=1.0)
    return records


@pytest.mark.parametrize("act", ["none", "softplus"])
def test_emulated_f32_chain_unbiased_under_truncation(chain_emulator, tmp_path, act):
    bad = _bias_failures(_chain_records(chain_emulator, tmp_path, act))
    assert not bad, bad


def test_emulated_f32_chain_unnudged_mutant_fails(tmp_path_factory, tmp_path):
    exe = _compile_chain(tmp_path_factory.mktemp("emu_chain_unnudged"), CHAIN_UNNUDGED)
    bad = _bias_failures(_chain_records(exe, tmp_path, "none"))
    assert any("mean" in b for b in bad), "the chain without its nudge kept the gate"


def _pipeline_records(exe, tmp_path):
    """Row 5's f32 entry (the emulated forward's SDF features, from its
    scratch) and the plain f32 twin's against the float64 twin's."""
    pw, pts, dirs, _, gbar = EP._case("color_neus", {}, n=POINTS)
    pw = BP._in_mode(pw, "f32")
    EP._run(exe, tmp_path, pw, pts, dirs, gbar, blocks=BLOCKS)
    i = np.arange(POINTS)
    feat = BP.kernel_features(tmp_path, BLOCKS, len(pw.sdf),
                              ((i // BP.FWD_ROWS) % BLOCKS, i % BP.FWD_ROWS))
    pw64 = PP.PipelineWeights(pw.rcfg, *[[(w.double(), b.double()) for w, b in layers]
                                         for layers in (pw.sdf, pw.color, pw.relight)])
    ref = BP.twin_sdf_outputs(pw64, pts.double(), dirs.double())[1]
    twin = BP.twin_sdf_outputs(pw, pts, dirs)[1]
    return [("row 5 f32 features", chain_error_stats(feat, ref), chain_error_stats(twin, ref))]


def test_emulated_row5_f32_unbiased_under_truncation(tmp_path_factory, tmp_path):
    exe = BP._compile(tmp_path_factory.mktemp("emu_pp_f32_truncate"), "point_pipeline",
                      "harness.cpp", "f32", defines=(TRUNCATE,))
    bad = _bias_failures(_pipeline_records(exe, tmp_path))
    assert not bad, bad


def test_emulated_row5_f32_unnudged_mutant_fails(tmp_path_factory, tmp_path):
    exe = BP._compile(tmp_path_factory.mktemp("emu_pp_f32_unnudged"), "point_pipeline",
                      "harness.cpp", "f32", mutant=PIPELINE_UNNUDGED,
                      defines=(TRUNCATE,))
    bad = _bias_failures(_pipeline_records(exe, tmp_path))
    assert any("mean" in b for b in bad), "row 5 without its nudge kept the gate"
