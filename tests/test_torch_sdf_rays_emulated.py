"""The CUDA source of the SDF sweep and the grid SDF (csrc/sdf_rays.cu:
rows 1 and 2), compiled for the CPU and held against their plain PyTorch
twins at full width.

As tests/test_torch_point_pipeline_emulated.py does for rows 5 and 6: the
source runs through a host C++ compiler against tests/cuda_emu/cuda_runtime.h,
a block's CUDA threads as fibers with a barrier for __syncthreads, a software
mma.sync, and the weight ring's bulk copies as a memcpy beside a counting
mbarrier (tests/cuda_emu/harness_sdf.cpp). It runs both entries (the sweep
and the points), both dot types (and the grid's f32x3), softplus and relu, on
130 points, the last tile ragged, on a full-width SDF (8 x 256, multires 6)
off its geometric init, and one case whose layer-0 pre-activations sit in
0.87 < |x| < 1.04, where log1p(exp(-100|x|)) is denormal (the divide's
slow path on the card). It checks the arithmetic, the fragment layouts,
the ring's stages and barriers, the packing and the tail; it cannot see
what only the card shows (timing, races between warps, the TMA unit, the
GPU's own float functions), which tests/test_torch_cuda.py and
chip_smoke.py check there. Skips without a C++20 compiler.

Tolerances: the card's (chip_smoke.ATOL and ATOL_GRID): f32 2e-6, the
summation order (and here glibc's expf / log1pf against PyTorch's); bf16
3e-3 (sweep) / 6e-3 (grid), a layer input within rounding of a bf16
midpoint rounding to the other neighbour after another f32 summation
order; f32x3 4e-5 (ATOL_GRID: the split's own ~2^-16 error, which another
summation order sets anew, test_torch_mesh.py; read 3.8e-6 here). Copies of the source that
read a stale stage of the ring, that swap the epilogue's fragment columns 2t
and 2t + 1, or that drop f32x3's lo.hi product, must fail."""

import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from chip_smoke import ATOL, ATOL_GRID
from color_neus_torch import pin_precision
from color_neus_torch.models.configs import SDFConfig
from color_neus_torch.models.fields import init_sdf
from color_neus_torch.ops.kernels import sdf_rays as K

pin_precision()

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "color_neus_torch", "csrc")
N_PTS = 130                       # 2 bf16 tiles of 128 (3 f32 tiles of 64), the last one ragged
SWEEP_R, SWEEP_S = 10, 13         # 130 samples
# the ring's stage of slab s (ring_acquire); the mutant reads the next stage
RING_STAGE = "return buf + (s % STAGES) * BYTES;"
RING_STAGE_MUTANT = "return buf + ((s + 1) % STAGES) * BYTES;"
# the bf16 epilogue's columns 2t, 2t + 1 of accumulator pair h; the mutant
# swaps them. (Swapping its rows g and g + 8 instead permutes the points the
# same way at every layer, which 8 hidden layers undo: no check can see it.)
EPI_COLS = ("const float v0 = activate<RELU>(acc[i][j][2 * h] + b0) * post;\n"
            "          const float v1 = activate<RELU>(acc[i][j][2 * h + 1] + b1) * post;")
EPI_COLS_MUTANT = ("const float v0 = activate<RELU>(acc[i][j][2 * h + 1] + b0) * post;\n"
                   "          const float v1 = activate<RELU>(acc[i][j][2 * h] + b1) * post;")
# the f32x3 tile's lo-part product against the hi weights; the mutant
# drops it (what is left is hi.hi + hi.lo: ~2^-9 relative off)
X3_LO_PRODUCT = "mlp::mma_bf16(acc[i][j], al[0], al[1], al[2], al[3], b[j].x, b[j].y);"
X3_LO_PRODUCT_MUTANT = "(void)al;"
# sdf_points_launch's mode of each SweepWeights.dtype
MODE = {"float32": 0, "bfloat16": 1, "f32x3": 2}


def _compile(out, mutate=None):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the emulated kernels")
    with open(os.path.join(CSRC, "sdf_rays.cu")) as f:
        src = re.sub(r"<<<.*?>>>", "", f.read(), flags=re.S)   # launches run on host threads
    if mutate is not None:
        assert src.count(mutate[0]) == 1, f"mutation site moved: {mutate[0]}"
        src = src.replace(*mutate)
    with open(os.path.join(HERE, "cuda_emu", "harness_sdf.cpp")) as f:
        src += f.read()
    path = out / "emu.cpp"
    path.write_text(src)
    exe = str(out / "emu")
    proc = subprocess.run([cxx, "-std=c++20", "-O1", "-pthread", "-fno-strict-aliasing",
                           "-Wno-unknown-pragmas", "-I", os.path.join(HERE, "cuda_emu"),
                           "-I", CSRC, "-x", "c++", str(path), "-o", exe],
                          capture_output=True, text=True)
    if proc.returncode != 0 and "barrier" in proc.stderr:
        pytest.skip("the host compiler lacks C++20 <barrier>")
    assert proc.returncode == 0, proc.stderr
    return exe


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    return _compile(tmp_path_factory.mktemp("cuda_emu_sdf"))


def _params(seed):
    """A full-width SDF off its geometric init: seeded numpy noise on every
    leaf (geometric init zeroes the PE columns of lin0 and the skip layer)."""
    cfg = SDFConfig()
    p = init_sdf(cfg, torch.Generator().manual_seed(seed), "cpu")
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for leaf in p.parameters():
            leaf.add_(torch.from_numpy((0.02 * rng.randn(*leaf.shape)).astype(np.float32)))
    return p, cfg


def _weights(dtype, act, seed=0, band=False):
    p, cfg = _params(seed)
    sw = K.resolve_sweep_weights(p, cfg, dtype, act)
    if band:
        # layer 0's pre-activations into 0.87 < |x| < 1.04 (both signs)
        rng = np.random.RandomState(seed + 1)
        w0, b0 = sw.layers[0]
        mag = rng.uniform(0.88, 1.03, b0.shape) * np.where(rng.rand(*b0.shape) < 0.5, -1, 1)
        sw.layers[0] = (1e-3 * w0, torch.from_numpy(mag.astype(np.float32)))
    return sw


def _sweep_inputs(seed):
    rng = np.random.RandomState(seed)
    d = rng.randn(SWEEP_R, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = (-2.2 * d + 0.1 * rng.randn(SWEEP_R, 3)).astype(np.float32)
    z = np.sort(rng.uniform(1.0, 3.4, (SWEEP_R, SWEEP_S)), axis=1).astype(np.float32)
    return o, d, z


def _points(seed):
    # out to |p| ~ 1.8, the main path's reach
    return np.random.RandomState(seed).uniform(-1.05, 1.05, (N_PTS, 3)).astype(np.float32)


def _run(exe, d, sw, points, seed=3):
    """(kernel, plain twin) outputs of one emulated launch."""
    packed, bias = K.pack_sdf_weights(sw.layers, sw.cfg, sw.dtype)
    d0, skip, n_lin = K._check_kernel_shape(sw.cfg)
    bf16 = sw.dtype != "float32"
    (packed.view(torch.int16) if bf16 else packed).numpy().tofile(d / "w.bin")
    bias.numpy().tofile(d / "bias.f32")
    np.asarray([sw.cfg.scale], np.float32).tofile(d / "f32.f32")
    if points:
        pts = _points(seed)
        pts.tofile(d / "pts.f32")
        S = 1
        want = K.sdf_mlp_plain(sw, torch.from_numpy(pts))
    else:
        o, dd, z = _sweep_inputs(seed)
        for name, t in (("rays_o", o), ("rays_d", dd), ("z", z)):
            t.tofile(d / f"{name}.f32")
        S = SWEEP_S
        want = K.sdf_rays_plain(sw, *map(torch.from_numpy, (o, dd, z))).reshape(-1)
    meta = [N_PTS, S, n_lin, skip, d0, MODE[sw.dtype], int(sw.act == "relu"), int(points)]
    np.asarray(meta, np.int64).tofile(d / "meta.i64")
    subprocess.run([exe, str(d)], check=True, timeout=300)
    got = np.fromfile(d / "out.f32", np.float32)
    return got, want.numpy()


def _atol(sw, points):
    if points:
        return ATOL_GRID[{"bfloat16": "bf16", "float32": "f32", "f32x3": "f32x3"}[sw.dtype]]
    return ATOL[sw.dtype]


# (entry, dtype, act)
CASES = [("sweep", "bfloat16", "softplus"), ("sweep", "bfloat16", "relu"),
         ("sweep", "float32", "softplus"), ("sweep", "float32", "relu"),
         ("points", "bfloat16", "softplus"), ("points", "float32", "softplus"),
         ("points", "f32x3", "softplus")]


@pytest.mark.parametrize("entry,dtype,act", CASES, ids=["-".join(c) for c in CASES])
def test_emulated_sdf_matches_plain(emulator, tmp_path, entry, dtype, act):
    sw = _weights(dtype, act)
    points = entry == "points"
    got, want = _run(emulator, tmp_path, sw, points)
    assert np.isfinite(got).all() and np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, rtol=0, atol=_atol(sw, points))


@pytest.mark.parametrize("entry", ["sweep", "points"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_emulated_sdf_denormal_band(emulator, tmp_path, dtype, entry):
    """Layer-0 pre-activations in the band where exp(-100|x|) is denormal."""
    sw = _weights(dtype, "softplus", band=True)
    points = entry == "points"
    if points:
        pts = torch.from_numpy(_points(3))
    else:
        o, d, z = map(torch.from_numpy, _sweep_inputs(3))
        pts = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3)
    w0, b0 = sw.layers[0]
    from color_neus_torch.ops.embedding import positional_encoding
    pre = (positional_encoding(pts * sw.cfg.scale, sw.cfg.multires) @ w0 + b0).abs()
    assert float(((pre > 0.873) & (pre < 1.04)).float().mean()) > 0.9
    assert bool((torch.exp(-100.0 * pre) < np.finfo(np.float32).tiny).any())
    got, want = _run(emulator, tmp_path, sw, points)
    np.testing.assert_allclose(got, want, rtol=0, atol=_atol(sw, points))


@pytest.mark.parametrize("mutation,dtype", [((RING_STAGE, RING_STAGE_MUTANT), "bfloat16"),
                                            ((EPI_COLS, EPI_COLS_MUTANT), "bfloat16"),
                                            ((X3_LO_PRODUCT, X3_LO_PRODUCT_MUTANT), "f32x3")],
                         ids=["stale-stage", "epilogue-columns", "f32x3-lo-product"])
def test_emulated_sdf_mutants_fail(tmp_path, mutation, dtype):
    exe = _compile(tmp_path, mutate=mutation)
    sw = _weights(dtype, "softplus")
    got, want = _run(exe, tmp_path, sw, points=True)
    assert np.abs(got - want).max() > 10 * _atol(sw, True)
