"""The CUDA source of the point-pipeline kernels (csrc/point_pipeline.cu:
rows 5 and 6, forward and backward), compiled for the CPU and held
against their plain PyTorch versions at full width.

The kernels run on the card only; this test runs the same source through
a host C++ compiler against tests/cuda_emu/cuda_runtime.h, a block's CUDA
threads as fibers with a barrier for __syncthreads, a software mma.sync (the
forward and the recompute), a software wgmma that decodes the K-major
128-byte-swizzled descriptors and takes A from shared memory or from
registers (the backward's products and its weight-grad flush), and bulk
copies as memcpy plus a real counting mbarrier (tests/cuda_emu/harness.cpp),
on 130 points over 2 blocks with a ragged last tile, at 2 tiles a
weight-grad batch. test_emulated_full_and_ragged_batch runs 300 points (5
tiles) over 2 blocks, so that one block flushes a full batch and then a
ragged one. It checks the kernels' arithmetic, the fragment and
descriptor layouts, indexing, packing (_pack, _pack_images), the batched
weight-grad store and flush and the per-block partials; it cannot see
what only the card shows (timing, races between warps and with the async
copies, the GPU's own float functions), which tests/test_torch_cuda.py
and chip_smoke.py check there. Skips without a C++20 compiler.

The kernels compute the TPU kernels' bf16 products, so they are held
against the plain twins with bf16=True: every output and leaf within
RTOL_BF16 x its largest |plain| (a layer input within rounding of a bf16
midpoint rounds to the other neighbour after another f32 summation order,
one bf16 ulp of that input, and such flips propagate: read <= 5.7e-4),
with the cotangents of points near a relu kink zeroed. Where the bf16 twin
is more than 1e-2 from the f32 twin, the kernel must be within a tenth of
that gap of the bf16 twin: it computes the bf16 arithmetic, not f32.
Copies of the source that must fail: the A fragment's row halves swapped
(load_a, which feeds the forward's mma.sync and the backward's register-A
wgmma), the ragged batch's flush skipped, and the weight-grad operand
stored with its swizzle phase one row off."""

import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from chip_smoke import KINK_MARGIN, relu_margin
from color_neus_torch import pin_precision
from color_neus_torch.models.configs import ColorConfig, RelightConfig, RendererConfig
from color_neus_torch.models.neus import init_renderer
from color_neus_torch.ops.kernels import point_pipeline as PP

pin_precision()

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "color_neus_torch", "csrc")
OUTPUTS = ("sdf", "grad", "gc", "relit", "delta")
RTOL_BF16 = 2e-3
# load_a's A fragment (csrc/point_pipeline_tile.cuh): a0 / a2 from rows g,
# a1 / a3 from rows g + 8; the mutant swaps the two row halves
A_ROWS = "const float* r0 = A + (m0 + g) * lda + k0 + 2 * t;\n  const float* r8 = r0 + 8 * lda;"
A_ROWS_MUTANT = "const float* r8 = A + (m0 + g) * lda + k0 + 2 * t;\n  const float* r0 = r8 + 8 * lda;"
# the weight-grad batch (csrc/point_pipeline_tile.cuh): after_tile flushes
# a full batch or the block's last, ragged one; the mutant never flushes a
# ragged batch
FLUSH = "if (++slot < p.dw_batch && !last) return slot;"
FLUSH_MUTANT = "if (++slot < p.dw_batch) return slot;"
# save_t's transposed bf16 store of a weight-grad operand: row c's 16-byte
# chunk XORed by c % 8; the mutant writes row c with row c + 1's phase
STORE = "dst + mlp::sw128_offset(c, 2 * pr)"
STORE_MUTANT = "dst + mlp::sw128_offset(c + 1, 2 * pr) - 128u"
MUTANTS = {"rows": (A_ROWS, A_ROWS_MUTANT), "flush": (FLUSH, FLUSH_MUTANT),
           "store": (STORE, STORE_MUTANT)}


def _compile(out, mutate=None):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the emulated kernels")
    with open(os.path.join(CSRC, "point_pipeline.cu")) as f:
        src = re.sub(r"<<<.*?>>>", "", f.read(), flags=re.S)   # launches run on host threads
    with open(os.path.join(CSRC, "point_pipeline_tile.cuh")) as f:
        tile = f.read()
    if mutate:
        line, mutant = MUTANTS[mutate]
        assert tile.count(line) == 1, f"the {mutate} mutant's line moved"
        tile = tile.replace(line, mutant)
    # the tile header inlined, so that the mutant's copy is the one compiled
    src = src.replace('#include "point_pipeline_tile.cuh"', tile)
    with open(os.path.join(HERE, "cuda_emu", "harness.cpp")) as f:
        src += f.read()
    path = out / "emu.cpp"
    path.write_text(src)
    exe = str(out / "emu")
    proc = subprocess.run([cxx, "-std=c++20", "-O2", "-pthread", "-Wno-unknown-pragmas",
                           "-I", os.path.join(HERE, "cuda_emu"), "-I", CSRC, "-x", "c++",
                           str(path), "-o", exe], capture_output=True, text=True)
    if proc.returncode != 0 and "barrier" in proc.stderr:
        pytest.skip("the host compiler lacks C++20 <barrier>")
    assert proc.returncode == 0, proc.stderr
    return exe


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    return _compile(tmp_path_factory.mktemp("cuda_emu"))


def _run(exe, tmp_path, pw, pts, dirs, gbar, blocks, batch=2, images=None):
    """The emulated forward and backward: (out [n, 16], pts_hat, dirs_hat,
    {net: [(dW, db)]}). images: (img, ioff) in place of _pack_images'."""
    packed, off, n_grad = PP._pack(pw)
    img, ioff = images or PP._pack_images(pw)
    rcfg = pw.rcfg
    d0, skip, n_sdf = PP._check_kernel_shape(rcfg)
    cn = rcfg.kind == "color_neus"
    meta = [pts.shape[0], n_sdf, skip, d0, len(pw.color), PP._color_dv(rcfg),
            int(rcfg.color.squeeze_out), len(pw.relight), PP._relight_dv(rcfg) if cn else 0,
            rcfg.relight.y_in_layer if cn else -1, int(rcfg.relight.inv_sigmoid), n_grad, blocks,
            batch]
    np.asarray(meta, np.int64).tofile(tmp_path / "meta.i64")
    np.asarray([rcfg.sdf.scale], np.float32).tofile(tmp_path / "scale.f32")
    off.astype(np.int64).tofile(tmp_path / "off.i64")
    ioff.astype(np.int64).tofile(tmp_path / "ioff.i64")
    img.view(torch.int16).numpy().tofile(tmp_path / "img.bf16")
    for name, t in (("w", packed), ("pts", pts), ("dirs", dirs), ("gbar", gbar)):
        t.numpy().astype(np.float32).tofile(tmp_path / f"{name}.f32")
    subprocess.run([exe, str(tmp_path)], check=True, timeout=300)

    def read(name, *shape):
        return torch.from_numpy(np.fromfile(tmp_path / f"{name}.f32", np.float32).reshape(shape))
    pw.off = off
    n = pts.shape[0]
    grads = PP._unpack_grads(pw, read("grad", n_grad))
    return read("out", n, 16), read("pts_hat", n, 3), read("dirs_hat", n, 3), grads


def _rel(got, want) -> float:
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-6)


def _errors(kernel, bf16, f32):
    """{name: (kernel vs the bf16 twin, the bf16 twin vs the f32 twin)} over
    the outputs, pts, dirs and every leaf; each argument (out [n, 16],
    pts_hat, dirs_hat, {net: [(dW, db)]})."""
    errs = {}
    for i, name in enumerate(OUTPUTS):
        a, b = (0, 1, 4, 7, 10, 13)[i:i + 2]
        errs[name] = (_rel(kernel[0][:, a:b], bf16[0][:, a:b]),
                      _rel(bf16[0][:, a:b], f32[0][:, a:b]))
    for i, name in ((1, "pts"), (2, "dirs")):
        errs[name] = (_rel(kernel[i], bf16[i]), _rel(bf16[i], f32[i]))
    for net, layers in bf16[3].items():
        assert len(kernel[3][net]) == len(layers)
        for l, (k, b, f) in enumerate(zip(kernel[3][net], layers, f32[3][net])):
            for j, what in enumerate("Wb"):
                errs[f"{net} layer {l} {what}"] = (_rel(k[j], b[j]), _rel(b[j], f[j]))
    return errs


def _case(kind, relight, n=130):
    color = (ColorConfig(mode="no_view_dir", d_in=6, multires_view=0) if kind == "color_neus"
             else ColorConfig())
    rcfg = RendererConfig(kind=kind, color=color, relight=RelightConfig(**relight))
    g = torch.Generator().manual_seed(0)
    params = init_renderer(rcfg, g)
    with torch.no_grad():
        for p in params.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g))
    pw = PP.resolve_pipeline_weights(params, rcfg)
    pts = (0.6 * torch.randn((n, 3), generator=g)).contiguous()
    dirs = torch.randn((n, 3), generator=g)
    dirs = (dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)).contiguous()
    # points within rounding of a relu kink flip their mask between two f32
    # paths: their cotangents are zeroed, as chip_smoke.py phase 2c does
    pw64 = PP.PipelineWeights(rcfg, *[[(w.double(), b.double()) for w, b in layers]
                                      for layers in (pw.sdf, pw.color, pw.relight)])
    keep = (relu_margin(pw64, pts.double(), dirs.double()) > KINK_MARGIN).float()
    cots = [torch.randn((n, k), generator=g) * keep[:, None] for k in (1, 3, 3, 3, 3)]
    gbar = torch.cat(cots + [torch.zeros((n, 3))], dim=1).contiguous()
    return pw, pts, dirs, cots, gbar


def _plain(pw, pts, dirs, cots, bf16):
    return (torch.cat(PP.point_pipeline_plain(pw, pts, dirs, bf16), dim=1),
            *PP.point_pipeline_bwd_plain(pw, pts, dirs, cots, bf16))


@pytest.mark.parametrize("kind,relight", [
    ("color_neus", {}), ("color_neus", {"inv_sigmoid": False, "include_grad": False,
                                        "y_in_layer": 4}),
    ("neus", {})], ids=["color_neus", "color_neus-clip-nograd-ylast", "neus-idr"])
def test_emulated_kernels_match_plain(emulator, tmp_path, kind, relight):
    pw, pts, dirs, cots, gbar = _case(kind, relight)
    kernel = _run(emulator, tmp_path, pw, pts, dirs, gbar, blocks=2)
    errs = _errors(kernel, _plain(pw, pts, dirs, cots, True), _plain(pw, pts, dirs, cots, False))
    for name, (err, gap) in errs.items():
        assert err <= RTOL_BF16, f"{name}: {err:.3e} from the bf16 twin, above {RTOL_BF16:g}"
        assert gap <= 1e-2 or err < 0.1 * gap, \
            f"{name}: {err:.3e} from the bf16 twin, not below a tenth of its f32 gap {gap:.3e}"


def test_emulated_fragment_rows_mutant_fails(tmp_path_factory, tmp_path):
    """A copy of the source whose A fragments take their two row halves in
    the wrong registers runs, and is far off the bf16 twin."""
    mutant = _compile(tmp_path_factory.mktemp("cuda_emu_rows_mutant"), mutate="rows")
    pw, pts, dirs, cots, gbar = _case("neus", {})
    kernel = _run(mutant, tmp_path, pw, pts, dirs, gbar, blocks=2)
    errs = _errors(kernel, _plain(pw, pts, dirs, cots, True), _plain(pw, pts, dirs, cots, False))
    assert max(e for e, _ in errs.values()) > 0.5, errs


def test_emulated_full_and_ragged_batch(emulator, tmp_path):
    """The weight-grad batch: 300 points are 5 tiles (the last one of 44
    points) over 2 blocks at 2 tiles a batch, so block 0 flushes a full
    batch (tiles 0, 2) and then a ragged one (tile 4), block 1 one full
    batch (tiles 1, 3); held as test_emulated_kernels_match_plain holds
    the 130-point cases."""
    pw, pts, dirs, cots, gbar = _case("color_neus", {}, n=300)
    kernel = _run(emulator, tmp_path, pw, pts, dirs, gbar, blocks=2, batch=2)
    errs = _errors(kernel, _plain(pw, pts, dirs, cots, True), _plain(pw, pts, dirs, cots, False))
    for name, (err, gap) in errs.items():
        assert err <= RTOL_BF16, f"{name}: {err:.3e} from the bf16 twin, above {RTOL_BF16:g}"
        assert gap <= 1e-2 or err < 0.1 * gap, \
            f"{name}: {err:.3e} from the bf16 twin, not below a tenth of its f32 gap {gap:.3e}"


@pytest.mark.parametrize("mutate", ["flush", "store"])
def test_emulated_batch_mutants_fail(tmp_path_factory, tmp_path, mutate):
    """Copies of the source that skip the ragged batch's flush, or store
    the weight-grad operands with the swizzle phase off by one row, run on
    the full-and-ragged case and are far off the bf16 twin in the weight
    leaves."""
    mutant = _compile(tmp_path_factory.mktemp(f"cuda_emu_{mutate}_mutant"), mutate=mutate)
    pw, pts, dirs, cots, gbar = _case("color_neus", {}, n=300)
    kernel = _run(mutant, tmp_path, pw, pts, dirs, gbar, blocks=2, batch=2)
    errs = _errors(kernel, _plain(pw, pts, dirs, cots, True), _plain(pw, pts, dirs, cots, False))
    worst = max(e for name, (e, _) in errs.items() if " layer " in name)
    assert worst > 0.1, errs


def test_emulated_forward_ragged_tiles(emulator, tmp_path):
    """The forward kernel's 128-point tiles: 257 points are tiles of 128,
    128 and 1 point over 2 blocks, so block 0 runs a full tile and then a
    one-point tile through the same weight ring (the backward: 5 tiles of
    64, the last of 1 point); held as test_emulated_kernels_match_plain
    holds the 130-point cases."""
    pw, pts, dirs, cots, gbar = _case("color_neus", {"inv_sigmoid": False}, n=257)
    kernel = _run(emulator, tmp_path, pw, pts, dirs, gbar, blocks=2)
    errs = _errors(kernel, _plain(pw, pts, dirs, cots, True), _plain(pw, pts, dirs, cots, False))
    for name, (err, gap) in errs.items():
        assert err <= RTOL_BF16, f"{name}: {err:.3e} from the bf16 twin, above {RTOL_BF16:g}"
        assert gap <= 1e-2 or err < 0.1 * gap, \
            f"{name}: {err:.3e} from the bf16 twin, not below a tenth of its f32 gap {gap:.3e}"


def test_emulated_forward_slab_orientation_mutant_fails(emulator, tmp_path):
    """Colour layer 1's forward image packed in its reverse orientation
    (rows its 256 inputs, depth its outputs: the transpose of what the
    forward product reads) runs, and is off the bf16 twin in gc and relit
    by well over the tolerance (the squeeze's sigmoid compresses them)
    and in the colour layers' weight grads by their own size (the
    backward's recompute reads the same image)."""
    pw, pts, dirs, cots, gbar = _case("color_neus", {})
    img, ioff = PP._pack_images(pw)
    wp = next(wp for w_slot, _, wp in PP._layout(pw)[1] if w_slot == PP.W_COL + 1)
    rev = PP._slabs(wp.float())
    start = int(ioff[PP.W_COL + 1]) * PP.SLAB_ROWS * PP.SLAB_K
    img = img.clone()
    img[start:start + rev.numel()] = rev
    kernel = _run(emulator, tmp_path, pw, pts, dirs, gbar, blocks=2, images=(img, ioff))
    errs = _errors(kernel, _plain(pw, pts, dirs, cots, True), _plain(pw, pts, dirs, cots, False))
    assert min(errs["gc"][0], errs["relit"][0]) > 5 * RTOL_BF16, errs
    assert min(errs[f"color layer {l} W"][0] for l in range(3)) > 0.5, errs
