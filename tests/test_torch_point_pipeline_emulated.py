"""The CUDA source of the point-pipeline kernels (csrc/point_pipeline.cu:
rows 5 and 6, forward and backward), compiled for the CPU and held
against their plain PyTorch versions at full width.

The kernels run on the card only; this test runs the same source through
a host C++ compiler against tests/cuda_emu/cuda_runtime.h, one std::thread
per CUDA thread with a barrier for __syncthreads (tests/cuda_emu/
harness.cpp), on 130 points over 2 blocks with a ragged last tile. It
checks the kernels' arithmetic, indexing, packing and the per-block
weight-grad partials; it cannot see what only the card shows (timing,
races between warps, the GPU's own float functions), which
tests/test_torch_cuda.py and chip_smoke.py check there. Skips without a
C++20 compiler. Tolerances: the forward as tests/test_torch_point_pipeline
(f32 summation order); the backward 1e-5 x the largest |plain| of an
output or leaf, with the cotangents of points near a relu kink zeroed."""

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
FWD_ATOL = {"sdf": 1e-6, "grad": 1e-5, "gc": 1e-6, "relit": 1e-6, "delta": 1e-6}


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the emulated kernels")
    out = tmp_path_factory.mktemp("cuda_emu")
    with open(os.path.join(CSRC, "point_pipeline.cu")) as f:
        src = re.sub(r"<<<.*?>>>", "", f.read(), flags=re.S)   # launches run on host threads
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


def _run(exe, tmp_path, pw, pts, dirs, gbar, blocks):
    packed, off, n_grad = PP._pack(pw)
    rcfg = pw.rcfg
    d0, skip, n_sdf = PP._check_kernel_shape(rcfg)
    cn = rcfg.kind == "color_neus"
    meta = [pts.shape[0], n_sdf, skip, d0, len(pw.color), PP._color_dv(rcfg),
            int(rcfg.color.squeeze_out), len(pw.relight), PP._relight_dv(rcfg) if cn else 0,
            rcfg.relight.y_in_layer if cn else -1, int(rcfg.relight.inv_sigmoid), n_grad, blocks]
    np.asarray(meta, np.int64).tofile(tmp_path / "meta.i64")
    np.asarray([rcfg.sdf.scale], np.float32).tofile(tmp_path / "scale.f32")
    off.astype(np.int64).tofile(tmp_path / "off.i64")
    for name, t in (("w", packed), ("pts", pts), ("dirs", dirs), ("gbar", gbar)):
        t.numpy().astype(np.float32).tofile(tmp_path / f"{name}.f32")
    subprocess.run([exe, str(tmp_path)], check=True, timeout=300)

    def read(name, *shape):
        return torch.from_numpy(np.fromfile(tmp_path / f"{name}.f32", np.float32).reshape(shape))
    pw.off = off
    n = pts.shape[0]
    grads = PP._unpack_grads(pw, read("grad", n_grad))
    return read("out", n, 16), read("pts_hat", n, 3), read("dirs_hat", n, 3), grads


def _close(got, want, name):
    scale = max(float(want.abs().max()), 1e-6)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5 * scale, rtol=0,
                               err_msg=name)


@pytest.mark.parametrize("kind,relight", [
    ("color_neus", {}), ("color_neus", {"inv_sigmoid": False, "include_grad": False,
                                        "y_in_layer": 4}),
    ("neus", {})], ids=["color_neus", "color_neus-clip-nograd-ylast", "neus-idr"])
def test_emulated_kernels_match_plain(emulator, tmp_path, kind, relight):
    color = (ColorConfig(mode="no_view_dir", d_in=6, multires_view=0) if kind == "color_neus"
             else ColorConfig())
    rcfg = RendererConfig(kind=kind, color=color, relight=RelightConfig(**relight))
    g = torch.Generator().manual_seed(0)
    params = init_renderer(rcfg, g)
    with torch.no_grad():
        for p in params.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g))
    pw = PP.resolve_pipeline_weights(params, rcfg)
    n = 130
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
    out, pts_hat, dirs_hat, grads = _run(emulator, tmp_path, pw, pts, dirs, gbar, blocks=2)

    want = PP.point_pipeline_plain(pw, pts, dirs)
    for (name, atol), (a, b), w in zip(FWD_ATOL.items(), ((0, 1), (1, 4), (4, 7), (7, 10),
                                                           (10, 13)), want):
        np.testing.assert_allclose(out[:, a:b].numpy(), w.numpy(), atol=atol, rtol=0,
                                   err_msg=name)
    w_pts, w_dirs, w_grads = PP.point_pipeline_bwd_plain(pw, pts, dirs, cots)
    _close(pts_hat, w_pts, "pts")
    _close(dirs_hat, w_dirs, "dirs")
    for net, layers in w_grads.items():
        assert len(grads[net]) == len(layers)
        for l, ((a, b), (c, d)) in enumerate(zip(grads[net], layers)):
            _close(a, c, f"{net} layer {l} W")
            _close(b, d, f"{net} layer {l} b")
