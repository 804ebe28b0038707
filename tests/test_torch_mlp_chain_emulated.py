"""The CUDA source of the MLP chain (csrc/mlp_chain.cu: rows 7 and 8),
compiled for the CPU and held against its plain PyTorch versions.

As tests/test_torch_ray_march_emulated.py does for rows 3 and 4: the source
runs through a host C++ compiler against tests/cuda_emu/cuda_runtime.h,
one std::thread per CUDA thread with a barrier for __syncthreads
(tests/cuda_emu/harness_chain.cpp). What runs here is the f32 chain (every
variant, 150 rows: two 64-row tiles and a ragged one, walked by 2
persistent blocks) and the activation device functions on their own, on
edge values. The bf16 chains (the tool's main arm and the deferred chain)
are written with mma.sync tensor-core instructions, which the stand-in
runtime does not emulate: they compile only under nvcc and are held
against their plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 9). So is the approximate reciprocal of `recip~`,
which divides here. Skips without a C++20 compiler.

Tolerances: the chain at 1e-5 absolute (f32 summation order over 3
layers of 256-term products of order-1 values: read <= 3.6e-6); the
activations at 4 f32 ulps relative plus 2.5e-7 absolute (glibc's expf /
log1pf against PyTorch's vectorised ones, composed: read <= 1.4 ulp;
the gates 1 - r and 1 - exp(-100 sp) cancel near 0, where an ulp of 1.0
is the error)."""

import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from color_neus_torch.ops.kernels import mlp_chain as MC

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "color_neus_torch", "csrc")
N, L, BLOCKS = 150, 3, 2
ATOL_CHAIN = 1e-5
RTOL_ACT = 4 * 2.0 ** -23
ATOL_ACT = 2.5e-7


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the emulated kernels")
    out = tmp_path_factory.mktemp("cuda_emu_chain")
    with open(os.path.join(CSRC, "mlp_chain.cu")) as f:
        src = re.sub(r"<<<.*?>>>", "", f.read(), flags=re.S)
    with open(os.path.join(HERE, "cuda_emu", "harness_chain.cpp")) as f:
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


def probe_values():
    """Seeded values plus the edges: 0, the 100 x = 30 threshold and its f32
    neighbours, exp(100 x) overflow (x > ~0.887), exp(-100 |x|) underflow
    (|x| > ~1.04), tiny and large magnitudes."""
    rng = np.random.RandomState(7)
    t = np.float32(0.3)
    edges = [0.0, -0.0, t, np.nextafter(t, np.float32(1)), np.nextafter(t, np.float32(0)), -t,
             0.887, 0.9, -0.9, 1.04, -1.04, 2.0, -2.0, 50.0, -50.0, 1e-8, -1e-8, 1e-3, -1e-3]
    return np.concatenate([np.asarray(edges, np.float32), np.linspace(-3, 3, 2001, dtype=np.float32),
                           (0.05 * rng.randn(500)).astype(np.float32)])


def _run(exe, d, x, w, act, gate_w, pr):
    np.asarray([x.shape[0], L, act, BLOCKS, pr.size], np.int64).tofile(d / "meta.i64")
    np.asarray([gate_w], np.float32).tofile(d / "f32.f32")
    for name, t in (("x", x), ("w", w), ("probe", pr)):
        t.astype(np.float32).tofile(d / f"{name}.f32")
    subprocess.run([exe, str(d)], check=True, timeout=600)
    out = np.fromfile(d / "out.f32", np.float32).reshape(x.shape)
    acts = np.fromfile(d / "act.f32", np.float32).reshape(len(MC.ACTIVATIONS) + 1, pr.size)
    return out, acts


@pytest.mark.parametrize("act", [n for n, _ in MC.ACTIVATIONS])
def test_emulated_chain_f32_matches_plain(emulator, tmp_path, act):
    rng = np.random.RandomState(MC.act_id(act))
    x = rng.randn(N, MC.WIDTH).astype(np.float32)
    w = (0.06 * rng.randn(MC.WIDTH, MC.WIDTH)).astype(np.float32)
    pr = probe_values()
    out, acts = _run(emulator, tmp_path, x, w, MC.act_id(act), 1.0, pr)
    want = MC.chain_plain(torch.from_numpy(x), torch.from_numpy(w), L, act, bf16=False,
                          gate_w=1.0).numpy()
    np.testing.assert_allclose(out, want, rtol=0, atol=ATOL_CHAIN)
    p = torch.from_numpy(pr)
    for i, (name, fn) in enumerate(MC.ACTIVATIONS):
        np.testing.assert_allclose(acts[i], fn(p, 1.0).numpy(), rtol=RTOL_ACT, atol=ATOL_ACT,
                                   err_msg=name)
    np.testing.assert_allclose(acts[-1], MC.act_sp_only(p).numpy(), rtol=RTOL_ACT, atol=ATOL_ACT,
                               err_msg="sp only")
