"""The CUDA source of the MLP chain (csrc/mlp_chain.cu: rows 7 and 8),
compiled for the CPU and held against its plain PyTorch versions.

As tests/test_torch_ray_march_emulated.py does for rows 3 and 4: the source
runs through a host C++ compiler against tests/cuda_emu/cuda_runtime.h,
a block's CUDA threads as fibers with a barrier for __syncthreads
(tests/cuda_emu/harness_chain.cpp). What runs here, on 150 rows (two full
64-row tiles and a ragged one) and L = 3, on at most 2 persistent blocks
(the launch's grid cap: one block per group of tiles), and 400 rows on
one block that walks its groups:
  * the f32 chain (JAX's f32 dot as six bf16 passes on the software
    wgmma, W's three-part image, mlp_chain.pack_w3_image, streamed
    through the bulk-copy ring; two warpgroups a block, a 64-row tile
    each: 150 rows are one full group and one whose second tile lies
    past N), every variant, also on 70 rows (one group, a ragged second
    tile) and 400 rows on one block (4 groups, the ring's stages reused
    across groups and layers); the activation device functions on their
    own, on edge values;
  * the bf16 chains on wgmma, every variant and the deferred chain: the
    stand-in runtime emulates wgmma.mma_async m64nNk16 bf16 from the
    shared-memory descriptors (start address, SBO, the 128-byte swizzle),
    the warpgroup's fence and wait, the named barriers of the two
    warpgroups' ping-pong, and the bulk copy of the packed W image
    (ops/kernels/mlp_chain.py pack_w_image) on its mbarrier;
  * two mutants that must fail: the W image packed with the swizzle's
    phase off by one chunk, and a copy of the source whose warpgroups
    store their results into each other's tiles.
The approximate reciprocal of `recip~` divides here; the card checks it
(tests/test_torch_cuda.py, chip_smoke.py phase 9). Skips without a C++20
compiler.

Tolerances: the f32 chain against the plain f32 twin (PyTorch's f32
matmul) at 1e-5 absolute where no gate amplifies the summation order (f32
rounding over 3 layers of 256-term products of order-1 values: read <=
3.3e-6); every variant, the gated ones at weight 1.0 too, at least as
close to the float64 chain as the plain f32 twin is (a gate's slope of 25
a layer turns the two summation orders' ~1e-7 apart into up to 1.4e-4
over 3 layers: the kernel read 4.9e-5 to 6.0e-5 from float64 where the
twin read 1.1e-4, the ungated ones 3.8e-7 to 1.0e-6 against 1.1e-6 to
2.6e-6; before the six passes, the SIMT kernel summed in the twin's k
order and read <= 3.6e-6 from it at every variant); the
activations at 4 f32 ulps relative plus 2.5e-7 absolute (glibc's expf /
log1pf against PyTorch's vectorised ones, composed: read <= 1.4 ulp;
the gates 1 - r and 1 - exp(-100 sp) cancel near 0, where an ulp of 1.0
is the error). The bf16 chains against chain_plain(..., bf16=True) /
chain_deferred_plain, whose operands round alike: the emulated wgmma sums
each output's 256 products in k order in f32, PyTorch's CPU matmul in
another order, so a layer input within rounding of a bf16 midpoint rounds
to the other neighbour (2^-8 of it) and moves the next layer by |w| times
that (~1.6e-3 at these values). On these inputs none flipped: the bf16
chains read <= 1.4e-6 with the gates at weight 1.0 (expm1gate; the others
<= 2.4e-7, none and relu 0). ATOL_BF16 = 1e-3 holds that with headroom;
the mutants read 2.0 (swizzle) and 1.2e4 (tiles swapped: unwritten rows)."""

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
F32, BF16, DEFERRED = 0, 1, 2   # the harness's kernels
ATOL_BF16 = 1e-3
# the tiles' stores swapped between warpgroups 0 and 1
TILE_STORE = "store_out(c, (NWG * p + wg) * TR, 128 * h, acc);"
TILE_STORE_MUTANT = "store_out(c, (NWG * p + (wg ^ 1)) * TR, 128 * h, acc);"
RTOL_ACT = 4 * 2.0 ** -23
ATOL_ACT = 2.5e-7


def _compile(out, mutate=False):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the emulated kernels")
    with open(os.path.join(CSRC, "mlp_chain.cu")) as f:
        src = re.sub(r"<<<.*?>>>", "", f.read(), flags=re.S)
    if mutate:
        assert TILE_STORE in src
        src = src.replace(TILE_STORE, TILE_STORE_MUTANT)
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


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    return _compile(tmp_path_factory.mktemp("cuda_emu_chain"))


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


def _image(w, kernel=BF16):
    pack = MC.pack_w3_image if kernel == F32 else MC.pack_w_image
    return pack(torch.from_numpy(w)).view(torch.int16).numpy()


def _run(exe, d, x, w, act, gate_w, pr, kernel=F32, image=None, blocks=BLOCKS, layers=L):
    np.asarray([x.shape[0], layers, act, blocks, pr.size, kernel], np.int64).tofile(d / "meta.i64")
    np.asarray([gate_w], np.float32).tofile(d / "f32.f32")
    for name, t in (("x", x), ("probe", pr)):
        t.astype(np.float32).tofile(d / f"{name}.f32")
    (_image(w, kernel) if image is None else image).tofile(d / "wimg.bin")
    subprocess.run([exe, str(d)], check=True, timeout=600)
    out = np.fromfile(d / "out.f32", np.float32).reshape(x.shape)
    acts = np.fromfile(d / "act.f32", np.float32).reshape(len(MC.ACTIVATIONS) + 1, pr.size)
    return out, acts


def _check_f32(out, x, w, act):
    """The emulated f32 chain (gates at 1.0, L layers) against the plain
    f32 twin (ATOL_CHAIN, ungated variants) and float64 (every variant: at
    least as close as the twin)."""
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    want = MC.chain_plain(xt, wt, L, act, bf16=False, gate_w=1.0).numpy()
    f64 = MC.chain_plain(xt.double(), wt.double(), L, act, bf16=False, gate_w=1.0).numpy()
    if act not in MC.GATED:
        np.testing.assert_allclose(out, want, rtol=0, atol=ATOL_CHAIN, err_msg=act)
    kernel, twin = np.abs(out - f64).max(), np.abs(want - f64).max()
    assert kernel <= twin, f"{act}: {kernel:.3e} from float64, the f32 twin {twin:.3e}"


@pytest.mark.parametrize("act", [n for n, _ in MC.ACTIVATIONS])
def test_emulated_chain_f32_matches_plain(emulator, tmp_path, act):
    rng = np.random.RandomState(MC.act_id(act))
    x = rng.randn(N, MC.WIDTH).astype(np.float32)
    w = (0.06 * rng.randn(MC.WIDTH, MC.WIDTH)).astype(np.float32)
    pr = probe_values()
    out, acts = _run(emulator, tmp_path, x, w, MC.act_id(act), 1.0, pr)
    _check_f32(out, x, w, act)
    p = torch.from_numpy(pr)
    for i, (name, fn) in enumerate(MC.ACTIVATIONS):
        np.testing.assert_allclose(acts[i], fn(p, 1.0).numpy(), rtol=RTOL_ACT, atol=ATOL_ACT,
                                   err_msg=name)
    np.testing.assert_allclose(acts[-1], MC.act_sp_only(p).numpy(), rtol=RTOL_ACT, atol=ATOL_ACT,
                               err_msg="sp only")


@pytest.mark.parametrize("rows, blocks", [(70, BLOCKS), (400, 1)], ids=["ragged", "walk"])
@pytest.mark.parametrize("act", ["none", "sp+gate"])
def test_emulated_chain_f32_rows(emulator, tmp_path, act, rows, blocks):
    """70 rows: one group of two 64-row tiles, the second ragged (6 rows);
    400 rows on one block: it walks 4 groups (the last one 16 rows, its
    second tile past N), the ring's stages and parities carried across
    groups and layers."""
    x, w = _inputs(200 + MC.act_id(act), rows)
    out, _ = _run(emulator, tmp_path, x, w, MC.act_id(act), 1.0, probe_values()[:8],
                  blocks=blocks)
    _check_f32(out, x, w, act)


def _inputs(seed, rows=N):
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, MC.WIDTH).astype(np.float32)
    w = (0.06 * rng.randn(MC.WIDTH, MC.WIDTH)).astype(np.float32)
    return x, w


def _bf16_case(exe, d, act, image=None, rows=N, blocks=BLOCKS):
    """The emulated bf16 chain of `act` ("deferred": the deferred chain),
    the gates at weight 1.0, and its plain version."""
    x, w = _inputs(100 + len(MC.ACTIVATIONS) if act == "deferred" else 100 + MC.act_id(act),
                   rows)
    pr = probe_values()[:8]
    if act == "deferred":
        out, _ = _run(exe, d, x, w, 0, 1.0, pr, DEFERRED, image, blocks)
        want = MC.chain_deferred_plain(torch.from_numpy(x), torch.from_numpy(w), L, 1.0)
    else:
        out, _ = _run(exe, d, x, w, MC.act_id(act), 1.0, pr, BF16, image, blocks)
        want = MC.chain_plain(torch.from_numpy(x), torch.from_numpy(w), L, act, bf16=True,
                              gate_w=1.0)
    return out, want.numpy()


@pytest.mark.parametrize("act", [n for n, _ in MC.ACTIVATIONS] + ["deferred"])
def test_emulated_chain_bf16_matches_plain(emulator, tmp_path, act):
    out, want = _bf16_case(emulator, tmp_path, act)
    np.testing.assert_allclose(out, want, rtol=0, atol=ATOL_BF16, err_msg=act)


@pytest.mark.parametrize("act", ["sp+gate", "deferred"])
def test_emulated_chain_bf16_one_block_walks_groups(emulator, tmp_path, act):
    """One persistent block walks every tile it owns: 400 rows are 3
    groups of the chain's 3 x 64 rows (the last ragged), 7 of the deferred
    chain's 64-row tiles."""
    out, want = _bf16_case(emulator, tmp_path, act, rows=400, blocks=1)
    np.testing.assert_allclose(out, want, rtol=0, atol=ATOL_BF16, err_msg=act)


def test_emulated_chain_bf16_swizzle_mutant_fails(emulator, tmp_path):
    """The W image with the swizzle's phase off by one chunk (chunk c of
    row n at c ^ (n % 8) ^ 1) must fail."""
    _, w = _inputs(100 + MC.act_id("softplus"))
    img = _image(w).reshape(4, MC.WIDTH, 8, 8)[:, :, np.arange(8) ^ 1]
    out, want = _bf16_case(emulator, tmp_path, "softplus", np.ascontiguousarray(img))
    assert np.abs(out - want).max() > 10 * ATOL_BF16


def test_emulated_chain_bf16_tiles_swapped_mutant_fails(tmp_path_factory, tmp_path):
    """A copy of the source whose warpgroups 0 and 1 store their results into
    each other's tiles must fail."""
    exe = _compile(tmp_path_factory.mktemp("cuda_emu_chain_mutant"), mutate=True)
    out, want = _bf16_case(exe, tmp_path, "none")
    assert np.abs(out - want).max() > 10 * ATOL_BF16
