"""The CUDA source of the fused ray march (csrc/ray_march.cu: rows 3 and 4,
forward and backward), compiled for the CPU and held against its plain
PyTorch versions at full width.

As tests/test_torch_point_pipeline_emulated.py does for rows 5 and 6: the
source runs through a host C++ compiler against tests/cuda_emu/
cuda_runtime.h, a block's CUDA threads as fibers with a barrier for
__syncthreads, the software mma.sync and wgmma and the bulk copies
(tests/cuda_emu/harness_march.cpp), on 2 blocks at 2 tiles a weight-grad
batch. The cases cover a 128-sample ray (two 64-point tiles: one full
batch), 100-sample rays (a tile and a 36-point tail), 27-sample rays
packed two to a tile with a ragged last group (one block a full batch,
the other a ragged one), both renderer kinds, and an inv_s of ~2000 with
exact q == 1 ties; the save pair also a 300-sample ray (five tiles, the
last of 44 points; the load's compositing VJP in two passes of 256
points, its sums carried from one to the other);
and the clip's tie rule, on rays whose every point is a tie, held by a
copy of the source with the tie gate at 1.0, which must fail. The save
mode's pair (ray_march_save_fwd_kernel, ray_march_load_bwd_kernel) runs the
same cases: its forward as the recompute's, every segment of its
activation stash against the bf16 plain twin's (point_pipeline.ActStash),
its backward against the same references, and copies of the source whose
load reads the hidden SDF layers one segment off, or whose compositing
VJP ends each ray's segment of its suffix sums a sample early, must fail;
so must copies of its forward whose compositing scan drops the T a ray
carries from one forward tile to the next or takes T inclusive of its
sample, or whose reverse sweep rebuilds the gates from the wrong layer's
softplus in the stash. The stash's colour / relight images (each 64-point
backward tile's, in the flush's operand layout) are read back per point
(ray_march.unpack_act) and their padding points must be zeros; the load
entry on one block that flushes three batches into its partial (vector
reductions, nothing read back) matches the references and two identical
calls are bitwise equal; copies whose first flush adds nothing, or whose
forward writes the images one tile off or with the swizzle's phase one row
off, must fail.
The card-only parts (timing, races between warps, the GPU's float
functions) are checked by tests/test_torch_cuda.py and chip_smoke.py.
Skips without a C++20 compiler.

The kernels compute the TPU kernels' bf16 products, so they are held
against the plain twins with bf16=True. Tolerances: the forward and the
stash within RTOL_BF16 of each lane group's largest |plain| (a layer input
within rounding of a bf16 midpoint rounds to the other neighbour after
another f32 summation order, one bf16 ulp of that input, propagated: read
<= 4.5e-4 on grad); the backward against the bf16 twin in float64: for
each output or leaf, at most RTOL_BF16 x its largest |float64| value plus
twice the f32 bf16 twin's own distance from float64 (the float64 twin
flips bf16 roundings too, read ~1e-3 to 2e-2 from either f32 path; at
inv_s ~2000 the cotangents of sdf and inv_s sum saturated sigmoid slopes
pc (1 - pc), which f32 rounds coarsely: there the f32 twin is ~130% off
float64 on inv_s, the kernel ~3e-4). The seeds keep every colour / relight
relu pre-activation more than 3e-7 from 0 (asserted; float64), so no mask
flips between the two f32 paths, whose pre-activations differ by rounding
(~1e-8 here)."""

import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import relu_margin
from color_neus_torch import pin_precision
from color_neus_torch.models.configs import ColorConfig, RendererConfig
from color_neus_torch.models.fields import variance_inv_s
from color_neus_torch.models.neus import init_renderer
from color_neus_torch.ops.kernels import point_pipeline as PP
from color_neus_torch.ops.kernels import ray_march as RM

pin_precision()

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "color_neus_torch", "csrc")
MARGIN = 3e-7
RTOL_BF16 = 2e-3
RTOL_TIE = 3e-2


# the tie gate of the clip's VJP (clip(q, 0, 1) at q == 1), and the same
# line with the gate at 1.0: a copy that must fail the tie test below
TIE_GATE = "c.q == 1.f ? 0.5f"
TIE_GATE_MUTANT = "c.q == 1.f ? 1.0f"


# the load's read of hidden SDF layer l's softplus (point_pipeline_tile.cuh
# stash_sx: the gates and the weight-grad operands), and the same read one
# layer on (layer l + 1's segment; the last layer's reads the cr part): a
# copy that must fail the save test below
LOAD_SP = "const unsigned char* row = ts.row0 + size_t(r) * ts.bytes + ts.al.sx + l * ts.al.sxw;"
LOAD_SP_MUTANT = ("const unsigned char* row = ts.row0 + size_t(r) * ts.bytes + ts.al.sx + "
                  "(l + 1) * ts.al.sxw;")

# the load's compositing VJP (composite_vjp_par): the sum G over a ray's
# later samples is the suffix sum from the next point on; from the point
# itself (the scan's boundary a sample off) must fail
SCAN_NEXT = "const float later = last ? 0.f : (tid + 1 < THREADS ? sv[tid + 1] : carry_g);"
SCAN_NEXT_MUTANT = "const float later = last ? 0.f : (tid + 1 < THREADS ? sv[tid] : carry_g);"


def _compile(out, mutate=None, defines=()):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the emulated kernels")
    with open(os.path.join(CSRC, "ray_march.cu")) as f:
        src = re.sub(r"<<<.*?>>>", "", f.read(), flags=re.S)   # launches run on host threads
    if mutate is not None:   # in ray_march.cu or the tile header, inlined
        line, mutant = mutate
        with open(os.path.join(CSRC, "point_pipeline_tile.cuh")) as f:
            tile = f.read()
        assert src.count(line) + tile.count(line) == 1, f"the line to mutate moved: {line}"
        src = src.replace('#include "point_pipeline_tile.cuh"', tile.replace(line, mutant))
        src = src.replace(line, mutant)
    with open(os.path.join(HERE, "cuda_emu", "harness_march.cpp")) as f:
        src += f.read()
    path = out / "emu.cpp"
    path.write_text(src)
    exe = str(out / "emu")
    proc = subprocess.run([cxx, "-std=c++20", "-O2", "-pthread", "-Wno-unknown-pragmas",
                           *defines, "-I", os.path.join(HERE, "cuda_emu"), "-I", CSRC, "-x",
                           "c++", str(path), "-o", exe], capture_output=True, text=True)
    if proc.returncode != 0 and "barrier" in proc.stderr:
        pytest.skip("the host compiler lacks C++20 <barrier>")
    assert proc.returncode == 0, proc.stderr
    return exe


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    return _compile(tmp_path_factory.mktemp("cuda_emu_march"))


def _run(exe, tmp_path, pw, ro, rd, z, inv_s, sample_dist, gbar, blocks, batch=2, save=False):
    packed, off, n_grad = PP._pack(pw)
    img, ioff = PP._pack_images(pw)
    rcfg = pw.rcfg
    d0, skip, n_sdf = PP._check_kernel_shape(rcfg)
    cn = rcfg.kind == "color_neus"
    R, S = z.shape
    meta = [R, S, n_sdf, skip, d0, len(pw.color), PP._color_dv(rcfg),
            int(rcfg.color.squeeze_out), len(pw.relight), PP._relight_dv(rcfg) if cn else 0,
            rcfg.relight.y_in_layer if cn else -1, int(rcfg.relight.inv_sigmoid), n_grad, blocks,
            batch, int(save)]
    np.asarray(meta, np.int64).tofile(tmp_path / "meta.i64")
    np.asarray([rcfg.sdf.scale, sample_dist, inv_s], np.float32).tofile(tmp_path / "f32.f32")
    off.astype(np.int64).tofile(tmp_path / "off.i64")
    ioff.astype(np.int64).tofile(tmp_path / "ioff.i64")
    img.view(torch.int16).numpy().tofile(tmp_path / "img.bf16")
    for name, t in (("w", packed), ("rays_o", ro), ("rays_d", rd), ("z", z), ("gbar", gbar)):
        t.numpy().astype(np.float32).tofile(tmp_path / f"{name}.f32")
    subprocess.run([exe, str(tmp_path)], check=True, timeout=600)

    def read(name, *shape):
        return torch.from_numpy(np.fromfile(tmp_path / f"{name}.f32", np.float32).reshape(shape))
    pw.off = off
    grad = read("grad", n_grad + 1)
    out = (read("out", R, 16), read("stash", R * S, RM.STASH), read("rays_hat", R, 8),
           grad[n_grad], PP._unpack_grads(pw, grad[:n_grad]))
    if not save:
        return out
    act = np.fromfile(tmp_path / "act.bin", np.uint8)
    assert act.size == RM.act_total_bytes(pw, R, S)
    check_cr_padding(act, pw, R, S)
    return out + (RM.unpack_act(pw, torch.from_numpy(act), R, S),)


def check_cr_padding(act, pw, R, S):
    """The padding points of every backward tile's cr images in a save
    stash (a group's points past its last sample, in its last tile) are
    zeros: the flush multiplies them by zero cotangents, and the
    backward's relu masks and narrow layers read them."""
    G, n_cr = RM.rays_per_group(S), RM.act_cr_slots(pw)
    tpg = -(-G * S // 64)
    off = -(-R * S * RM.act_row_bytes(pw) // 1024) * 1024
    img = act[off:].view(np.uint16).reshape(-1, n_cr, PP.HID, 64)   # stored order in a row
    for g in range(-(-R // G)):
        n = min(G, R - g * G) * S
        for t in range(-(-n // 64)):
            real = min(64, n - 64 * t)
            if real == 64:
                continue
            rows = img[g * tpg + t]                         # [slot, k, 64 stored]
            k = np.arange(PP.HID)[:, None]
            pt = np.arange(64)[None, :]
            stored = ((pt // 8) ^ (k % 8)) * 8 + pt % 8      # the 128-byte swizzle
            pad = np.take_along_axis(rows, np.broadcast_to(stored, rows.shape), axis=2)[:, :, real:]
            assert not pad.any(), f"group {g} tile {t}: padding points not zero"


def _act_segments(act, pw):
    """The activation stash (RM.unpack_act's rows and cr) as float32
    tensors: (sp [n_sdf - 1] of [N, 256], the bf16 slots [n_color +
    n_relight - 1] of [N, 256], the tail [N, 8]): csrc/point_pipeline_tile.cuh
    act_layout."""
    rows, cr = act[0].numpy(), act[1]
    n_sdf = RM._net_counts(pw)[0]
    n, hid = rows.shape[0], PP.HID
    sx = rows[:, :(n_sdf - 1) * hid * 4].copy().view(np.float32).reshape(n, n_sdf - 1, hid)
    tail = rows[:, (n_sdf - 1) * hid * 4:].copy().view(np.float32)
    return (torch.from_numpy(sx), cr, torch.from_numpy(tail))


def _rel(got, want) -> float:
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-6)


def _close(got, plain, want, name):
    """got (the kernel) against want (the bf16 twin in float64): within
    RTOL_BF16 x max |want| plus twice the f32 bf16 twin's own distance from
    want."""
    err = float((got.double() - want).abs().max())
    err_plain = float((plain.double() - want).abs().max())
    tol = RTOL_BF16 * float(want.abs().max()) + 2.0 * err_plain
    assert err <= tol, f"{name}: kernel {err:.3e} from float64, tolerance {tol:.3e}"


CASES = [("color_neus", 1, 128, 0.3, 0.02, 6), ("neus", 2, 100, 0.3, 0.02, 2),
         ("color_neus", 5, 27, 0.76, 0.005, 9)]
IDS = [f"{k}-R{r}xS{s}-v{v}" for k, r, s, v, _, _ in CASES]
# the save pair also on a ray whose compositing VJP takes two passes
SAVE_CASES = CASES + [("color_neus", 1, 300, 0.3, 0.02, 2)]
SAVE_IDS = IDS + ["color_neus-R1xS300-v0.3"]


@pytest.mark.parametrize("kind,R,S,variance,noise,seed", CASES, ids=IDS)
def test_emulated_march_matches_plain(emulator, tmp_path, kind, R, S, variance, noise, seed):
    _check_case(emulator, tmp_path, kind, R, S, variance, noise, seed, save=False)


@pytest.mark.parametrize("kind,R,S,variance,noise,seed", SAVE_CASES, ids=SAVE_IDS)
def test_emulated_march_save_matches_plain(emulator, tmp_path, kind, R, S, variance, noise,
                                           seed):
    """The save mode's pair on the same cases: the forward and the 8-float
    stash as the recompute's; every segment of the activation stash
    against the bf16 twin's unrounded values (within one bf16 ulp of each
    value plus RTOL_BF16 of the segment's largest, the stored bf16 parts;
    RTOL_BF16 of the largest, the f32 ones), its padding lanes and tail
    zeros exact; the backward, which loads the stash, against the same
    references as the recompute's."""
    _check_case(emulator, tmp_path, kind, R, S, variance, noise, seed, save=True)


def _check_case(emulator, tmp_path, kind, R, S, variance, noise, seed, save, blocks=2):
    case = case_inputs(kind, R, S, variance, noise, seed)
    res = _run(emulator, tmp_path, *case[:7], blocks=blocks, save=save)
    check_result(res, case, variance, save)


# the save pair on one block of three 128-sample rays: six tiles at 2 a
# batch, so the load entry's block flushes three times into its partial
FLUSH3 = ("color_neus", 3, 128, 0.3, 0.02, 14)


def test_emulated_march_load_flushes_three_times(emulator, tmp_path):
    """The load entry whose block flushes three batches into its partial
    (vector reductions, nothing read back) against the same references as
    the save test, and two identical calls bitwise equal (outputs, stash
    and weight grads)."""
    kind, R, S, variance, noise, seed = FLUSH3
    case = case_inputs(kind, R, S, variance, noise, seed)
    runs = []
    for i in range(2):
        run_dir = tmp_path / f"run{i}"
        run_dir.mkdir()
        runs.append(_run(emulator, run_dir, *case[:7], blocks=1, save=True))
        runs[-1] = runs[-1] + (np.fromfile(run_dir / "grad.f32", np.uint8),
                               np.fromfile(run_dir / "act.bin", np.uint8))
    a, b = runs
    for x, y in zip(a[:4] + a[6:], b[:4] + b[6:]):
        x, y = (np.asarray(v) if not isinstance(v, torch.Tensor) else v.numpy() for v in (x, y))
        assert x.tobytes() == y.tobytes(), "two identical calls differ"
    check_result(a[:6], case, variance, True)


def case_inputs(kind, R, S, variance, noise, seed, mode="f32stash"):
    """A case's (pw, rays_o, rays_d, z, inv_s, sample_dist, gbar), its
    weights off the init by seeded noise, the relu margin asserted; mode
    the weights' march_bwd_precision."""
    color = (ColorConfig(mode="no_view_dir", d_in=6, multires_view=0) if kind == "color_neus"
             else ColorConfig())
    rcfg = RendererConfig(kind=kind, color=color, march_bwd_precision=mode)
    g = torch.Generator().manual_seed(seed)
    params = init_renderer(rcfg, g)
    with torch.no_grad():
        for p in params.parameters():
            p.add_(noise * torch.randn(p.shape, generator=g))
        params["variance"]["variance"].fill_(variance)
    pw = PP.resolve_pipeline_weights(params, rcfg)
    d = torch.randn((R, 3), generator=g)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    ro = (-1.4 * d + 0.1 * torch.randn((R, 3), generator=g)).contiguous()
    rd = d.contiguous()
    z = (0.5 + 1.8 * torch.sort(torch.rand((R, S), generator=g), dim=-1).values).contiguous()
    inv_s = variance_inv_s(params["variance"]).detach().reshape(1)
    sd = 2.0 / rcfg.n_samples
    gbar = torch.randn((R, 16), generator=g)
    gbar[:, 7:] = 0.0

    dists, _, pts, dirs = RM.march_points(ro, rd, z, sd)
    pw64 = PP.PipelineWeights(rcfg, *[[(w.double(), b.double()) for w, b in layers]
                                      for layers in (pw.sdf, pw.color, pw.relight)])
    assert float(relu_margin(pw64, pts.double(), dirs.double()).min()) > MARGIN
    return pw, ro, rd, z, float(inv_s), sd, gbar


def check_result(res, case, variance, save):
    """The emulated kernels' outputs (_run's) on case_inputs' case against
    the plain twins, at the module's limits."""
    pw, ro, rd, z, inv_s, sd, gbar = case
    rcfg = pw.rcfg
    inv_s = torch.tensor([inv_s])
    dists, _, pts, dirs = RM.march_points(ro, rd, z, sd)
    pw64 = PP.PipelineWeights(rcfg, *[[(w.double(), b.double()) for w, b in layers]
                                      for layers in (pw.sdf, pw.color, pw.relight)])
    out, stash, rays_hat, s_hat, grads = res[:5]
    outs = PP.point_pipeline_plain(pw, pts, dirs, bf16=True)
    c = RM.composite(outs, rd, dists, pts, inv_s)
    if save:
        _check_act(res[5], pw, pts, dirs, c.Tr.reshape(-1))
    want = torch.cat([outs[0], outs[1], outs[3], outs[4].sum(dim=1, keepdim=True)], dim=1)
    for name, (a, b) in (("sdf", (0, 1)), ("grad", (1, 4)), ("relit", (4, 7)), ("delta", (7, 8))):
        assert _rel(stash[:, a:b], want[:, a:b]) <= RTOL_BF16, f"stash {name}"
    plain_out = RM.ray_march_plain(pw, ro, rd, z, inv_s, sd, bf16=True)
    for name, (a, b) in chip_smoke.MARCH_LANES.items():
        assert _rel(out[:, a:b], plain_out[:, a:b]) <= RTOL_BF16, f"out {name}"
    if variance > 0.5:
        assert int((c.q == 1.0).sum()) > 0, "no exact q == 1 tie on the rays"

    args64 = (ro.double(), rd.double(), z.double(), inv_s.double(), sd, gbar.double())
    ref = RM.ray_march_bwd_plain(pw64, *args64, bf16=True)
    plain = RM.ray_march_bwd_plain(pw, ro, rd, z, inv_s, sd, gbar, bf16=True)
    _close(rays_hat[:, 0:3], plain[0], ref[0], "rays_o")
    _close(rays_hat[:, 4:7], plain[1], ref[1], "rays_d")
    assert float(rays_hat[:, 3].abs().max()) == 0.0 and float(rays_hat[:, 7].abs().max()) == 0.0
    _close(s_hat.reshape(1), plain[2].reshape(1), ref[2].reshape(1), "inv_s")
    for net, layers in ref[3].items():
        assert len(grads[net]) == len(layers)
        for l, ((a, b), (pa, pb), (e, f)) in enumerate(zip(grads[net], plain[3][net], layers)):
            _close(a, pa, e, f"{net} layer {l} W")
            _close(b, pb, f, f"{net} layer {l} b")


def _check_act(act, pw, pts, dirs, Tr):
    """The emulated activation stash against the bf16 twin's values; its
    tail's slot 6 the transmittance before each sample (Tr, the bf16
    twin's), slot 7 zero."""
    outs, st = PP._forward(pw, pts, dirs, True)
    want = PP.stash_activations(pw.rcfg, outs, st, bf16=False)   # unrounded
    sx, cr, tail = _act_segments(act, pw)
    for l, sp in enumerate(want.sp):
        w = sp.shape[1]
        assert _rel(sx[:, l, :w], sp) <= RTOL_BF16, f"stash sp {l}"
    for j, v in enumerate(want.cs + want.rs):
        err = (cr[:, j, :v.shape[1]] - v).abs()
        tol = 2.0 ** -8 * v.abs() + RTOL_BF16 * float(v.abs().max())
        assert bool((err <= tol).all()), f"stash bf16 slot {j}: {float((err - tol).max()):.3e}"
    for name, (a, b), x in (("gc", (0, 3), outs[2]), ("delta", (3, 6), outs[4])):
        assert _rel(tail[:, a:b], x) <= RTOL_BF16 or float(x.abs().max()) == 0.0, f"tail {name}"
    assert _rel(tail[:, 6], Tr) <= RTOL_BF16, "tail T"
    assert float(tail[:, 7].abs().max()) == 0.0
    if pw.rcfg.kind == "neus":
        assert float(tail[:, 3:6].abs().max()) == 0.0


def test_emulated_march_load_mutant_fails(tmp_path_factory, tmp_path):
    """A copy of the source whose load reads each hidden SDF layer's
    softplus from the next layer's segment: its backward must leave the
    bf16 twin by far more than the save test's limits."""
    kind, R, S, variance, noise, seed = CASES[0]
    mutant = _compile(tmp_path_factory.mktemp("cuda_emu_march_load_mutant"),
                      mutate=(LOAD_SP, LOAD_SP_MUTANT))
    with pytest.raises(AssertionError):
        _check_case(mutant, tmp_path, kind, R, S, variance, noise, seed, save=True)


def test_emulated_march_scan_mutant_fails(tmp_path_factory, tmp_path):
    """A copy of the source whose load-side compositing VJP takes the sum G
    over a ray's later samples from the point itself on (its own w_bar w
    in it), on the 27-sample rays packed several to a tile: its backward
    must leave the bf16 twin by far more than the save test's limits."""
    kind, R, S, variance, noise, seed = CASES[2]
    mutant = _compile(tmp_path_factory.mktemp("cuda_emu_march_scan_mutant"),
                      mutate=(SCAN_NEXT, SCAN_NEXT_MUTANT))
    with pytest.raises(AssertionError):
        _check_case(mutant, tmp_path, kind, R, S, variance, noise, seed, save=True)


def test_emulated_march_tie_gate(emulator, tmp_path_factory, tmp_path):
    """The clip's tie rule in the kernel: on rays deep inside the surface
    (chip_smoke.tie_inputs) every point has q == 1 exactly, in float32 and
    in float64, so the inv_s cotangent is all tie-born and the gate of 0.5
    halves it. The source matches the bf16 plain twin in float64 within
    RTOL_TIE: alpha_bar of a ray's first sample is the difference of two
    nearby colour weights, so the bf16 flips between the f32 kernel and the
    float64 twin (one bf16 ulp of a colour layer's input) show in it at
    full size (read 6.6e-3 here, 1.9e-4 with f32 products); a copy of the
    source with the gate at 1.0 is ~100% off and must fail. The f32 plain
    twin is no reference here: its suffix sum (a reversed cumsum minus the
    sample's own term, as in JAX) cancels at alpha == 1, orders of
    magnitude off."""
    from chip_smoke import tie_counts, tie_inputs
    R, S = 16, 8
    rcfg, pw, ro, rd, z, inv_s, gbar = tie_inputs(torch.device("cpu"), R, S, seed=11)
    sd = 2.0 / rcfg.n_samples
    assert tie_counts(pw, ro, rd, z, inv_s, sd) == (R * S, R * S)
    pw64 = PP.PipelineWeights(rcfg, *[[(w.double(), b.double()) for w, b in layers]
                                      for layers in (pw.sdf, pw.color, pw.relight)])
    want = float(RM.ray_march_bwd_plain(pw64, ro.double(), rd.double(), z.double(),
                                        inv_s.double(), sd, gbar.double(), bf16=True)[2])
    assert abs(want) > 0.0
    mutant = _compile(tmp_path_factory.mktemp("cuda_emu_march_tie_mutant"),
                      mutate=(TIE_GATE, TIE_GATE_MUTANT))
    errs = {}
    for name, exe in (("source", emulator), ("mutant", mutant)):
        run_dir = tmp_path / name
        run_dir.mkdir()
        s_hat = float(_run(exe, run_dir, pw, ro, rd, z, float(inv_s), sd, gbar, blocks=2)[3])
        errs[name] = abs(s_hat - want) / abs(want)
    assert errs["source"] <= RTOL_TIE, errs
    assert errs["mutant"] > 0.5, errs


# the save forward's compositing (ray_march.cu composite_tile): T before a
# sample is the exclusive product scan, carried from a ray's earlier
# forward tiles; copies that drop the carry, or take T inclusive of its
# own sample, must fail
CARRY_T = "cT = sv[last];"
CARRY_T_MUTANT = "cT = 1.f;"
T_EXCL = "if (in) T = head ? 1.f : (i > 0 ? sv[i - 1] : cT);"
T_EXCL_MUTANT = "if (in) T = sv[i];"
# the save forward's reverse sweep rebuilds layer l - 1's gates from the
# stash's f32 softplus (point_pipeline_tile.cuh forward_tile, SG): a copy
# that reads layer l's must fail
SG_READ = "reverse_pass<ROWS, true>(X, K, l == p.skip, g, ex, al.sx + (l > 0 ? l - 1 : 0) * al.sxw);"
SG_READ_MUTANT = "reverse_pass<ROWS, true>(X, K, l == p.skip, g, ex, al.sx + l * al.sxw);"


@pytest.mark.parametrize("name,case,line,mutant", [
    ("carry", SAVE_CASES[3], CARRY_T, CARRY_T_MUTANT),
    ("inclusive_t", CASES[2], T_EXCL, T_EXCL_MUTANT),
    ("gate_layer", CASES[0], SG_READ, SG_READ_MUTANT)],
    ids=["carry", "inclusive_t", "gate_layer"])
def test_emulated_march_save_forward_mutant_fails(tmp_path_factory, tmp_path, name, case, line,
                                                  mutant):
    """Copies of the save forward that must leave the bf16 twin by far
    more than the save test's limits: the T carried over a ray's forward
    tiles dropped (the 300-sample ray, three forward tiles), T taken
    inclusive of its own sample (27-sample rays, several a tile), the
    reverse sweep's gates rebuilt from the next layer's softplus in the
    stash (the 128-sample ray)."""
    kind, R, S, variance, noise, seed = case
    exe = _compile(tmp_path_factory.mktemp(f"cuda_emu_march_{name}_mutant"),
                   mutate=(line, mutant))
    with pytest.raises(AssertionError):
        _check_case(exe, tmp_path, kind, R, S, variance, noise, seed, save=True)


# the load entry's flush (point_pipeline_tile.cuh dw_flush<PREC, true>):
# its reductions into the partial skipped for the block's first batch, or
# its first batch added (not stored) onto the partial the wrapper leaves
# unfilled (torch.empty; the harness fills it with 12345); the save
# forward's cr images (export_cr) written one 64-point tile off (the
# forward tile's two halves swapped), or with the 128-byte swizzle's phase
# one row off: copies that must fail
RED_F32STASH = ("        bulk_rows(P + p.off[blk.slot] + size_t(k0) * HID, acc, st.w.buf, "
                "blk.K - k0, d0 == 0);")
RED_SKIP_FIRST = ("        if (d0 != 0) bulk_rows(P + p.off[blk.slot] + size_t(k0) * HID, acc, "
                  "st.w.buf, blk.K - k0, false);")
RED_FIRST_ADDS = ("        bulk_rows(P + p.off[blk.slot] + size_t(k0) * HID, acc, st.w.buf, "
                  "blk.K - k0, false);")
CR_TILE = "      mlp::bulk_store(ex.cr + h * tile_bytes + size_t(slot) * CR_SLOT, stage, CR_SLOT);"
CR_TILE_OFF = ("      mlp::bulk_store(ex.cr + (1 - h) * tile_bytes + size_t(slot) * CR_SLOT, stage, "
               "CR_SLOT);")
CR_SWIZZLE = "      *reinterpret_cast<uint4*>(stage + mlp::sw128_offset(k, 8 * c)) ="
CR_SWIZZLE_OFF = "      *reinterpret_cast<uint4*>(stage + k * 128 + ((c ^ ((k + 1) & 7)) << 4)) ="


@pytest.mark.parametrize("name,case,blocks,line,mutant", [
    ("flush_skipped", FLUSH3, 1, RED_F32STASH, RED_SKIP_FIRST),
    ("first_flush_adds", CASES[0], 2, RED_F32STASH, RED_FIRST_ADDS),
    ("cr_tile_off", CASES[0], 2, CR_TILE, CR_TILE_OFF),
    ("cr_swizzle_phase", CASES[0], 2, CR_SWIZZLE, CR_SWIZZLE_OFF)],
    ids=["flush_skipped", "first_flush_adds", "cr_tile_off", "cr_swizzle_phase"])
def test_emulated_march_load_flush_mutant_fails(tmp_path_factory, tmp_path, name, case, blocks,
                                                line, mutant):
    """Copies of the save pair that must leave the bf16 twin by far more
    than the save test's limits: the load entry's first flush of a block
    adding nothing into its partial (one block flushing three batches), or
    adding onto the partial's unfilled values in place of storing,
    the save forward writing each backward tile's colour / relight images
    into the other tile of its forward tile, or swizzled with the phase of
    the next row (the 128-sample ray)."""
    kind, R, S, variance, noise, seed = case
    exe = _compile(tmp_path_factory.mktemp(f"cuda_emu_march_{name}_mutant"),
                   mutate=(line, mutant))
    with pytest.raises(AssertionError):
        _check_case(exe, tmp_path, kind, R, S, variance, noise, seed, save=True, blocks=blocks)
