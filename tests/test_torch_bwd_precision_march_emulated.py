"""The MARCH_BWD_PRECISION instantiations of the fused march (csrc/ray_march.cu
built with PP_PREC 1, 'bf16', and 2, 'f32'), compiled for the CPU and held
against their plain twins in the same mode: the recompute pair and the
save pair (its activation stash segment by segment: 'bf16' stores the SDF
part in bf16, the next layer's input, within one bf16 ulp of the twin's),
as tests/test_torch_ray_march_emulated.py holds f32stash, on its 128-sample
Color-NeuS ray and 100-sample NeuS rays; the SDF lanes and stash of 'f32' within
RTOL_F32, and its SDF features (the colour net's input, from the forward's
scratch) within RTOL_F32 of the twin's and the float64 twin's. The sources are built by
tests/test_torch_bwd_precision_emulated.py's _compile (the harness
tests/cuda_emu/harness_march.cpp). Skips without a C++20 compiler."""

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
from tests import test_torch_ray_march_emulated as EM
from tests.test_torch_bwd_precision_emulated import (FWD_ROWS, PREC, RTOL_BF16, RTOL_F32,
                                                      _compile, kernel_features,
                                                      twin_sdf_outputs)

pin_precision()

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "color_neus_torch", "csrc")
CUDA_EMU = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_emu")


@pytest.fixture(scope="module")
def march_emulators(tmp_path_factory):
    return {mode: _compile(tmp_path_factory.mktemp(f"emu_rm_{mode}"), "ray_march",
                           "harness_march.cpp", mode) for mode in PREC}


def _act_segments(act, pw):
    """The activation stash (RM.unpack_act's rows and cr) in the mode's
    layout as float32: (the SDF part [N, n_sdf - 1, 256], the bf16 slots,
    the tail [N, 8])."""
    rows, cr = act[0].numpy(), act[1]
    n_sdf = RM._net_counts(pw)[0]
    n, hid = rows.shape[0], PP.HID
    sxb = 2 if pw.rcfg.march_bwd_precision == "bf16" else 4
    sx_end = (n_sdf - 1) * hid * sxb
    sx = rows[:, :sx_end].copy()
    sx = (sx.view(np.uint16).astype(np.uint32) << 16).view(np.float32) if sxb == 2 \
        else sx.view(np.float32)
    tail = rows[:, sx_end:].copy().view(np.float32)
    return (torch.from_numpy(sx.reshape(n, n_sdf - 1, hid)), cr, torch.from_numpy(tail))


def _check_act(act, pw, pts, dirs, Tr):
    """The emulated stash against the twin's values: the bf16 parts within
    one bf16 ulp of the unrounded value plus RTOL_BF16 of their largest,
    the f32 ones within RTOL_BF16 (RTOL_F32 in 'f32') of their largest;
    the tail's slot 6 the transmittance before each sample (Tr, the twin's
    in the mode) within RTOL_BF16, slot 7 zero. (_run reads the stash in
    ray_march.unpack_act's layout: the library's own must agree.)"""
    outs, st = PP._forward(pw, pts, dirs, True)
    want = PP.stash_activations(pw.rcfg, outs, st, bf16=False)
    sx, cr, tail = _act_segments(act, pw)
    skip = pw.rcfg.sdf.skip_in
    sx16 = pw.rcfg.march_bwd_precision == "bf16"
    for l, sp in enumerate(want.sp):
        if sx16:   # the next layer's input, times 1/sqrt(2) before the skip
            v = sp * PP._INV_SQRT2 if l + 1 in skip else sp
            err = (sx[:, l, :v.shape[1]] - v).abs()
            tol = 2.0 ** -8 * v.abs() + RTOL_BF16 * float(v.abs().max())
            assert bool((err <= tol).all()), f"stash sdf {l}: {float((err - tol).max()):.3e}"
        else:
            limit = RTOL_F32 if pw.rcfg.march_bwd_precision == "f32" else RTOL_BF16
            assert EM._rel(sx[:, l, :sp.shape[1]], sp) <= limit, f"stash sp {l}"
    for j, v in enumerate(want.cs + want.rs):
        err = (cr[:, j, :v.shape[1]] - v).abs()
        tol = 2.0 ** -8 * v.abs() + RTOL_BF16 * float(v.abs().max())
        assert bool((err <= tol).all()), f"stash bf16 slot {j}: {float((err - tol).max()):.3e}"
    for name, (a, b), x in (("gc", (0, 3), outs[2]), ("delta", (3, 6), outs[4])):
        assert EM._rel(tail[:, a:b], x) <= RTOL_BF16 or float(x.abs().max()) == 0.0, \
            f"tail {name}"
    assert EM._rel(tail[:, 6], Tr) <= RTOL_BF16, "tail T"
    assert float(tail[:, 7].abs().max()) == 0.0


@pytest.mark.parametrize("kind", ["color_neus", "neus"])
@pytest.mark.parametrize("mode", ["f32stash", *PREC])
def test_act_bytes_match_the_library_layout(tmp_path, mode, kind):
    """ray_march's stash layout (act_row_bytes, act_cr_slots, act_bytes,
    march_stash_bytes: the activation stash and the 8-float outs stash)
    against the kernels' own (csrc/point_pipeline_tile.cuh act_layout,
    act_cr_offset) in each MARCH_BWD_PRECISION mode: the row's bytes, the
    tail's place after the SDF part (its slot 6 holds T), the cr slots
    whose [256][64] bf16 images of each 64-point tile follow the rows from
    a 1024-byte boundary; at 128 samples a ray (full tiles) the bytes a
    point are the row and the slots' 512 each, at 300 the last tile's 20
    padding points take their images' bytes too. (The emulated save cases
    hold ray_march.act_total_bytes against the library's
    ray_march_act_total_bytes.)"""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    color = (ColorConfig(mode="no_view_dir", d_in=6, multires_view=0) if kind == "color_neus"
             else ColorConfig())
    rcfg = RendererConfig(kind=kind, color=color, march_bwd_precision=mode)
    n_sdf, n_color, n_relight = RM._net_counts(rcfg)
    src = tmp_path / "layout.cpp"
    src.write_text('#include <cstdio>\n#include "cuda_runtime.h"\n'
                   '#include "point_pipeline_tile.cuh"\nint main() {\n'
                   f"  const ActLayout a = act_layout(Shape{{{n_sdf}, -1, {n_color}, {n_relight}, "
                   "-1}, PP_PREC);\n  printf(\"%d %d %d %lld\", a.bytes, a.tail, a.n_cr, "
                   "act_cr_offset(1001, a));\n}\n")
    exe = tmp_path / "layout"
    proc = subprocess.run([cxx, "-std=c++20", "-pthread", "-Wno-unknown-pragmas",
                           f"-DPP_PREC={({'f32stash': 0} | PREC)[mode]}", "-I", CUDA_EMU, "-I",
                           CSRC, "-x", "c++", str(src), "-o", str(exe)],
                          capture_output=True, text=True)
    if proc.returncode != 0 and "barrier" in proc.stderr:
        pytest.skip("the host compiler lacks C++20 <barrier>")
    assert proc.returncode == 0, proc.stderr[-3000:]
    row, tail, n_cr, cr_off = (int(v) for v in subprocess.run(
        [str(exe)], capture_output=True, text=True, check=True).stdout.split())
    assert RM.act_row_bytes(rcfg) == row and RM.act_cr_slots(rcfg) == n_cr
    assert tail == row - 32
    assert cr_off == -(-1001 * row // 1024) * 1024 >= 1001 * row
    lib_bytes = row + n_cr * PP.HID * 2
    assert RM.act_bytes(rcfg) == lib_bytes
    assert RM.march_stash_bytes(rcfg, 1000) == 1000 * (lib_bytes + RM.STASH * 4)
    assert RM.march_stash_bytes(rcfg, 1024 * 128, 128) == RM.march_stash_bytes(rcfg, 1024 * 128)
    assert (RM.march_stash_bytes(rcfg, 300, 300) - RM.march_stash_bytes(rcfg, 300)
            == 20 * n_cr * PP.HID * 2 + -(-300 * row // 1024) * 1024 - 300 * row)


@pytest.mark.parametrize("kind", ["color_neus", "neus"])
@pytest.mark.parametrize("mode", ["f32stash", *PREC])
def test_scratch_floats_match_what_each_entry_writes(tmp_path, mode, kind):
    """The per-block scratch the library reports for each entry
    (ray_march_fwd_scratch_floats / ray_march_bwd_scratch_floats, what the
    wrapper allocates) against what the entry's compiled layout writes,
    in each MARCH_BWD_PRECISION mode: the forward's gates ([n_sdf - 1]
    [128][256]; none in the save entry where its stash keeps the softplus
    in f32, from which the reverse sweep rebuilds them) and features
    ([128][256]) and, in 'f32', hp_product's stage; the backward's f32
    part (the recompute's gates, features, tangent pre-gates and colour /
    relight inputs; the load entry's tangent pre-gates alone: it reads the
    rest from its stash), rounded up to 256 floats, then dw_batch tiles'
    weight-grad store and the group scratch. The harness sizes the
    emulated entries' scratch so, with a
    guard after it that no entry may write (harness_march.cpp)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    color = (ColorConfig(mode="no_view_dir", d_in=6, multires_view=0) if kind == "color_neus"
             else ColorConfig())
    rcfg = RendererConfig(kind=kind, color=color, march_bwd_precision=mode)
    n_sdf, n_color, n_relight = RM._net_counts(rcfg)
    _, skip, _ = PP._check_kernel_shape(rcfg)
    y_in = rcfg.relight.y_in_layer if kind == "color_neus" else -1
    S, batch = 100, 3
    net = f"{n_sdf}, {skip}, {n_color}, {n_relight}, {y_in}"
    with open(os.path.join(CSRC, "ray_march.cu")) as f:
        body = re.sub(r"<<<.*?>>>", "", f.read(), flags=re.S)
    main = f"""
#include <cstdio>
namespace {{
unsigned char smem[16];
}}
int main() {{
  printf("%lld %lld %lld %lld %lld %lld", ray_march_fwd_scratch_floats({n_sdf}, 0),
         ray_march_fwd_scratch_floats({n_sdf}, 1),
         ray_march_bwd_scratch_floats({net}, {S}, {batch}, 0),
         ray_march_bwd_scratch_floats({net}, {S}, {batch}, 1), dw_tile_bytes(Shape{{{net}}}),
         group_scratch_floats(rays_per_group({S}), {S}));
}}
"""
    src = tmp_path / "scratch.cpp"
    src.write_text(body + main)
    exe = tmp_path / "scratch"
    proc = subprocess.run([cxx, "-std=c++20", "-pthread", "-Wno-unknown-pragmas",
                           f"-DPP_PREC={({'f32stash': 0} | PREC)[mode]}", "-I", CUDA_EMU, "-I",
                           CSRC, "-x", "c++", str(src), "-o", str(exe)],
                          capture_output=True, text=True)
    if proc.returncode != 0 and "barrier" in proc.stderr:
        pytest.skip("the host compiler lacks C++20 <barrier>")
    assert proc.returncode == 0, proc.stderr[-3000:]
    fwd_rec, fwd_save, bwd_rec, bwd_load, dw_tile, group = (
        int(v) for v in subprocess.run([str(exe)], capture_output=True, text=True,
                                       check=True).stdout.split())
    hid, rows, tile, lds = PP.HID, FWD_ROWS, 64, PP.HID + 48
    stage = 2 * tile * (hid + 64) if mode == "f32" else 0   # hp_product's stage (HS_FLOATS)
    assert fwd_rec == n_sdf * rows * hid + stage
    assert fwd_save == (n_sdf if mode == "bf16" else 1) * rows * hid + stage

    def rup(n):
        return -(-n // 256) * 256
    rec_f32 = rup((2 * (n_sdf - 1) + 1) * tile * hid + (n_color + n_relight) * tile * lds)
    assert bwd_rec == rec_f32 + batch * dw_tile // 4 + group
    assert bwd_load == rup((n_sdf - 1) * tile * hid) + batch * dw_tile // 4 + group


MARCH_CASES = [EM.CASES[0], EM.CASES[1]]
MARCH_IDS = [EM.IDS[0], EM.IDS[1]]
# the save pair's other cases: rays packed several to a forward tile, and
# a ray over three forward tiles (the compositing's carry from tile to tile)
SAVE_MORE = EM.SAVE_CASES[2:]
SAVE_MORE_IDS = EM.SAVE_IDS[2:]


@pytest.mark.parametrize("save", [False, True], ids=["recompute", "save"])
@pytest.mark.parametrize("kind,R,S,variance,noise,seed", MARCH_CASES, ids=MARCH_IDS)
@pytest.mark.parametrize("mode", list(PREC))
def test_emulated_march_mode_matches_its_twin(march_emulators, tmp_path, mode, kind, R, S,
                                              variance, noise, seed, save):
    """The march's pair (save: the save pair, its stash too) in the mode
    against the mode's twins, as tests/test_torch_ray_march_emulated.py
    holds f32stash; 'f32' forward lanes of the SDF (the eikonal sums)
    within RTOL_F32."""
    check_mode_case(march_emulators[mode], tmp_path, mode, kind, R, S, variance, noise, seed,
                    save, features=True)


@pytest.mark.parametrize("kind,R,S,variance,noise,seed", SAVE_MORE, ids=SAVE_MORE_IDS)
@pytest.mark.parametrize("mode", list(PREC))
def test_emulated_march_mode_save_cases(march_emulators, tmp_path, mode, kind, R, S, variance,
                                        noise, seed):
    """The save pair in the mode on the rest of the f32stash file's save
    cases (several rays a forward tile; a 300-sample ray whose compositing
    carries T and the sums over three forward tiles, the last partial): its
    out lanes and the stash tail's T against the mode's twins as above, and
    its backward against the save twins (the backward on the twin's stash:
    in 'bf16' the load rebuilds the gates from the stash's bf16 values,
    which at inv_s ~2000 move the SDF leaves past the recompute twin's
    limits)."""
    check_mode_case(march_emulators[mode], tmp_path, mode, kind, R, S, variance, noise, seed,
                    True, features=False, stash_twins=True)


def check_mode_case(emu, tmp_path, mode, kind, R, S, variance, noise, seed, save, features,
                    stash_twins=False, blocks=2):
    """One case of the march's pair in the mode against its twins;
    features: also the 'f32' SDF features from the forward's scratch (every
    ray group one forward tile, a block each); stash_twins: the backward
    against the save twins (ray_march_bwd_plain on ray_march_plain's save
    stash, in f32 and float64) instead of the recompute twins; blocks: the
    emulated grid."""
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
    assert float(relu_margin(pw64, pts.double(), dirs.double()).min()) > EM.MARGIN

    res = EM._run(emu, tmp_path, pw, ro, rd, z, float(inv_s), sd, gbar, blocks=blocks, save=save)
    out, stash, rays_hat, s_hat, grads = res[:5]
    if mode == "f32" and features:   # every ray group one forward tile, a block each
        G = max(FWD_ROWS // S, 1)
        assert G * S <= FWD_ROWS and -(-R // G) <= 2
        q = np.arange(R * S)
        feat = kernel_features(tmp_path, 2, len(pw.sdf), ((q // S) // G, q - (q // S) // G * G * S),
                               gates=not save)
        for name, net, p, dr in (("twin", pw, pts, dirs),
                                 ("float64 twin", pw64, pts.double(), dirs.double())):
            err = EM._rel(feat.to(p.dtype), twin_sdf_outputs(net, p, dr)[1])
            print(f"f32 {kind} R{R}xS{S}: features {err:.3e} from the {name}")
            assert err <= RTOL_F32, f"features {err:.3e} from the {name}"
    outs = PP.point_pipeline_plain(pw, pts, dirs, bf16=True)
    if save:
        _check_act(res[5], pw, pts, dirs, RM.composite(outs, rd, dists, pts, inv_s).Tr.reshape(-1))
    want = torch.cat([outs[0], outs[1], outs[3], outs[4].sum(dim=1, keepdim=True)], dim=1)
    for name, (a, b) in (("sdf", (0, 1)), ("grad", (1, 4)), ("relit", (4, 7)), ("delta", (7, 8))):
        limit = RTOL_F32 if mode == "f32" and name in ("sdf", "grad") else RTOL_BF16
        assert EM._rel(stash[:, a:b], want[:, a:b]) <= limit, f"stash {name}"
    plain_out = RM.ray_march_plain(pw, ro, rd, z, inv_s, sd, bf16=True)
    for name, (a, b) in chip_smoke.MARCH_LANES.items():
        limit = RTOL_F32 if mode == "f32" and name == "eikonal" else RTOL_BF16
        assert EM._rel(out[:, a:b], plain_out[:, a:b]) <= limit, f"out {name}"
    args64 = (ro.double(), rd.double(), z.double(), inv_s.double(), sd)
    st64 = st32 = None
    if stash_twins:
        st64 = RM.ray_march_plain(pw64, *args64, bf16=True, save=True)[1]
        st32 = RM.ray_march_plain(pw, ro, rd, z, inv_s, sd, bf16=True, save=True)[1]
    ref = RM.ray_march_bwd_plain(pw64, *args64, gbar.double(), bf16=True, stash=st64)
    plain = RM.ray_march_bwd_plain(pw, ro, rd, z, inv_s, sd, gbar, bf16=True, stash=st32)
    EM._close(rays_hat[:, 0:3], plain[0], ref[0], "rays_o")
    EM._close(rays_hat[:, 4:7], plain[1], ref[1], "rays_d")
    EM._close(s_hat.reshape(1), plain[2].reshape(1), ref[2].reshape(1), "inv_s")
    for net, layers in ref[3].items():
        assert len(grads[net]) == len(layers)
        for l, ((a, b), (pa, pb), (e, f)) in enumerate(zip(grads[net], plain[3][net], layers)):
            EM._close(a, pa, e, f"{net} layer {l} W")
            EM._close(b, pb, f, f"{net} layer {l} b")


@pytest.mark.parametrize("mode", list(PREC))
def test_emulated_march_mode_load_flushes_three_times(march_emulators, tmp_path, mode):
    """The save pair in the mode on one block that flushes three batches of
    weight grads into its partial (tests/test_torch_ray_march_emulated.py's
    FLUSH3: three 128-sample rays, six tiles at 2 a batch), against the
    save twins as above."""
    kind, R, S, variance, noise, seed = EM.FLUSH3
    check_mode_case(march_emulators[mode], tmp_path, mode, kind, R, S, variance, noise, seed,
                    True, features=False, stash_twins=True, blocks=1)
