"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marker `cuda`; every test skips without a card (the kernels have no CPU
mode). This file imports neither jax nor the JAX package, so it also runs
on a GPU machine without them:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(--noconftest: tests/conftest.py sets up JAX for the CPU suites.)"""

import numpy as np
import pytest
import torch

from chip_smoke import ATOL_GRID, RTOL_PIPELINE, _nrel
from color_neus_torch import pin_precision
from color_neus_torch.models.configs import SDFConfig
from color_neus_torch.models.fields import init_sdf
from color_neus_torch.ops.kernels import sdf_rays as K

pin_precision()


def _inputs(R, S, seed=0, z_range=(1.0, 3.4)):
    rng = np.random.RandomState(seed)
    d = rng.randn(R, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = (-2.2 * d + 0.1 * rng.randn(R, 3)).astype(np.float32)
    z = np.sort(rng.uniform(*z_range, (R, S)), axis=1).astype(np.float32)
    return o, d, z


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["softplus", "relu"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_kernel_matches_plain(cuda_device, act, dtype):
    cfg = SDFConfig()
    g = torch.Generator(device=cuda_device).manual_seed(0)
    p = init_sdf(cfg, g, cuda_device)
    # off the geometric init, which zeroes the PE columns of lin0 and of the
    # skip layer: with noise on every leaf, every weight the kernel reads matters
    with torch.no_grad():
        for leaf in p.parameters():
            leaf.add_(0.02 * torch.randn(leaf.shape, generator=g, device=cuda_device))
    fn = K.make_fused_sdf_rays_fn(p, cfg, dtype, act)
    # the last case's points reach |p| ~ 1.8, as the main path's rays do
    # (its pre-activations cross 0.87 < |x| < 1.04, where the softplus's
    # log term is denormal)
    for R, S, z_range in ((1024, 64, (1.0, 3.4)), (1000, 37, (1.0, 3.4)),
                          (1024, 64, (0.4, 4.0))):
        o, d, z = (torch.from_numpy(x).to(cuda_device) for x in _inputs(R, S, R, z_range))
        before = K.launch_sdf_rays.launches
        got = fn(o, d, z)
        torch.cuda.synchronize()
        assert K.launch_sdf_rays.launches == before + 1
        want = K.sdf_rays_plain(fn.weights, o, d, z)
        # chip_smoke.py ATOL, set from the card's readings: f32 summation
        # order only; bf16 one-ulp flips of layer inputs, which propagate
        atol = 2e-6 if dtype == "float32" else 3e-3
        torch.testing.assert_close(got, want, rtol=0, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("prec", ["f32", "bf16", "f32x3"])
def test_cuda_grid_sdf_matches_plain(cuda_device, prec):
    from color_neus_torch.ops.kernels import sdf_mlp
    cfg = SDFConfig()
    g = torch.Generator(device=cuda_device).manual_seed(1)
    p = init_sdf(cfg, g, cuda_device)
    with torch.no_grad():
        for leaf in p.parameters():
            leaf.add_(0.02 * torch.randn(leaf.shape, generator=g, device=cuda_device))
    fn = sdf_mlp.make_fused_sdf_fn(p, cfg, prec)
    # the last case's points reach |p| ~ 1.8, the main path's reach
    for n, reach in ((1 << 16, 1.0), (1001, 1.0), (1 << 16, 1.05)):
        pts = reach * (2.0 * torch.rand((n, 3), generator=g, device=cuda_device) - 1.0)
        before = sdf_mlp.launch_sdf_points.launches
        got = fn(pts)
        torch.cuda.synchronize()
        assert sdf_mlp.launch_sdf_points.launches == before + 1
        want = sdf_mlp.sdf_points_plain(fn.weights, pts)
        # chip_smoke.py ATOL_GRID, set from the card's readings (f32x3: from
        # the split's own error, test_torch_mesh.py)
        torch.testing.assert_close(got, want, rtol=0, atol=ATOL_GRID[prec])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["color_neus", "neus"])
def test_cuda_point_pipeline_matches_plain(cuda_device, kind):
    from color_neus_torch.models.configs import ColorConfig, RendererConfig
    from color_neus_torch.models.neus import init_renderer
    from color_neus_torch.ops.kernels import point_pipeline as PP
    color = ColorConfig(mode="no_view_dir", d_in=6, multires_view=0) \
        if kind == "color_neus" else ColorConfig()
    rcfg = RendererConfig(kind=kind, color=color)
    g = torch.Generator(device=cuda_device).manual_seed(2)
    params = init_renderer(rcfg, g, cuda_device)
    with torch.no_grad():
        for leaf in params.parameters():
            leaf.add_(0.02 * torch.randn(leaf.shape, generator=g, device=cuda_device))
    pw = PP.resolve_pipeline_weights(params, rcfg)
    for n in (1 << 14, 999):
        pts = 0.6 * torch.randn((n, 3), generator=g, device=cuda_device)
        d = torch.randn((n, 3), generator=g, device=cuda_device)
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        before = PP.launch_point_pipeline.launches
        got = PP.fused_point_pipeline_fwd(params, rcfg, pts, d, weights=pw)
        torch.cuda.synchronize()
        assert PP.launch_point_pipeline.launches == before + 1
        # the kernel's bf16 products against the bf16 twin, at chip_smoke.py's
        # RTOL_PIPELINE, set from the card's readings
        want = PP.point_pipeline_plain(pw, pts, d, bf16=True)
        for name, a, b in zip(("sdf", "grad", "gc", "relit", "delta"), got, want):
            assert _rel(a, b.double()) <= RTOL_PIPELINE["max"][name], name
            assert _nrel(a, b) <= RTOL_PIPELINE["norm"], name


def _f64(pw):
    from color_neus_torch.ops.kernels import point_pipeline as PP
    return PP.PipelineWeights(pw.rcfg, *[[(w.double(), b.double()) for w, b in layers]
                                         for layers in (pw.sdf, pw.color, pw.relight)])


def _rel(a, b):
    return float((a.double() - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["color_neus", "neus"])
def test_cuda_point_pipeline_bwd_matches_plain(cuda_device, kind):
    """Row 6 against the plain backward with bf16=True (the kernel's bf16
    products) in float64, with the cotangents of the points near a relu
    kink zeroed (a mask flip between two paths would move their gradients),
    at most twice as far as the f32 bf16 twin plus chip_smoke.py's floor,
    max- and norm-relative (phase 2c's rule and limits, set from the card's
    readings)."""
    from chip_smoke import KINK_MARGIN, RTOL_BWD_FLOOR, bwd_errors, relu_margin
    from color_neus_torch.models.configs import ColorConfig, RendererConfig
    from color_neus_torch.models.neus import init_renderer
    from color_neus_torch.ops.kernels import point_pipeline as PP
    color = ColorConfig(mode="no_view_dir", d_in=6, multires_view=0) \
        if kind == "color_neus" else ColorConfig()
    rcfg = RendererConfig(kind=kind, color=color)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    params = init_renderer(rcfg, g, cuda_device)
    with torch.no_grad():
        for leaf in params.parameters():
            leaf.add_(0.02 * torch.randn(leaf.shape, generator=g, device=cuda_device))
    pw = PP.resolve_pipeline_weights(params, rcfg)
    pw64 = _f64(pw)
    for n in (1 << 12, 999):
        pts = (0.6 * torch.randn((n, 3), generator=g, device=cuda_device)).contiguous()
        d = torch.randn((n, 3), generator=g, device=cuda_device)
        d = (d / torch.linalg.norm(d, dim=-1, keepdim=True)).contiguous()
        keep = (relu_margin(pw64, pts.double(), d.double()) > KINK_MARGIN).float()
        cots = [torch.randn((n, k), generator=g, device=cuda_device) * keep[:, None]
                for k in (1, 3, 3, 3, 3)]
        gbar = torch.cat(cots + [torch.zeros((n, 3), device=cuda_device)], 1).contiguous()
        before = PP.launch_point_pipeline_bwd.launches
        ph, dh, packed = PP.launch_point_pipeline_bwd(pw, pts, d, gbar)
        torch.cuda.synchronize()
        assert PP.launch_point_pipeline_bwd.launches == before + 1
        ref = PP.point_pipeline_bwd_plain(pw64, pts.double(), d.double(),
                                          [c.double() for c in cots], bf16=True)
        twin = PP.point_pipeline_bwd_plain(pw, pts, d, cots, bf16=True)
        mine = (ph, dh, PP._unpack_grads(pw, packed))
        for metric in (None, _nrel):
            k_err, t_err = bwd_errors(mine, ref, metric)[0], bwd_errors(twin, ref, metric)[0]
            for k, e in k_err.items():
                assert e <= 2.0 * t_err[k] + RTOL_BWD_FLOOR[k], (k, e, t_err[k])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["color_neus", "neus"])
def test_cuda_march_save_pair_equals_recompute_pair(cuda_device, kind):
    """Rows 3 and 4's save entries against their recompute entries on the
    same inputs: the forward writes the activation stash
    (ray_march.act_total_bytes) and the backward that loads it gives the
    recompute's outputs and gradients bitwise (each point's activations
    are the same arithmetic in a 128-point forward tile and a 64-point
    recompute tile; chip_smoke.py phase 2d read 0 on every leaf). 128-sample
    rays and 27-sample rays packed into tiles, a ragged count."""
    from chip_smoke import march_inputs
    from color_neus_torch.ops.kernels import ray_march as RM
    rcfg, pw, *_ = march_inputs(cuda_device, kind, 0.3, 8)
    g = torch.Generator(device=cuda_device).manual_seed(9)
    sd = 2.0 / rcfg.n_samples
    inv_s = torch.full((1,), 20.0, device=cuda_device)
    for R, S in ((64, 128), (37, 27)):
        d = torch.randn((R, 3), generator=g, device=cuda_device)
        d = (d / torch.linalg.norm(d, dim=-1, keepdim=True)).contiguous()
        o = (-1.4 * d + 0.1 * torch.randn((R, 3), generator=g, device=cuda_device)).contiguous()
        z = (0.5 + 1.8 * torch.sort(torch.rand((R, S), generator=g, device=cuda_device),
                                    dim=-1).values).contiguous()
        gbar = torch.randn((R, 16), generator=g, device=cuda_device)
        gbar[:, 7:] = 0.0
        out, stash = RM.launch_ray_march(pw, o, d, z, inv_s, sd)
        rec = RM.launch_ray_march_bwd(pw, o, d, z, inv_s, sd, stash, gbar.contiguous())
        before = (RM.launch_ray_march_save.launches, RM.launch_ray_march_bwd_load.launches)
        out_s, stash_s, act = RM.launch_ray_march_save(pw, o, d, z, inv_s, sd)
        sav = RM.launch_ray_march_bwd_load(pw, o, d, z, inv_s, sd, stash_s, act,
                                           gbar.contiguous())
        torch.cuda.synchronize()
        assert (RM.launch_ray_march_save.launches, RM.launch_ray_march_bwd_load.launches) == \
            (before[0] + 1, before[1] + 1)
        assert tuple(act.shape) == (RM.act_total_bytes(pw, R, S),)
        assert torch.equal(out_s, out) and torch.equal(stash_s, stash)
        assert all(torch.equal(a, b) for a, b in zip(sav, rec))


@pytest.mark.cuda
def test_cuda_backward_deterministic(cuda_device):
    """Rows 4 and 6 sum their per-block weight-grad partials in a fixed
    order (no float atomics): two identical backward calls give bitwise
    equal weight grads and input grads."""
    from chip_smoke import march_inputs
    from color_neus_torch.ops.kernels import point_pipeline as PP
    from color_neus_torch.ops.kernels import ray_march as RM
    rcfg, pw, o, d, z, inv_s, gbar = march_inputs(cuda_device, "color_neus", 0.3, 6)
    sd = 2.0 / rcfg.n_samples
    o, d, z, gbar = o[:256], d[:256], z[:256].contiguous(), gbar[:256].contiguous()
    _, stash = RM.launch_ray_march(pw, o, d, z, inv_s, sd)
    runs = [RM.launch_ray_march_bwd(pw, o, d, z, inv_s, sd, stash, gbar) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    _, _, pts, dirs = RM.march_points(o, d, z, sd)
    g = torch.Generator(device=cuda_device).manual_seed(7)
    gb = torch.randn((pts.shape[0], 16), generator=g, device=cuda_device)
    gb[:, 13:] = 0.0
    runs = [PP.launch_point_pipeline_bwd(pw, pts, dirs, gb.contiguous()) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
def test_cuda_train_loop_fused_core_on(cuda_device):
    """Three full-width steps through the point-pipeline kernels: each step
    launches the forward and the backward once and the sweep 4 times."""
    from chip_smoke import SMOKE_CFG
    from color_neus_torch.ops.kernels import point_pipeline as PP
    from color_neus_torch.ops.kernels.sdf_rays import launch_sdf_rays
    from color_neus_torch.runtime import TrainLoop
    from color_neus_torch.utils.config import config_from_dict
    model = SMOKE_CFG["MODEL"]
    cfg = config_from_dict({**SMOKE_CFG, "MODEL": {
        **model, "RENDERER": {**model["RENDERER"], "FUSED_CORE": "on"}}})
    loop = TrainLoop(cfg, device=cuda_device)
    fns = (PP.launch_point_pipeline, PP.launch_point_pipeline_bwd, launch_sdf_rays)
    before = [fn.launches for fn in fns]
    losses = loop.run(3)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(losses).all()) and losses.shape == (3,)
    assert [fn.launches - b for fn, b in zip(fns, before)] == [3, 3, 12]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["color_neus", "neus"])
def test_cuda_ray_march_matches_plain(cuda_device, kind):
    """Rows 3 and 4 against their plain twins with bf16=True on the card:
    the forward per lane group against the f32 bf16 twin; the backward
    against the composed reference (row 5's outputs, the plain compositing
    VJP, row 6's pullback) and against the bf16 twin in float64, at
    chip_smoke.py's phase 2d tolerances, set from the card's readings.
    128-sample rays (two tiles each) and 27-sample rays packed two to a
    tile, a ragged count."""
    from chip_smoke import (MARCH_LANES, RTOL_MARCH_F64_FLOOR, RTOL_MARCH_FWD_FLOOR,
                            RTOL_MARCH_TIGHT, _composed, march_bwd_errors, march_inputs)
    from color_neus_torch.ops.kernels import point_pipeline as PP
    from color_neus_torch.ops.kernels import ray_march as RM
    rcfg, pw, *_ = march_inputs(cuda_device, kind, 0.3, 4)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    sd = 2.0 / rcfg.n_samples
    inv_s = torch.full((1,), 20.0, device=cuda_device)
    for R, S in ((64, 128), (37, 27)):
        d = torch.randn((R, 3), generator=g, device=cuda_device)
        d = (d / torch.linalg.norm(d, dim=-1, keepdim=True)).contiguous()
        o = (-1.4 * d + 0.1 * torch.randn((R, 3), generator=g, device=cuda_device)).contiguous()
        z = (0.5 + 1.8 * torch.sort(torch.rand((R, S), generator=g, device=cuda_device),
                                    dim=-1).values).contiguous()
        gbar = torch.randn((R, 16), generator=g, device=cuda_device)
        gbar[:, 7:] = 0.0
        before = (RM.launch_ray_march.launches, RM.launch_ray_march_bwd.launches)
        out, stash = RM.launch_ray_march(pw, o, d, z, inv_s, sd)
        ro_hat, rd_hat, s_hat, packed = RM.launch_ray_march_bwd(pw, o, d, z, inv_s, sd, stash,
                                                                gbar.contiguous())
        torch.cuda.synchronize()
        assert (RM.launch_ray_march.launches, RM.launch_ray_march_bwd.launches) == \
            (before[0] + 1, before[1] + 1)
        pw64 = _f64(pw)
        args64 = (o.double(), d.double(), z.double(), inv_s.double(), sd)
        want = RM.ray_march_plain(pw64, *args64, bf16=True)
        twin = RM.ray_march_plain(pw, o, d, z, inv_s, sd, bf16=True)
        for name, (a, b) in MARCH_LANES.items():
            for metric, floor in ((_rel, "max"), (_nrel, "norm")):
                lim = 2.0 * metric(twin[:, a:b], want[:, a:b]) + RTOL_MARCH_FWD_FLOOR[floor]
                assert metric(out[:, a:b], want[:, a:b]) <= lim, name
        kern = (ro_hat, rd_hat, s_hat, PP._unpack_grads(pw, packed))
        tight = march_bwd_errors(kern, RM.march_vjp(o, d, z, inv_s, sd, gbar, *_composed(pw)))
        for k, e in tight.items():
            assert e <= RTOL_MARCH_TIGHT[k], (k, e)
        ref = RM.ray_march_bwd_plain(pw64, *args64, gbar.double(), bf16=True)
        k64 = march_bwd_errors(kern, ref)
        p64 = march_bwd_errors(RM.ray_march_bwd_plain(pw, o, d, z, inv_s, sd, gbar, bf16=True),
                               ref)
        for k, e in k64.items():
            assert e <= 2.0 * p64[k] + RTOL_MARCH_F64_FLOOR[k], (k, e, p64[k])


@pytest.mark.cuda
def test_cuda_train_loop_fused_march_on(cuda_device):
    """Three full-width steps through the fused march: each step launches
    its save forward and load backward once (MARCH_ACTS auto: the save
    mode at this shape), the sweep 4 times, no point pipeline."""
    from chip_smoke import SMOKE_CFG
    from color_neus_torch.ops.kernels import point_pipeline as PP
    from color_neus_torch.ops.kernels import ray_march as RM
    from color_neus_torch.ops.kernels.sdf_rays import launch_sdf_rays
    from color_neus_torch.runtime import TrainLoop
    from color_neus_torch.utils.config import config_from_dict
    model = SMOKE_CFG["MODEL"]
    cfg = config_from_dict({**SMOKE_CFG, "MODEL": {
        **model, "RENDERER": {**model["RENDERER"], "FUSED_MARCH": "on"}}})
    loop = TrainLoop(cfg, device=cuda_device)
    fns = (RM.launch_ray_march_save, RM.launch_ray_march_bwd_load, launch_sdf_rays,
           PP.launch_point_pipeline, PP.launch_point_pipeline_bwd)
    before = [fn.launches for fn in fns]
    losses = loop.run(3)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(losses).all()) and losses.shape == (3,)
    assert [fn.launches - b for fn, b in zip(fns, before)] == [3, 3, 12, 0, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
def test_cuda_mlp_chain_matches_plain(cuda_device, bf16):
    """Rows 7 and 8 against their plain versions on the card, every
    variant, 4096 rows and a ragged 1000, at chip_smoke.py's phase 9
    tolerances, set from the card's readings: one layer (tight), the gates
    at the tool's 1e-30 and at 1.0; the tool's 25 layers at 1e-30, each
    variant at its own limit; the deferred chain's gate at 1.0 over two
    layers."""
    from chip_smoke import (ATOL_CHAIN_BF16, ATOL_CHAIN_DEFERRED_L2, ATOL_CHAIN_F32,
                            ATOL_CHAIN_TIGHT, CHAIN_L)
    from color_neus_torch.ops.kernels import mlp_chain as MC
    from color_neus_torch.tools.mlp_microbench import inputs
    dt = "bfloat16" if bf16 else "float32"
    x, w = inputs(64, 80, cuda_device)
    for xs in (x[:4096], x[7:1007]):
        for name, act in MC.ACTIVATIONS:
            runs = [(1, gw, ATOL_CHAIN_TIGHT[dt])
                    for gw in ((MC.GATE_W, 1.0) if name in MC.GATED else (MC.GATE_W,))]
            deep = ATOL_CHAIN_BF16[name] if bf16 else ATOL_CHAIN_F32
            counter = MC.launch_chain if bf16 else MC.launch_chain.f32
            for L, gw, atol in runs + [(CHAIN_L, MC.GATE_W, deep)]:
                before = counter.launches
                got = MC.launch_chain(xs, w, L, act, bf16, gw)
                torch.cuda.synchronize()
                assert counter.launches == before + 1
                want = MC.chain_plain(xs, w, L, act, bf16, gw)
                torch.testing.assert_close(got, want, rtol=0, atol=atol,
                                           msg=f"{name} gate {gw} L {L} rows {xs.shape[0]}")
        if bf16:
            for L, gw, atol in ((2, 1.0, ATOL_CHAIN_DEFERRED_L2),
                                (CHAIN_L, MC.GATE_W, ATOL_CHAIN_BF16["deferred"])):
                before = MC.launch_chain_deferred.launches
                got = MC.launch_chain_deferred(xs, w, L, gw)
                torch.cuda.synchronize()
                assert MC.launch_chain_deferred.launches == before + 1
                torch.testing.assert_close(got, MC.chain_deferred_plain(xs, w, L, gw), rtol=0,
                                           atol=atol, msg=f"deferred gate {gw} L {L}")


def _replay_equals_steps(loop, captured):
    """Warm up, capture and replay; then, from one state, a replay equals
    BUNDLE uncaptured steps bitwise and runs the captured launches."""
    from chip_smoke import BUNDLE, restore, state_tensors, tensors_distance
    assert loop.k_steps == BUNDLE
    loop.run(2 * BUNDLE)
    ms = loop.multi_step
    assert ms.graph is not None and ms.replays == 1
    assert dict(ms.captured) == captured
    step, s0 = loop.state.step, state_tensors(loop)
    losses = torch.stack([loop.training_step()["loss"] for _ in range(BUNDLE)])
    eager = dict(state_tensors(loop), losses=losses)
    restore(loop, s0, step)
    _, losses = loop.training_bundle()
    assert ms.replays == 2 and loop.state.step == step + BUNDLE
    assert tensors_distance(eager, dict(state_tensors(loop), losses=losses))[0] == 0


@pytest.mark.cuda
def test_cuda_captured_sgd_bundle_equals_uncaptured_steps(cuda_device):
    """OPTIMIZE.TYPE sgd captures (DeviceSGD reads its lr on the device):
    the fused march's bundle replayed bitwise equal to 10 uncaptured steps."""
    from chip_smoke import BUNDLE, sgd_cfg
    from color_neus_torch.runtime import TrainLoop
    loop = TrainLoop(sgd_cfg(), device=cuda_device)
    _replay_equals_steps(loop, {"sdf_rays": 4 * BUNDLE, "ray_march_save": BUNDLE,
                                "ray_march_bwd_load": BUNDLE})


@pytest.mark.cuda
def test_cuda_captured_chunked_bundle_equals_uncaptured_steps(cuda_device):
    """RAY_CHUNK 256 on the plain core (fused_march auto): the chunks'
    checkpointed recomputation captures (no RNG state read), and a replay
    equals 10 uncaptured steps bitwise."""
    from chip_smoke import BUNDLE, arm_cfg
    from color_neus_torch.runtime import TrainLoop
    loop = TrainLoop(arm_cfg("auto_chunked"), device=cuda_device)
    assert loop.tcfg.renderer.ray_chunk == 256
    _replay_equals_steps(loop, {"sdf_rays": 4 * BUNDLE})


@pytest.mark.cuda
def test_cuda_captured_bundle_equals_uncaptured_steps(cuda_device):
    """Full-width fused march, bundles of 10: the loop warms up, captures
    and replays; then, from one state, a replay of the captured bundle
    equals 10 uncaptured steps bitwise (parameters, Adam's state, the step
    counter, the generator, the losses), and each replay runs the captured
    launches (4 sweeps, one march save forward and load backward a step)."""
    from chip_smoke import BUNDLE, arm_cfg, restore, state_tensors, tensors_distance
    from color_neus_torch.runtime import TrainLoop
    loop = TrainLoop(arm_cfg("fused_march"), device=cuda_device)
    assert loop.k_steps == BUNDLE
    loop.run(2 * BUNDLE)
    ms = loop.multi_step
    assert ms.graph is not None and ms.replays == 1
    assert dict(ms.captured) == {"sdf_rays": 4 * BUNDLE, "ray_march_save": BUNDLE,
                                 "ray_march_bwd_load": BUNDLE}
    step, s0 = loop.state.step, state_tensors(loop)
    losses = torch.stack([loop.training_step()["loss"] for _ in range(BUNDLE)])
    eager = dict(state_tensors(loop), losses=losses)
    restore(loop, s0, step)
    _, losses = loop.training_bundle()
    assert ms.replays == 2 and loop.state.step == step + BUNDLE
    assert tensors_distance(eager, dict(state_tensors(loop), losses=losses))[0] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "f32"])
def test_cuda_bwd_precision_modes(cuda_device, mode):
    """MARCH_BWD_PRECISION's instantiations of rows 3-6 launch from their
    own library and count under their own suffix; rows 5 and 3 of 'bf16'
    equal f32stash's bitwise (the same forward code); the sdf and grad of 'f32'
    sit within 1e-4 of the f32 twin in that mode (its SDF chain is f32; the
    bf16 kernels read ~5e-3), and its save pair equals its recompute pair
    bitwise (hp_product sums each output in the same pass and k order
    whatever the tile)."""
    import dataclasses
    from chip_smoke import march_inputs
    from color_neus_torch.ops.kernels import point_pipeline as PP
    from color_neus_torch.ops.kernels import ray_march as RM
    rcfg, pw0, o, d, z, inv_s, gbar = march_inputs(cuda_device, "color_neus", 0.3, 12)
    R = 96
    o, d, z, gbar = o[:R], d[:R], z[:R].contiguous(), gbar[:R].contiguous()
    sd = 2.0 / rcfg.n_samples
    pw = PP.PipelineWeights(dataclasses.replace(rcfg, march_bwd_precision=mode), pw0.sdf,
                            pw0.color, pw0.relight)
    pw.packed, pw.off, pw.n_grad = PP._pack(pw)
    _, _, pts, dirs = RM.march_points(o, d, z, sd)
    fns = (PP.launch_point_pipeline, RM.launch_ray_march, RM.launch_ray_march_bwd,
           RM.launch_ray_march_save, RM.launch_ray_march_bwd_load)
    before = [fn.modes[mode].launches for fn in fns] + [fn.launches for fn in fns]
    out = PP.launch_point_pipeline(pw, pts, dirs)
    got, stash = RM.launch_ray_march(pw, o, d, z, inv_s, sd)
    rec = RM.launch_ray_march_bwd(pw, o, d, z, inv_s, sd, stash, gbar)
    got_s, stash_s, act = RM.launch_ray_march_save(pw, o, d, z, inv_s, sd)
    sav = RM.launch_ray_march_bwd_load(pw, o, d, z, inv_s, sd, stash_s, act, gbar)
    torch.cuda.synchronize()
    after = [fn.modes[mode].launches for fn in fns] + [fn.launches for fn in fns]
    assert [a - b for a, b in zip(after, before)] == [1] * 5 + [0] * 5
    assert tuple(act.shape) == (RM.act_total_bytes(pw, R, z.shape[1]),)
    if mode == "bf16":
        assert torch.equal(out, PP.launch_point_pipeline(pw0, pts, dirs))
        assert torch.equal(got, RM.launch_ray_march(pw0, o, d, z, inv_s, sd)[0])
    else:
        want = PP.point_pipeline_plain(pw, pts, dirs, bf16=True)
        for k, i, (a, b) in (("sdf", 0, (0, 1)), ("grad", 1, (1, 4))):
            err = float((out[:, a:b] - want[i]).abs().max())
            assert err <= 1e-4 * float(want[i].abs().max()), (k, err)
        assert torch.equal(got_s, got)
        assert all(torch.equal(a, b) for a, b in zip(sav, rec))


@pytest.mark.cuda
def test_cuda_grad_audit_f32stash(cuda_device):
    """The evidence tool's audit (tools/grad_audit.py) at 64 rays x 128
    samples: the fused march (rows 3 + 4, the save mode) in f32stash against
    the f32 plain core on two batches; every group's statistics finite and
    its systematic error within twice the oracle's cross-batch floor."""
    from color_neus_torch.tools import grad_audit as GA
    rcfg = GA.audit_config("f32stash", n_samples=64, n_importance=64)
    rep = GA.audit(GA.init_params(rcfg, cuda_device), rcfg,
                   [GA.ray_batch(64, s) for s in GA.BATCH_SEEDS])
    assert rep["platform"] == "gpu" and rep["samples_per_ray"] == 128
    assert set(rep["groups"]) == {"color", "relight", "sdf", "variance"}
    for name, g in rep["groups"].items():
        assert all(np.isfinite(v) for v in g.values()), (name, g)
    assert rep["pass_2x_floor"], rep["groups"]
