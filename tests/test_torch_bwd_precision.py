"""MARCH_BWD_PRECISION 'bf16' and 'f32' in the port's plain twins, against
the TPU kernels' own arithmetic in the same mode, on the CPU at small
widths; the modes' agreement in f32 arithmetic; the knob's parse, the save
mode's stash size and policy per mode, and the main path's mode.

(a) As tests/test_torch_point_pipeline_bf16.py holds f32stash: JAX's kernel
    bodies run with bf16=True under interpret=True through test-local
    pl.pallas_calls, on cast_kernel_weights(meta, ws, False) (which keeps
    the SDF weights f32 in 'f32'), RendererConfig.march_bwd_precision the
    mode, THIN_DOTS vpu, compiled with xla_allow_excess_precision off; the
    port's twins run with bf16=True in the same mode on the same
    numpy-seeded inputs: the pipeline's forward and backward, and the
    march's forward and backward in the recompute and in the save mode (the
    JAX kernels' save_acts export and load), Color-NeuS and NeuS. Every
    output, pts / dirs (rays) cotangent and weight / bias leaf within RTOL
    norm-relative of JAX's run in the mode, and within a tenth of its gap
    where that run is more than GAP from JAX's f32 interpret run.
(b) In f32 arithmetic (bf16=False, JAX's interpret) the mode changes
    nothing: every mode equals f32stash to 1e-6 (the port's mirror of
    tests/test_ray_march.py test_march_bwd_precision_modes); with bf16
    products, 'bf16' and f32stash give bitwise equal forward outputs (the
    store dtype is the backward's and the save stash's alone).
(c) MARCH_BWD_PRECISION parses (a typo raises ValueError, as JAX's enum
    check); the save mode's stash bytes a point at the Color-NeuS widths of
    config/Color_NeuS_dtu.yml per mode (8,768 in 'bf16', 12,864 otherwise;
    NeuS 6,720 / 10,816) and JAX's march_stash_bytes' difference between
    the modes; 'auto' decides on JAX's count (policy_stash_bytes) and
    agrees with JAX's resolve_save_acts at each mode's flip point +-1;
    render_rays_train
    runs the resolved mode's twins (the save twins in 'bf16' at a budget
    that the f32stash stash overflows)."""

import dataclasses
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from color_neus_tpu.models import configs as jconfigs
from color_neus_tpu.models import neus as jneus
from color_neus_tpu.models.configs import renderer_config_from_cfg as jax_renderer_cfg
from color_neus_tpu.ops.pallas import point_pipeline as JPP
from color_neus_tpu.ops.pallas import ray_march as JRM
from color_neus_tpu.utils.config import get_config as jax_get_config

from color_neus_torch import pin_precision
from color_neus_torch.models import configs, neus
from color_neus_torch.ops.kernels import point_pipeline as PP
from color_neus_torch.ops.kernels import ray_march as RM
from color_neus_torch.ops.rays import near_far_from_sphere
from color_neus_torch.utils.config import get_config
from color_neus_torch.weights import state_from_numpy
from tests.test_ray_march import SMALL_COLOR, _rays_z
from tests.test_torch_point_pipeline import _params, _pts_dirs, _rcfg
from tests.test_torch_point_pipeline_bf16 import (CASES, GAP, RTOL, _const, _grads_to_dense,
                                                  _jax_pipeline, _jit, _leaves, _nrel, _vmem)
from tests.test_torch_point_pipeline_bwd import _cotangents
from tests.test_torch_ray_march import jax_params, port_cfg

torch.set_num_threads(1)
pin_precision()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTU = os.path.join(REPO, "config", "Color_NeuS_dtu.yml")
MODES = ("bf16", "f32")
AGREE = 1e-6
OUTS = ("sdf", "grad", "gc", "relit", "delta")


def _configs(kind, mode, prec):
    jr = dataclasses.replace(_rcfg(jconfigs, kind, mode), march_bwd_precision=prec,
                             thin_dots="vpu")
    return jr, dataclasses.replace(_rcfg(configs, kind, mode), march_bwd_precision=prec)


def _compare(port, jax16, jax32, tag):
    """As test_torch_point_pipeline_bf16._compare; prints the SDF leaves."""
    for k, j16 in jax16.items():
        err, gap = _nrel(port[k], j16), _nrel(j16, jax32[k])
        if k.startswith("sdf layer") or k in ("sdf", "grad"):
            print(f"{tag} {k}: {err:.2e} from JAX's run in the mode (its f32 gap {gap:.2e})")
        assert err <= RTOL, f"{k}: {err:.3e} from JAX's run in the mode, above {RTOL:g}"
        assert gap <= GAP or err < 0.1 * gap, \
            f"{k}: {err:.3e} from JAX's run in the mode, not below a tenth of its f32 gap {gap:.3e}"


@pytest.mark.parametrize("prec", MODES)
@pytest.mark.parametrize("kind,mode", CASES, ids=[k for k, _ in CASES])
def test_pipeline_mode_matches_tpu_arithmetic(kind, mode, prec):
    jr, pr = _configs(kind, mode, prec)
    params = _params(jr, seed=3)
    pts, dirs = _pts_dirs(97, seed=4)
    cots = _cotangents(97, seed=6)
    gbar = np.concatenate(cots + [np.zeros((97, 3), np.float32)], axis=1)
    dense = JPP.resolve_dense(params, jr)
    runs = {}
    for bf16 in (True, False):
        out, ph, dh, g = _jit(partial(_jax_pipeline, jr, bf16))(dense, pts, dirs, gbar)
        d = {name: np.asarray(out[:, a:b]) for name, a, b in
             zip(OUTS, (0, 1, 4, 7, 10), (1, 4, 7, 10, 13))}
        d.update(pts=np.asarray(ph), dirs=np.asarray(dh))
        runs[bf16] = _leaves(d, kind, g)
    pw = PP.resolve_pipeline_weights(state_from_numpy(params), pr)
    tp, td = torch.from_numpy(pts), torch.from_numpy(dirs)
    fwd = PP.point_pipeline_plain(pw, tp, td, bf16=True)
    ph, dh, grads = PP.point_pipeline_bwd_plain(pw, tp, td, [torch.from_numpy(c) for c in cots],
                                                bf16=True)
    port = {name: t.numpy() for name, t in zip(OUTS, fwd)}
    port.update(pts=ph.numpy(), dirs=dh.numpy())
    _compare(_leaves(port, kind, grads), runs[True], runs[False], f"pipeline {prec} {kind}")


def _jax_march(jr, bf16, save, dense, rays_o, rays_d, z, inv_s, gbar):
    """JAX's fused march kernels, forward and backward (one ray per tile),
    bf16 = the flag; save: the forward exports the activation stashes (in
    the mode's store dtypes) and the backward loads them. Returns ([R, 16],
    rays_o_hat, rays_d_hat, inv_s_hat, the dense grads)."""
    ws, bs, meta = JPP.pack_pipeline_weights(dense, jr)
    R, S = z.shape
    rays = jnp.concatenate([rays_o, jnp.zeros((R, 1)), rays_d, jnp.zeros((R, 1))], axis=1)
    z_pt = z.reshape(R * S, 1)
    sinv = jnp.broadcast_to(jnp.asarray(inv_s, jnp.float32).reshape(1, 1), (1, 128))
    bm_e, bm_c, bm_r = JPP.pe_bases(jr)
    sd = 2.0 / jr.n_samples
    ws_in = JPP.cast_kernel_weights(meta, ws, not bf16)
    rays3 = rays.reshape(R, 1, 8)
    head = [_vmem((1, 1, 8), lambda i: (i, 0, 0)), _vmem((S, 1), lambda i: (i, 0)),
            _const(sinv), _const(bm_e), _const(bm_c), _const(bm_r)]
    wts_in = tuple(w.T for w in ws_in[:meta.n_sdf])
    out_specs = [_vmem((1, 1, 16), lambda i: (i, 0, 0))]
    out_shape = [jax.ShapeDtypeStruct((R, 1, 16), jnp.float32)]
    if save:
        store = jnp.bfloat16 if bf16 else jnp.float32
        for D, dt in zip(JPP.stash_lane_widths(meta),
                         (JPP._sdf_store(meta, bf16), store, jnp.float32)):
            out_specs.append(_vmem((S, D), lambda i: (i, 0)))
            out_shape.append(jax.ShapeDtypeStruct((R * S, D), dt))
    fwd = pl.pallas_call(
        partial(JRM._march_fwd_entry, meta, S, S, bf16, sd, save), grid=(R,),
        in_specs=head + [_const(x) for x in (*ws_in, *wts_in, *bs)],
        out_specs=out_specs if save else out_specs[0],
        out_shape=out_shape if save else out_shape[0], interpret=True,
    )(rays3, z_pt, sinv, bm_e, bm_c, bm_r, *ws_in, *wts_in, *bs)
    out, stashes = (fwd[0], tuple(fwd[1:])) if save else (fwd, ())
    wts_in = tuple(w.T for w in ws_in)
    outs = pl.pallas_call(
        partial(JRM._march_bwd_entry, meta, S, S, bf16, sd, save), grid=(R,),
        in_specs=head + [_vmem((1, 1, 16), lambda i: (i, 0, 0))]
        + [_vmem((S, s.shape[1]), lambda i: (i, 0)) for s in stashes]
        + [_const(x) for x in (*ws_in, *wts_in, *bs)],
        out_specs=[_vmem((1, 1, 8), lambda i: (i, 0, 0)), _const(sinv)]
        + [_const(x) for x in (*ws, *bs)],
        out_shape=[jax.ShapeDtypeStruct((R, 1, 8), jnp.float32),
                   jax.ShapeDtypeStruct(sinv.shape, jnp.float32)]
        + [jax.ShapeDtypeStruct(x.shape, jnp.float32) for x in (*ws, *bs)],
        interpret=True,
    )(rays3, z_pt, sinv, bm_e, bm_c, bm_r, gbar.reshape(R, 1, 16), *stashes, *ws_in, *wts_in,
      *bs)
    rays_hat = outs[0].reshape(R, 8)
    return (out.reshape(R, 16), rays_hat[:, 0:3], rays_hat[:, 4:7], outs[1][0, 0],
            _grads_to_dense(jr, dense, outs[2:]))


def _march_inputs(seed):
    rng = np.random.RandomState(seed)
    R, S = 3, 16
    d = rng.randn(R, 3)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = (-1.4 * d + 0.1 * rng.randn(R, 3)).astype(np.float32)
    z = (0.5 + 1.8 * np.sort(rng.rand(R, S), axis=1)).astype(np.float32)
    gbar = rng.randn(R, 16).astype(np.float32)
    gbar[:, 7:] = 0.0
    return o, d, z, np.float32(20.0), gbar


@pytest.mark.parametrize("save", [False, True], ids=["recompute", "save"])
@pytest.mark.parametrize("prec", MODES)
@pytest.mark.parametrize("kind,mode", CASES, ids=[k for k, _ in CASES])
def test_march_mode_matches_tpu_arithmetic(kind, mode, prec, save):
    jr, pr = _configs(kind, mode, prec)
    params = _params(jr, seed=5)
    o, d, z, inv_s, gbar = _march_inputs(7)
    dense = JPP.resolve_dense(params, jr)
    runs = {}
    for bf16 in (True, False):
        out, ro_h, rd_h, s_h, g = _jit(partial(_jax_march, jr, bf16, save))(dense, o, d, z,
                                                                            inv_s, gbar)
        runs[bf16] = _leaves({"out": np.asarray(out[:, :7]), "rays_o": np.asarray(ro_h),
                              "rays_d": np.asarray(rd_h), "inv_s": np.asarray(s_h)}, kind, g)
    pw = PP.resolve_pipeline_weights(state_from_numpy(params), pr)
    args = [torch.from_numpy(a) for a in (o, d, z)] + [torch.tensor([inv_s]), 2.0 / pr.n_samples]
    if save:
        out, stash = RM.ray_march_plain(pw, *args, bf16=True, save=True)
    else:
        out, stash = RM.ray_march_plain(pw, *args, bf16=True), None
    ro_h, rd_h, s_h, grads = RM.ray_march_bwd_plain(pw, *args, torch.from_numpy(gbar), bf16=True,
                                                    stash=stash)
    port = {"out": out[:, :7].numpy(), "rays_o": ro_h.numpy(), "rays_d": rd_h.numpy(),
            "inv_s": s_h.numpy()}
    _compare(_leaves(port, kind, grads), runs[True], runs[False],
             f"march {'save' if save else 'recompute'} {prec} {kind}")


def _all_outputs(pw, o, d, z, s, sd, gbar, bf16):
    """Every output of the pipeline's and the march's twins (recompute and
    save), flattened: {name: tensor}."""
    n = 40
    g = torch.Generator().manual_seed(9)
    pts, dirs = (0.5 * torch.randn((n, 3), generator=g)), torch.randn((n, 3), generator=g)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    cots = [torch.randn((n, k), generator=g) for k in (1, 3, 3, 3, 3)]
    res = {f"pipeline {k}": t for k, t in zip(OUTS, PP.point_pipeline_plain(pw, pts, dirs, bf16))}
    ph, dh, grads = PP.point_pipeline_bwd_plain(pw, pts, dirs, cots, bf16)
    res.update({"pipeline pts": ph, "pipeline dirs": dh})
    res.update({f"pipeline {k}": v for k, v in _leaves({}, pw.rcfg.kind, grads).items()})
    out, stash = RM.ray_march_plain(pw, o, d, z, s, sd, bf16=bf16, save=True)
    res["march out"] = out
    for tag, st in (("recompute", None), ("save", stash)):
        ro_h, rd_h, s_h, grads = RM.ray_march_bwd_plain(pw, o, d, z, s, sd, gbar, bf16=bf16,
                                                        stash=st)
        res.update({f"march {tag} rays_o": ro_h, f"march {tag} rays_d": rd_h,
                    f"march {tag} inv_s": s_h.reshape(1)})
        res.update({f"march {tag} {k}": v for k, v in _leaves({}, pw.rcfg.kind, grads).items()})
    return {k: torch.as_tensor(v) for k, v in res.items()}


@pytest.mark.parametrize("kind,mode", CASES, ids=[k for k, _ in CASES])
def test_modes_agree_in_f32_arithmetic(kind, mode):
    jr, _ = _configs(kind, mode, "f32stash")
    params = state_from_numpy(_params(jr, seed=8))
    o, d, z, inv_s, gbar = (torch.from_numpy(np.asarray(a)).reshape(np.shape(a) or (1,))
                            for a in _march_inputs(10))
    runs = {}
    for prec in ("f32stash",) + MODES:
        pr = dataclasses.replace(_rcfg(configs, kind, mode), march_bwd_precision=prec)
        pw = PP.resolve_pipeline_weights(params, pr)
        runs[prec] = _all_outputs(pw, o, d, z, inv_s, 2.0 / pr.n_samples, gbar, bf16=False)
        if prec != "f32":
            fwd = PP.point_pipeline_plain(pw, *_pts_dirs_t(), bf16=True)
            runs[prec, "bf16 forward"] = torch.cat(fwd, dim=1)
    for prec in MODES:
        for k, want in runs["f32stash"].items():
            got = runs[prec][k]
            scale = float(want.abs().max()) + 1e-30
            assert float((got - want).abs().max()) <= AGREE * scale, f"{prec} {k}"
    assert torch.equal(runs["bf16", "bf16 forward"], runs["f32stash", "bf16 forward"])


def _pts_dirs_t():
    return tuple(torch.from_numpy(a) for a in _pts_dirs(64, seed=12))


@pytest.mark.parametrize("value", ["f32stash", "bf16", "f32"])
def test_march_bwd_precision_parses(value):
    base = {"TYPE": "Color_NeuS", "COLOR": {"MODE": "no_view_dir"}}
    rc = configs.renderer_config_from_cfg({**base, "MARCH_BWD_PRECISION": value})
    assert rc.march_bwd_precision == value
    assert configs.renderer_config_from_cfg(base).march_bwd_precision == "f32stash"
    assert configs.RendererConfig(march_bwd_precision=value).march_bwd_precision == value


@pytest.mark.parametrize("typo", ["f32_stash", "bfloat16", "F32"])
def test_march_bwd_precision_typo_raises(typo):
    base = {"TYPE": "Color_NeuS", "COLOR": {"MODE": "no_view_dir"}}
    with pytest.raises(ValueError, match="march_bwd_precision"):
        configs.renderer_config_from_cfg({**base, "MARCH_BWD_PRECISION": typo})
    with pytest.raises(ValueError, match="march_bwd_precision"):
        jconfigs.RendererConfig(march_bwd_precision=typo)


@pytest.mark.parametrize("kind,prec,want", [
    ("color_neus", "bf16", 8768), ("color_neus", "f32stash", 12864), ("color_neus", "f32", 12864),
    ("neus", "bf16", 6720), ("neus", "f32stash", 10816)])
def test_stash_bytes_per_mode_at_the_config_widths(kind, prec, want):
    """The save mode's stash bytes a point (act_bytes' activations and the
    32-byte outs stash) at the widths of config/Color_NeuS_dtu.yml (NeuS:
    the same SDF and colour nets without relight), and JAX's
    march_stash_bytes' saving between the modes: its SX stash's 8 x 256
    lanes in bf16 against f32."""
    pr = dataclasses.replace(configs.renderer_config_from_cfg(get_config(DTU)["MODEL"]
                                                              ["RENDERER"]),
                             march_bwd_precision=prec, kind=kind)
    assert RM.march_stash_bytes(pr, 1) == want
    assert RM.act_bytes(pr) == want - RM.STASH * 4
    pw = PP.resolve_pipeline_weights(neus.init_renderer(pr, torch.Generator().manual_seed(0)),
                                     pr)
    assert RM.march_stash_bytes(pw, 1) == want
    jr = dataclasses.replace(jax_renderer_cfg(jax_get_config(DTU)["MODEL"]["RENDERER"]),
                             march_bwd_precision=prec, kind=kind)
    jr0 = dataclasses.replace(jr, march_bwd_precision="f32stash")
    params = jneus.init_renderer(jax.random.PRNGKey(0), jr)
    metas = [JPP.pack_pipeline_weights(JPP.resolve_dense(params, r), r)[2] for r in (jr, jr0)]
    jax_saved = JRM.march_stash_bytes(metas[1], 1) - JRM.march_stash_bytes(metas[0], 1)
    port0 = dataclasses.replace(pr, march_bwd_precision="f32stash")
    assert RM.march_stash_bytes(port0, 1) - want == jax_saved
    assert RM.policy_stash_bytes(pr, 1) == JRM.march_stash_bytes(metas[0], 1)


@pytest.mark.parametrize("prec", ["f32stash", "bf16", "f32"])
def test_auto_flips_at_each_modes_budget(prec, monkeypatch):
    """'auto' decides on JAX's count of the stash (policy_stash_bytes: its
    outs plane padded to 128 lanes), not the kernel's smaller one: at the widths
    of config/Color_NeuS_dtu.yml and its 13.5 GiB budget the port and JAX's
    resolve_save_acts agree at the mode's flip point and one point either
    side (the kernel's bytes would flip 1,126,827 - 1,088,906 points later
    in f32stash / f32, 1,653,229 - 1,572,865 in bf16); at the small widths
    'auto' saves exactly at a budget of policy_stash_bytes and not one
    point past it."""
    monkeypatch.delenv("MARCH_STASH_BUDGET_GB", raising=False)
    pr = dataclasses.replace(configs.renderer_config_from_cfg(get_config(DTU)["MODEL"]
                                                              ["RENDERER"]),
                             march_bwd_precision=prec)
    jr = dataclasses.replace(jax_renderer_cfg(jax_get_config(DTU)["MODEL"]["RENDERER"]),
                             march_bwd_precision=prec)
    params = jneus.init_renderer(jax.random.PRNGKey(0), jr)
    meta = JPP.pack_pipeline_weights(JPP.resolve_dense(params, jr), jr)[2]
    assert RM.policy_stash_bytes(pr, 1) == JRM.march_stash_bytes(meta, 1)
    assert RM.stash_lane_widths(pr) == JPP.stash_lane_widths(meta)
    budget = pr.march_stash_budget_gb
    flip = int(budget * 1024 ** 3) // JRM.march_stash_bytes(meta, 1)
    assert RM.march_stash_bytes(pr, flip + 1) <= budget * 1024 ** 3   # the kernel's would save
    for n_pts, want in ((flip - 1, True), (flip, True), (flip + 1, False)):
        assert JRM.resolve_save_acts("auto", meta, n_pts, budget_gb=budget) is want
        assert RM.resolve_save_acts(pr.march_acts, pr, n_pts, budget) is want, n_pts

    pr = dataclasses.replace(port_cfg(SMALL_COLOR), march_bwd_precision=prec)
    n_pts = 4 * (pr.n_samples + pr.n_importance)
    budget = RM.policy_stash_bytes(pr, n_pts) / 1024 ** 3
    assert RM.resolve_save_acts("auto", pr, n_pts, budget_gb=budget) is True
    assert RM.resolve_save_acts("auto", pr, n_pts + 1, budget_gb=budget) is False


@pytest.mark.parametrize("prec,saved", [("bf16", True), ("f32stash", False), ("f32", False)])
def test_render_rays_train_runs_the_resolved_modes_twins(prec, saved):
    """The loss path carries rcfg.march_bwd_precision to the march's twins,
    and 'auto' resolves with the mode's stash: at a budget between the
    'bf16' and the f32stash stash of this step, 'bf16' runs the save twins
    and the other modes the recompute twins; the loss partials and
    gradients agree with f32stash's (f32 arithmetic on the CPU)."""
    jr = SMALL_COLOR
    base = dataclasses.replace(port_cfg(jr), fused_march="on", march_acts="auto", perturb=0.0)
    tp = state_from_numpy(jax_params(jr, 41))
    ro, rd, _ = _rays_z(3, 4, seed=42)
    o, d = torch.tensor(np.asarray(ro)), torch.tensor(np.asarray(rd))
    near, far = near_far_from_sphere(o, d)
    n_pts = 3 * (base.n_samples + base.n_importance)
    small = RM.policy_stash_bytes(dataclasses.replace(base, march_bwd_precision="bf16"), n_pts)
    large = RM.policy_stash_bytes(base, n_pts)
    assert small < large
    budget = (small + large) / 2 / 1024 ** 3
    os.environ.pop("MARCH_STASH_BUDGET_GB", None)
    calls = []
    real = RM.ray_march_bwd_plain

    def spy(pw, *args, stash=None, **kw):
        calls.append((pw.rcfg.march_bwd_precision, stash is not None))
        return real(pw, *args, stash=stash, **kw)

    runs = {}
    RM.ray_march_bwd_plain = spy
    try:
        for p in (prec, "f32stash"):
            pr = dataclasses.replace(base, march_bwd_precision=p, march_stash_budget_gb=budget)
            out = neus.render_rays_train(tp, pr, o, d, near, far)
            loss = out["color_fine"].sum() + out["gradient_error"]
            runs[p] = (loss.detach(), torch.autograd.grad(loss, list(tp.parameters()),
                                                          allow_unused=True))
    finally:
        RM.ray_march_bwd_plain = real
    assert calls[0] == (prec, saved)
    loss, grads = runs[prec]
    loss_ref, grads_ref = runs["f32stash"]
    assert abs(float(loss) - float(loss_ref)) <= AGREE * abs(float(loss_ref))
    for a, b in zip(grads, grads_ref):
        if b is None:
            assert a is None
            continue
        assert float((a - b).abs().max()) <= 1e-5 * (float(b.abs().max()) + 1e-6)
