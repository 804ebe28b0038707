"""The point-pipeline backward (ops/kernels/point_pipeline.py) against the
JAX package, on the CPU at small widths.

(a) point_pipeline_bwd_plain, the backward kernel's plain twin, against
    jax.vjp of the JAX oracle point_pipeline_ref w.r.t. the dense weights,
    pts and dirs, seeded cotangents on all five outputs, for the forward
    test's cases plus inv_sigmoid off and include_grad off;
(b) the same against the JAX backward kernel itself, run in interpret mode
    (f32) under jax.vjp, one tile of 64 points;
(c) _unpack_grads inverts _pack exactly at full width;
(d) the autograd Function through neus.eval_point_pipeline with
    fused_core='on' against the plain autograd core ('off'): the v / g / b
    leaf grads and the pts / dirs grads.
Tolerances: atol 1e-5 x the largest |reference| of the leaf, rtol 1e-4 (f32,
the same arithmetic summed in another order; the pts gradient sums PE terms
up to 2^(multires - 1) squared)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from color_neus_tpu.models import configs as jconfigs
from color_neus_tpu.ops.pallas import point_pipeline as JPP

from color_neus_torch import pin_precision
from color_neus_torch.models import configs, neus
from color_neus_torch.ops.kernels import point_pipeline as PP
from color_neus_torch.weights import state_from_numpy
from tests.test_torch_point_pipeline import CASES, _params, _pts_dirs, _rcfg

torch.set_num_threads(1)
pin_precision()

NETS = ("sdf", "color", "relight")


def _cfg(mod, kind, mode, y_in, **relight):
    rc = _rcfg(mod, kind, mode, y_in)
    return dataclasses.replace(rc, relight=dataclasses.replace(rc.relight, **relight))


def _cotangents(n, seed=5):
    rng = np.random.RandomState(seed)
    return [rng.randn(n, k).astype(np.float32) for k in (1, 3, 3, 3, 3)]


def _close(got, want, name):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-5 * scale, rtol=1e-4,
                               err_msg=name)


def _port_bwd(params, pr, pts, dirs, cots):
    pw = PP.resolve_pipeline_weights(state_from_numpy(params), pr)
    return PP.point_pipeline_bwd_plain(pw, torch.from_numpy(pts), torch.from_numpy(dirs),
                                       [torch.from_numpy(c) for c in cots])


def _compare(port, jax_grads, kind):
    ph, dh, grads = port
    g_dense, g_pts, g_dirs = jax_grads
    _close(ph.numpy(), g_pts, "pts")
    _close(dh.numpy(), g_dirs, "dirs")
    for net in NETS if kind == "color_neus" else NETS[:2]:
        assert len(grads[net]) == len(g_dense[f"{net}_w"])
        for l, (dw, db) in enumerate(grads[net]):
            _close(dw.numpy(), g_dense[f"{net}_w"][l], f"{net} layer {l} W")
            _close(db.numpy(), g_dense[f"{net}_b"][l], f"{net} layer {l} b")


BWD_CASES = [(k, m, y, {}) for k, m, y in CASES] + [
    ("color_neus", "no_view_dir", 2, {"inv_sigmoid": False}),
    ("color_neus", "idr", 1, {"include_grad": False})]


@pytest.mark.parametrize("kind,mode,y_in,relight", BWD_CASES,
                         ids=[f"{k}-{m}-y{y}" + "".join(f"-{r}" for r in rl)
                              for k, m, y, rl in BWD_CASES])
def test_bwd_plain_matches_jax_oracle_vjp(kind, mode, y_in, relight):
    jr, pr = _cfg(jconfigs, kind, mode, y_in, **relight), _cfg(configs, kind, mode, y_in, **relight)
    params = _params(jr)
    pts, dirs = _pts_dirs(97)
    cots = _cotangents(97)
    dense = JPP.resolve_dense(params, jr)
    _, vjp = jax.vjp(lambda dn, p, d: JPP.point_pipeline_ref(dn, jr, p, d),
                     dense, jnp.asarray(pts), jnp.asarray(dirs))
    want = vjp(tuple(jnp.asarray(c) for c in cots))
    _compare(_port_bwd(params, pr, pts, dirs, cots), want, kind)


@pytest.mark.parametrize("kind,mode", [("color_neus", "no_view_dir"), ("neus", "idr")])
def test_bwd_plain_matches_jax_interpret_kernel(kind, mode):
    jr, pr = _rcfg(jconfigs, kind, mode), _rcfg(configs, kind, mode)
    params = _params(jr, seed=3)
    pts, dirs = _pts_dirs(64, seed=4)
    cots = _cotangents(64, seed=6)
    dense = JPP.resolve_dense(params, jr)
    _, vjp = jax.vjp(lambda dn, p, d: JPP.fused_point_pipeline(dn, jr, p, d, tile=64,
                                                               interpret=True),
                     dense, jnp.asarray(pts), jnp.asarray(dirs))
    want = vjp(tuple(jnp.asarray(c) for c in cots))
    _compare(_port_bwd(params, pr, pts, dirs, cots), want, kind)


@pytest.mark.parametrize("kind,relight", [
    ("color_neus", {}), ("color_neus", {"y_in_layer": 4, "include_grad": False}),
    ("neus", {})])
def test_unpack_grads_inverts_pack(kind, relight):
    color = (configs.ColorConfig(mode="no_view_dir", d_in=6, multires_view=0)
             if kind == "color_neus" else configs.ColorConfig())
    rcfg = configs.RendererConfig(kind=kind, color=color,
                                  relight=configs.RelightConfig(**relight))
    g = torch.Generator().manual_seed(1)
    params = neus.init_renderer(rcfg, g)
    with torch.no_grad():
        for p in params.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    pw = PP.resolve_pipeline_weights(params, rcfg)
    packed, pw.off, pw.n_grad = PP._pack(pw)
    # the f32 buffer is the gradient layout: every slot a gradient flows to
    # lies in it; the transposed copies the reverse products read are in the
    # bf16 slab images only, each a distinct block, as is every 256-wide
    # layer's forward image
    t_slots = [s for s in range(PP.N_OFF)
               if PP.WT_SDF <= s < PP.B_SDF or PP.WT_COL <= s < PP.W_LAST or s == PP.WT_FEAT]
    grad_slots = [s for s in range(PP.N_OFF) if s not in t_slots]
    assert max(pw.off[grad_slots]) < pw.n_grad == packed.numel()
    assert not pw.off[t_slots].any()
    img, ioff = PP._pack_images(pw)
    used = [s for w_slot, wt_slot, _ in PP._layout(pw)[1] for s in (w_slot, wt_slot)]
    assert all(s in t_slots for s in used[1::2])
    n_slabs = img.numel() // (PP.SLAB_ROWS * PP.SLAB_K)
    assert len(set(ioff[used].tolist())) == len(used) and max(ioff[used]) < n_slabs
    back = PP._unpack_grads(pw, packed)
    for net in NETS:
        layers = getattr(pw, net)
        assert len(back[net]) == len(layers)
        for l, ((w, b), (bw, bb)) in enumerate(zip(layers, back[net])):
            assert torch.equal(bw, w), f"{net} layer {l} W"
            assert torch.equal(bb, b), f"{net} layer {l} b"


@pytest.mark.parametrize("kind,mode", [("color_neus", "no_view_dir"), ("color_neus", "idr"),
                                       ("neus", "idr")])
def test_function_matches_autograd_core(kind, mode):
    """fused_core='on' under grad (PointPipelineFunction, plain twins on the
    CPU) against 'off' (the fields path's autograd double backward)."""
    pr = _rcfg(configs, kind, mode)
    params = state_from_numpy(_params(_rcfg(jconfigs, kind, mode)))
    pts0, dirs0 = (torch.from_numpy(a) for a in _pts_dirs(41, seed=8))
    cots = [torch.from_numpy(c) for c in _cotangents(41, seed=9)]
    got = {}
    for fc in ("on", "off"):
        params.zero_grad(set_to_none=True)
        pts, dirs = pts0.clone().requires_grad_(True), dirs0.clone().requires_grad_(True)
        outs = neus.eval_point_pipeline(params, dataclasses.replace(pr, fused_core=fc), pts, dirs)
        assert all(o.requires_grad for o in outs[:4])
        sum(torch.sum(o * c) for o, c in zip(outs, cots)).backward()
        got[fc] = {k: p.grad for k, p in params.named_parameters()}
        got[fc].update(pts=pts.grad, dirs=dirs.grad, outs=[o.detach() for o in outs])
    for a, b in zip(got["on"].pop("outs"), got["off"].pop("outs")):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)
    for k, want in got["off"].items():
        if want is None:   # the variance leaf, and dirs without a view-dir input
            continue
        _close(got["on"][k].numpy(), want.numpy(), k)


def test_yaml_switches_read_booleans():
    """YAML reads a bare `on` / `off` as true / false."""
    for v, want in ((True, "on"), (False, "off"), ("on", "on"), ("auto", "auto")):
        assert configs.renderer_config_from_cfg({"FUSED_CORE": v}).fused_core == want
