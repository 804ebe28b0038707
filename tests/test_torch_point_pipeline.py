"""The point pipeline (ops/kernels/point_pipeline.py) against the JAX package.

point_pipeline_plain, the CUDA kernel's plain twin, against the JAX
kernel run in interpret mode (fused_point_pipeline_fwd, interpret=True)
and against its autodiff oracle point_pipeline_ref, for both renderer
kinds and both colour modes, at small widths off the initialisation
(seeded noise on every leaf). Tolerance: atol 1e-6 on sdf and the
colours and 1e-5 on grad (f32, the same arithmetic summed in another
order; grad is a sum of ~40 PE terms of magnitude ~2). Then the
fused_core switch of models/neus.eval_point_pipeline."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from color_neus_tpu.models import configs as jconfigs
from color_neus_tpu.models import neus as jneus
from color_neus_tpu.ops.pallas import point_pipeline as JPP

from color_neus_torch import pin_precision
from color_neus_torch.models import configs, neus
from color_neus_torch.ops.kernels import point_pipeline as PP
from color_neus_torch.weights import state_from_numpy

torch.set_num_threads(1)
pin_precision()

NAMES = ("sdf", "grad", "gc", "relit", "delta")
ATOL = {"sdf": 1e-6, "grad": 1e-5, "gc": 1e-6, "relit": 1e-6, "delta": 1e-6}


def _rcfg(mod, kind, mode, y_in=2):
    color = (mod.ColorConfig(mode="no_view_dir", d_in=6, d_feature=64, d_hidden=32,
                             n_layers=2, multires_view=0) if mode == "no_view_dir"
             else mod.ColorConfig(mode="idr", d_in=9, d_feature=64, d_hidden=32, n_layers=2,
                                  multires_view=4))
    return mod.RendererConfig(
        kind=kind, sdf=mod.SDFConfig(d_out=65, d_hidden=64, n_layers=4, skip_in=(2,),
                                     multires=4),
        color=color, relight=mod.RelightConfig(d_hidden=32, n_layers=2, y_in_layer=y_in))


def _params(jr, seed=0):
    rng = np.random.RandomState(seed)
    params = jneus.init_renderer(jax.random.PRNGKey(seed), jr)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.randn(*np.shape(a))).astype(np.float32), params)


def _pts_dirs(n, seed=1):
    rng = np.random.RandomState(seed)
    pts = (rng.randn(n, 3) * 0.4).astype(np.float32)
    d = rng.randn(n, 3)
    return pts, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


CASES = [("color_neus", "no_view_dir", 2), ("color_neus", "idr", 2),
         ("color_neus", "no_view_dir", 1), ("neus", "idr", 2), ("neus", "no_view_dir", 2)]


@pytest.mark.parametrize("kind,mode,y_in", CASES,
                         ids=[f"{k}-{m}-y{y}" for k, m, y in CASES])
def test_plain_matches_jax_kernel_and_oracle(kind, mode, y_in):
    jr, pr = _rcfg(jconfigs, kind, mode, y_in), _rcfg(configs, kind, mode, y_in)
    params = _params(jr)
    pts, dirs = _pts_dirs(97)
    dense = JPP.resolve_dense(params, jr)
    ref = JPP.point_pipeline_ref(dense, jr, jnp.asarray(pts), jnp.asarray(dirs))
    kern = JPP.fused_point_pipeline_fwd(dense, jr, jnp.asarray(pts), jnp.asarray(dirs),
                                        tile=128, interpret=True)
    pw = PP.resolve_pipeline_weights(state_from_numpy(params), pr)
    got = PP.point_pipeline_plain(pw, torch.from_numpy(pts), torch.from_numpy(dirs))
    for name, g, r, k in zip(NAMES, got, ref, kern):
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL[name], rtol=0,
                                   err_msg=f"{name} vs point_pipeline_ref")
        np.testing.assert_allclose(g.numpy(), np.asarray(k), atol=ATOL[name], rtol=0,
                                   err_msg=f"{name} vs the interpret-mode kernel")


def test_fused_core_switch():
    """auto/on without grad: the pipeline (plain twin on the CPU), equal
    to the fields path; auto with grad: the fields path, differentiable;
    on with grad: the autograd Function (plain twins on the CPU), equal to
    the fields path with equal gradients; off: the fields path."""
    pr = _rcfg(configs, "color_neus", "no_view_dir")
    params = state_from_numpy(_params(_rcfg(jconfigs, "color_neus", "no_view_dir")))
    pts, dirs = (torch.from_numpy(a) for a in _pts_dirs(33))
    on = dataclasses.replace(pr, fused_core="on")
    off = dataclasses.replace(pr, fused_core="off")
    with torch.no_grad():
        assert neus.resolve_point_pipeline(params, pr) is not None
        assert neus.resolve_point_pipeline(params, off) is None
        kernel_path = neus.eval_point_pipeline(params, on, pts, dirs)
        plain_path = neus.eval_point_pipeline(params, off, pts, dirs)
    for name, a, b in zip(NAMES, kernel_path, plain_path):
        np.testing.assert_allclose(a.numpy(), b.detach().numpy(), atol=ATOL[name], rtol=0,
                                   err_msg=name)
    assert neus.resolve_point_pipeline(params, pr) is None
    out = neus.eval_point_pipeline(params, pr, pts, dirs)
    assert out[1].requires_grad
    assert neus.resolve_point_pipeline(params, on) is None
    grads = {}
    for name, cfg in (("on", on), ("off", off)):
        params.zero_grad(set_to_none=True)
        outs = neus.eval_point_pipeline(params, cfg, pts, dirs)
        assert all(o.requires_grad for o in outs[:4]), name
        for k, a, b in zip(NAMES, outs, plain_path):
            np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=ATOL[k],
                                       rtol=0, err_msg=f"{name} {k}")
        sum(torch.sum(o * o) for o in outs[:4]).backward()
        grads[name] = {k: p.grad for k, p in params.named_parameters() if p.grad is not None}
    assert grads["on"].keys() == grads["off"].keys()
    for k, g in grads["off"].items():
        scale = float(g.abs().max())
        np.testing.assert_allclose(grads["on"][k].numpy(), g.numpy(), atol=1e-5 * scale,
                                   rtol=1e-4, err_msg=k)


def test_kernel_shape_check():
    """Shapes the CUDA kernel does not take raise ValueError when its
    buffers are packed; the shipped full-width shapes pack."""
    full = configs.RendererConfig(kind="color_neus", color=configs.ColorConfig(
        mode="no_view_dir", d_in=6, multires_view=0))
    d0, skip, n_sdf = PP._check_kernel_shape(full)
    assert (d0, skip, n_sdf) == (39, 4, 9)
    PP._check_kernel_shape(configs.RendererConfig(kind="neus"))
    with pytest.raises(ValueError, match="point_pipeline"):
        PP._check_kernel_shape(_rcfg(configs, "color_neus", "no_view_dir"))
    with pytest.raises(ValueError, match="point_pipeline"):
        PP._check_kernel_shape(dataclasses.replace(full, color=configs.ColorConfig(
            mode="no_normal", d_in=6)))
    # packing at full width on the CPU: every offset inside the buffer, and
    # every 256-wide layer's forward and reverse slab images at distinct
    # offsets inside the image buffer
    pw = PP.resolve_pipeline_weights(
        neus.init_renderer(full, torch.Generator().manual_seed(0)), full)
    packed, off, n_grad = PP._pack(pw)
    used = off[off > 0]
    assert used.max() < packed.numel() and len(set(used.tolist())) == len(used)
    assert 0 < n_grad == packed.numel()
    img, ioff = PP._pack_images(pw)
    _, wide = PP._layout(pw)
    slots = [s for w_slot, wt_slot, _ in wide for s in (w_slot, wt_slot)]
    assert len(slots) == 2 * (n_sdf + len(pw.color) - 1 + len(pw.relight) - 1)
    n_slabs = img.numel() // (PP.SLAB_ROWS * PP.SLAB_K)
    assert len(set(ioff[slots].tolist())) == len(slots) and ioff[slots].max() < n_slabs
