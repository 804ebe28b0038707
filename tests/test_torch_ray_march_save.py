"""The fused march's save mode (ops/kernels/ray_march.py) against the JAX
package, on the CPU at small widths, and the policy that picks it.

(a) RayMarchFunction in the save mode (its plain save twins on the CPU)
    against JAX fused_ray_march(..., save_acts=True, interpret=True): the
    forward on all 16 lanes and every leaf's gradient, at
    tests/test_torch_ray_march.py's tolerances;
(b) the port's save twins (ray_march_plain(save=True) and
    ray_march_bwd_plain(stash=...)) against its recompute twins, in f32 and
    with bf16 products and stores, at JAX's own save-vs-recompute bound
    (tests/test_ray_march.py: 1e-5 of each leaf's largest |grad|);
(c) resolve_save_acts as tests/test_ray_march.py holds JAX's: explicit
    values pass through, junk raises, 'auto' saves exactly at the budget
    and not one point past it;
(d) march_stash_bytes at the full Color-NeuS widths of
    config/Color_NeuS_dtu.yml: at most 13.5 GiB / (2048 x 512) bytes a point,
    and 'auto' picks what JAX's resolve_save_acts picks for the same config
    at the config's 1024 x 128 and at bench.py's 2048 x 512 (save at both);
(e) MARCH_ACTS and MARCH_STASH_BUDGET_GB parse, the keys still unported
    raise, and the main path (render_rays_train) runs the mode that
    march_acts resolves to.
Widths: tests/test_ray_march.py's SMALL_COLOR, SMALL_NEUS, SMALL_COLOR_VAR,
off the initialisation by seeded noise.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from color_neus_tpu.models import fields as jfields
from color_neus_tpu.models import neus as jneus
from color_neus_tpu.models.configs import renderer_config_from_cfg as jax_renderer_cfg
from color_neus_tpu.ops.pallas.point_pipeline import pack_pipeline_weights, resolve_dense
from color_neus_tpu.ops.pallas.ray_march import fused_ray_march as jax_march
from color_neus_tpu.ops.pallas.ray_march import resolve_save_acts as jax_resolve
from color_neus_tpu.utils.config import get_config as jax_get_config

from color_neus_torch import pin_precision
from color_neus_torch.models import configs, fields, neus
from color_neus_torch.ops.kernels import point_pipeline as PP
from color_neus_torch.ops.kernels import ray_march as RM
from color_neus_torch.ops.rays import near_far_from_sphere
from color_neus_torch.utils.config import get_config
from color_neus_torch.weights import state_from_numpy
from tests.test_ray_march import SMALL_COLOR, _rays_z
from tests.test_torch_ray_march import (CFGS, FWD_ATOL, FWD_RTOL, GRAD_ATOL, GRAD_FLOOR, _flat,
                                        jax_params, port_cfg)

torch.set_num_threads(1)
pin_precision()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTU = os.path.join(REPO, "config", "Color_NeuS_dtu.yml")
SAVE_VS_RECOMPUTE = 1e-5          # JAX's bound, of each leaf's largest |grad|
BYTES_TARGET = 13.5 * 1024 ** 3 / (2048 * 512)   # 13,824: bench.py's shape in the budget


@pytest.mark.parametrize("name", list(CFGS))
def test_save_mode_matches_jax_save(name):
    jr = CFGS[name]
    pr = port_cfg(jr)
    R, seed = 4, 21
    params = jax_params(jr, seed)
    S = jr.n_samples + jr.n_importance
    ro, rd, z = _rays_z(R, S, seed=seed + 1)
    lw = np.random.RandomState(seed + 2).randn(R, 16).astype(np.float32)

    def out16(p, o, d):
        dense = resolve_dense(p, jr)
        inv_s = jfields.variance_inv_s(p["variance"])
        return jax_march(dense, jr, o, d, z, inv_s, tile_rays=2, interpret=True,
                         save_acts=True)

    want = np.asarray(jax.jit(out16)(params, ro, rd))
    g_p, g_o, g_d = jax.jit(jax.grad(lambda p, o, d: jnp.sum(lw * out16(p, o, d)),
                                     argnums=(0, 1, 2)))(params, ro, rd)

    tp = state_from_numpy(params)
    o, d = (torch.tensor(np.asarray(a), requires_grad=True) for a in (ro, rd))
    zt = torch.tensor(np.asarray(z))
    inv_s = fields.variance_inv_s(tp["variance"])
    calls = []
    real = RM.ray_march_bwd_plain

    def spy(*args, stash=None, **kw):
        calls.append(stash)
        return real(*args, stash=stash, **kw)

    RM.ray_march_bwd_plain = spy
    try:
        got = RM.fused_ray_march(tp, pr, o, d, zt, inv_s, save_acts="save")
        np.testing.assert_allclose(got.detach().numpy(), want, atol=FWD_ATOL, rtol=FWD_RTOL)
        torch.sum(torch.from_numpy(lw) * got).backward()
    finally:
        RM.ray_march_bwd_plain = real
    assert len(calls) == 1 and isinstance(calls[0], PP.ActStash), "the save twins did not run"

    def close(a, b, what):
        scale = float(np.abs(b).max()) + GRAD_FLOOR
        np.testing.assert_allclose(a, b, atol=GRAD_ATOL * scale, rtol=0, err_msg=what)

    flat_j = _flat(jax.tree_util.tree_map(np.asarray, g_p))
    names = dict(tp.named_parameters())
    assert set(names) == set(flat_j)
    for k, leaf in names.items():
        close(leaf.grad.numpy(), flat_j[k], k)
    close(o.grad.numpy(), np.asarray(g_o), "rays_o")
    close(d.grad.numpy(), np.asarray(g_d), "rays_d")


def _small_inputs(jr, seed):
    pr = port_cfg(jr)
    tp = state_from_numpy(jax_params(jr, seed))
    pw = PP.resolve_pipeline_weights(tp, pr)
    R, S = 4, pr.n_samples + pr.n_importance
    o, d, z = (torch.tensor(np.asarray(a)) for a in _rays_z(R, S, seed=seed + 1))
    s = fields.variance_inv_s(tp["variance"]).detach().reshape(1)
    gbar = torch.from_numpy(np.random.RandomState(seed + 2).randn(R, 16).astype(np.float32))
    return pw, o, d, z, s, 2.0 / pr.n_samples, gbar


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(CFGS))
def test_save_twins_match_recompute_twins(name, bf16):
    pw, o, d, z, s, sd, gbar = _small_inputs(CFGS[name], seed=31)
    out, stash = RM.ray_march_plain(pw, o, d, z, s, sd, bf16=bf16, save=True)
    np.testing.assert_allclose(out.numpy(), RM.ray_march_plain(pw, o, d, z, s, sd, bf16=bf16)
                               .numpy(), rtol=1e-6, atol=0)
    if bf16:   # the stored colour / relight parts are bf16 values
        for t in stash.cs + stash.rs:
            assert torch.equal(t, PP._bf16(t))
    saved = RM.ray_march_bwd_plain(pw, o, d, z, s, sd, gbar, bf16=bf16, stash=stash)
    recomputed = RM.ray_march_bwd_plain(pw, o, d, z, s, sd, gbar, bf16=bf16)

    def close(a, b, what):
        scale = float(b.abs().max()) + 1e-6
        np.testing.assert_allclose((a / scale).numpy(), (b / scale).numpy(),
                                   atol=SAVE_VS_RECOMPUTE, rtol=0, err_msg=what)

    for a, b, what in zip(saved[:3], recomputed[:3], ("rays_o", "rays_d", "inv_s")):
        close(a.reshape(-1), b.reshape(-1), what)
    for net, layers in recomputed[3].items():
        for l, ((a, b), (c, e)) in enumerate(zip(saved[3][net], layers)):
            close(a, c, f"{net} {l} W")
            close(b, e, f"{net} {l} b")


def test_resolve_save_acts_policy(monkeypatch):
    pr = port_cfg(SMALL_COLOR)
    n_pts = 4 * (pr.n_samples + pr.n_importance)
    assert RM.march_stash_bytes(pr, 2 * n_pts) == 2 * RM.march_stash_bytes(pr, n_pts) > 0
    bts = RM.policy_stash_bytes(pr, n_pts)
    assert bts > 0 and RM.policy_stash_bytes(pr, 2 * n_pts) == 2 * bts
    for v in (True, "save"):
        assert RM.resolve_save_acts(v, pr, n_pts) is True
    for v in (False, "recompute", None):
        assert RM.resolve_save_acts(v, pr, n_pts) is False
    with pytest.raises(ValueError):
        RM.resolve_save_acts("sometimes", pr, n_pts)
    budget = bts / 1024 ** 3
    assert RM.resolve_save_acts("auto", pr, n_pts, budget_gb=budget) is True
    assert RM.resolve_save_acts("auto", pr, n_pts + 1, budget_gb=budget) is False
    monkeypatch.setenv("MARCH_STASH_BUDGET_GB", str(budget))
    assert RM.resolve_save_acts("auto", pr, n_pts, budget_gb=1e-9) is True
    assert RM.resolve_save_acts("auto", pr, n_pts + 1, budget_gb=1e3) is False


def test_stash_bytes_and_auto_at_the_config_widths(monkeypatch):
    monkeypatch.delenv("MARCH_STASH_BUDGET_GB", raising=False)
    pr = configs.renderer_config_from_cfg(get_config(DTU)["MODEL"]["RENDERER"])
    jr = jax_renderer_cfg(jax_get_config(DTU)["MODEL"]["RENDERER"])
    per_point = RM.march_stash_bytes(pr, 1)
    assert per_point <= BYTES_TARGET, per_point
    pw = PP.resolve_pipeline_weights(neus.init_renderer(pr, torch.Generator().manual_seed(0)),
                                     pr)
    assert RM.march_stash_bytes(pw, 1) == per_point
    params = jneus.init_renderer(jax.random.PRNGKey(0), jr)
    _, _, meta = pack_pipeline_weights(resolve_dense(params, jr), jr)
    for n_pts in (1024 * 128, 2048 * 512):
        want = jax_resolve(jr.march_acts, meta, n_pts, budget_gb=jr.march_stash_budget_gb)
        got = RM.resolve_save_acts(pr.march_acts, pr, n_pts, pr.march_stash_budget_gb)
        assert got is want is True, (n_pts, got, want)


def test_march_acts_keys_parse_and_unported_keys_raise():
    base = {"TYPE": "Color_NeuS", "COLOR": {"MODE": "no_view_dir"}}
    for acts in ("auto", "save", "recompute"):
        assert configs.renderer_config_from_cfg({**base, "MARCH_ACTS": acts}).march_acts == acts
    with pytest.raises(ValueError):
        configs.renderer_config_from_cfg({**base, "MARCH_ACTS": "sometimes"})
    rc = configs.renderer_config_from_cfg({**base, "MARCH_STASH_BUDGET_GB": 2.5})
    assert rc.march_stash_budget_gb == 2.5
    for key, value in (("MARCH_TILE", 1024), ("FUSED_TILE", 1024),
                       ("THIN_DOTS", "vpu")):
        with pytest.raises(NotImplementedError, match=key):
            configs.renderer_config_from_cfg({**base, key: value})
    # ported since: they parse
    for key, value in (("RAY_CHUNK", 4096), ("COMPUTE_DTYPE", "bfloat16")):
        rc = configs.renderer_config_from_cfg({**base, key: value})
        assert getattr(rc, key.lower()) == value
    assert configs.renderer_config_from_cfg({**base, "MARCH_BWD_PRECISION": "f32stash"}) \
        == configs.renderer_config_from_cfg(base)


@pytest.mark.parametrize("acts,saved", [("auto", True), ("save", True), ("recompute", False)])
def test_render_rays_train_runs_the_resolved_mode(acts, saved):
    """The loss path passes rcfg.march_acts to the march: 'auto' at this
    shape and 'save' run the save twins, 'recompute' the recompute twins,
    with the same loss partials and the same gradients (f32 products: the
    two modes are one arithmetic)."""
    jr = SMALL_COLOR
    pr = dataclasses.replace(port_cfg(jr), fused_march="on", march_acts=acts, perturb=0.0)
    tp = state_from_numpy(jax_params(jr, 41))
    ro, rd, _ = _rays_z(3, 4, seed=42)
    o, d = torch.tensor(np.asarray(ro)), torch.tensor(np.asarray(rd))
    near, far = near_far_from_sphere(o, d)
    calls = []
    real = RM.ray_march_bwd_plain

    def spy(*args, stash=None, **kw):
        calls.append(stash is not None)
        return real(*args, stash=stash, **kw)

    RM.ray_march_bwd_plain = spy
    try:
        out = neus.render_rays_train(tp, pr, o, d, near, far)
        loss = out["color_fine"].sum() + out["gradient_error"]
        grads = torch.autograd.grad(loss, list(tp.parameters()), allow_unused=True)
    finally:
        RM.ray_march_bwd_plain = real
    assert calls == [saved]
    pr_ref = dataclasses.replace(pr, march_acts="recompute")
    ref = neus.render_rays_train(tp, pr_ref, o, d, near, far)
    loss_ref = ref["color_fine"].sum() + ref["gradient_error"]
    grads_ref = torch.autograd.grad(loss_ref, list(tp.parameters()), allow_unused=True)
    assert float(loss.detach()) == float(loss_ref.detach())
    for a, b in zip(grads, grads_ref):
        if b is None:
            assert a is None
            continue
        scale = float(b.abs().max()) + 1e-6
        assert float((a - b).abs().max()) <= SAVE_VS_RECOMPUTE * scale
