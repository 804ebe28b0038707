"""The plain twins' bf16 arithmetic (the CUDA kernels' products) against the
TPU kernels' own, on the CPU at small widths.

On the TPU the JAX kernels run with bf16 = not interpret: every _kdot /
_kdot_b is a single-pass bf16 dot with f32 accumulation, the weights are
cast to bf16, and under MARCH_BWD_PRECISION f32stash the gates and the SDF
stores stay f32 while layer 0's weight grad takes its f32 operands as
hi + lo bf16 pairs. Here the JAX kernel bodies run with that flag set
under interpret=True, through test-local pl.pallas_calls that copy
_pallas_fwd_call / _pallas_bwd_call (point_pipeline.py) and
_march_fwd_call / _march_bwd_call (ray_march.py) with the flag set and
cast_kernel_weights(meta, ws, False), THIN_DOTS vpu (the port's exact-f32
positional encoding). XLA on the CPU would keep excess precision between
bf16 operations (a bf16 value computed in f32 and fed on without its
rounding); the TPU's compiler rounds every bf16 value, so the JAX runs are
compiled with xla_allow_excess_precision off.

The same inputs, made from a seed with numpy, go through the port's plain
twins with bf16=True (point_pipeline_plain / point_pipeline_bwd_plain,
ray_march_plain / ray_march_bwd_plain): the forward outputs, pts and dirs
(rays) grads and every weight and bias leaf, Color-NeuS and NeuS. Each
within RTOL norm-relative of JAX's bf16 run (the same roundings summed in
another order: a product whose f32 sum lies within rounding of a bf16
midpoint rounds to the other neighbour in one run, and propagates; read
<= 9.3e-5), and, on every output or leaf where JAX's bf16 run is more than
1e-2 from its f32 run (interpret arithmetic), within a tenth of that gap."""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from color_neus_tpu.models import configs as jconfigs
from color_neus_tpu.ops.pallas import point_pipeline as JPP
from color_neus_tpu.ops.pallas import ray_march as JRM

from color_neus_torch import pin_precision
from color_neus_torch.models import configs
from color_neus_torch.ops.kernels import point_pipeline as PP
from color_neus_torch.ops.kernels import ray_march as RM
from color_neus_torch.weights import state_from_numpy
from tests.test_torch_point_pipeline import _params, _pts_dirs, _rcfg
from tests.test_torch_point_pipeline_bwd import _cotangents

torch.set_num_threads(1)
pin_precision()

T = 64
RTOL = 1e-3
GAP = 1e-2
CASES = [("color_neus", "no_view_dir"), ("neus", "idr")]


def _vmem(shape, index):
    return pl.BlockSpec(shape, index, memory_space=pltpu.VMEM)


def _const(x):
    return _vmem(x.shape, lambda i: (0, 0))


def _jit(fn):
    """fn compiled without XLA's excess precision: every bf16 value rounds,
    as the TPU's compiler rounds it."""
    return jax.jit(fn, compiler_options={"xla_allow_excess_precision": False})


def _grads_to_dense(jr, dense, hats):
    """The packed-layout weight / bias grads pulled back to the dense
    weights (the transpose of pack_pipeline_weights)."""
    _, vjp = jax.vjp(lambda d: tuple(JPP.pack_pipeline_weights(d, jr)[0])
                     + tuple(JPP.pack_pipeline_weights(d, jr)[1]), dense)
    return vjp(tuple(hats))[0]


def _jax_pipeline(jr, bf16, dense, pts, dirs, gbar):
    """JAX's fused forward and backward kernels, bf16 = the flag: (the [n,
    16] outputs, pts_hat, dirs_hat, the dense grads)."""
    ws, bs, meta = JPP.pack_pipeline_weights(dense, jr)
    n = pts.shape[0]
    n_pad = -(-n // T) * T
    pin = JPP.pack_point_inputs(jnp.zeros((n_pad, 3)).at[:n].set(pts),
                                jnp.zeros((n_pad, 3)).at[:n].set(dirs))
    bm_e, bm_c, bm_r = JPP.pe_bases(jr)
    ws_in = JPP.cast_kernel_weights(meta, ws, not bf16)
    wts_in = tuple(w.T for w in ws_in[:meta.n_sdf])
    grid = (n_pad // T,)
    out = pl.pallas_call(
        partial(JPP._fwd_kernel_entry, meta, T, bf16), grid=grid,
        in_specs=[_vmem((T, 8), lambda i: (i, 0))]
        + [_const(x) for x in (bm_e, bm_c, bm_r, *ws_in, *wts_in, *bs)],
        out_specs=_vmem((T, 16), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((n_pad, 16), jnp.float32), interpret=True,
    )(pin, bm_e, bm_c, bm_r, *ws_in, *wts_in, *bs)
    gb = jnp.zeros((n_pad, 16), jnp.float32).at[:n].set(gbar)
    wts_in = tuple(w.T for w in ws_in)
    outs = pl.pallas_call(
        partial(JPP._bwd_kernel_entry, meta, T, bf16), grid=grid,
        in_specs=[_vmem((T, 8), lambda i: (i, 0))] + [_const(x) for x in (bm_e, bm_c, bm_r)]
        + [_vmem((T, 16), lambda i: (i, 0))] + [_const(x) for x in (*ws_in, *wts_in, *bs)],
        out_specs=[_vmem((T, 8), lambda i: (i, 0))] + [_const(x) for x in (*ws, *bs)],
        out_shape=[jax.ShapeDtypeStruct((n_pad, 8), jnp.float32)]
        + [jax.ShapeDtypeStruct(x.shape, jnp.float32) for x in (*ws, *bs)],
        interpret=True,
    )(pin, bm_e, bm_c, bm_r, gb, *ws_in, *wts_in, *bs)
    return out[:n], outs[0][:n, 0:3], outs[0][:n, 4:7], _grads_to_dense(jr, dense, outs[1:])


def _jax_march(jr, bf16, dense, rays_o, rays_d, z, inv_s, gbar):
    """JAX's fused march kernels, forward and backward (recompute, one ray
    per tile), bf16 = the flag: ([R, 16], rays_o_hat, rays_d_hat,
    inv_s_hat, the dense grads)."""
    ws, bs, meta = JPP.pack_pipeline_weights(dense, jr)
    R, S = z.shape
    Rt, TS = 1, S
    rays = jnp.concatenate([rays_o, jnp.zeros((R, 1)), rays_d, jnp.zeros((R, 1))], axis=1)
    z_pt = z.reshape(R * S, 1)
    sinv = jnp.broadcast_to(jnp.asarray(inv_s, jnp.float32).reshape(1, 1), (1, 128))
    bm_e, bm_c, bm_r = JPP.pe_bases(jr)
    sd = 2.0 / jr.n_samples
    ws_in = JPP.cast_kernel_weights(meta, ws, not bf16)
    grid = (R,)
    rays3 = rays.reshape(R, Rt, 8)
    head = [_vmem((1, Rt, 8), lambda i: (i, 0, 0)), _vmem((TS, 1), lambda i: (i, 0)),
            _const(sinv), _const(bm_e), _const(bm_c), _const(bm_r)]
    wts_in = tuple(w.T for w in ws_in[:meta.n_sdf])
    out = pl.pallas_call(
        partial(JRM._march_fwd_entry, meta, TS, S, bf16, sd, False), grid=grid,
        in_specs=head + [_const(x) for x in (*ws_in, *wts_in, *bs)],
        out_specs=_vmem((1, Rt, 16), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((R, Rt, 16), jnp.float32), interpret=True,
    )(rays3, z_pt, sinv, bm_e, bm_c, bm_r, *ws_in, *wts_in, *bs)
    wts_in = tuple(w.T for w in ws_in)
    outs = pl.pallas_call(
        partial(JRM._march_bwd_entry, meta, TS, S, bf16, sd, False), grid=grid,
        in_specs=head + [_vmem((1, Rt, 16), lambda i: (i, 0, 0))]
        + [_const(x) for x in (*ws_in, *wts_in, *bs)],
        out_specs=[_vmem((1, Rt, 8), lambda i: (i, 0, 0)), _const(sinv)]
        + [_const(x) for x in (*ws, *bs)],
        out_shape=[jax.ShapeDtypeStruct((R, Rt, 8), jnp.float32),
                   jax.ShapeDtypeStruct(sinv.shape, jnp.float32)]
        + [jax.ShapeDtypeStruct(x.shape, jnp.float32) for x in (*ws, *bs)],
        interpret=True,
    )(rays3, z_pt, sinv, bm_e, bm_c, bm_r, gbar.reshape(R, Rt, 16), *ws_in, *wts_in, *bs)
    rays_hat = outs[0].reshape(R, 8)
    return (out.reshape(R, 16), rays_hat[:, 0:3], rays_hat[:, 4:7], outs[1][0, 0],
            _grads_to_dense(jr, dense, outs[2:]))


def _leaves(d, kind, grads):
    """Add every leaf of `grads` ({net: [(dW, db)]} or JAX's dense dict) to d."""
    for net in ("sdf", "color", "relight") if kind == "color_neus" else ("sdf", "color"):
        layers = grads[net] if net in grads else list(zip(grads[f"{net}_w"], grads[f"{net}_b"]))
        for l, (w, b) in enumerate(layers):
            d[f"{net} layer {l} W"], d[f"{net} layer {l} b"] = np.asarray(w), np.asarray(b)
    return d


def _nrel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _compare(port, jax16, jax32):
    for k, j16 in jax16.items():
        err, gap = _nrel(port[k], j16), _nrel(j16, jax32[k])
        assert err <= RTOL, f"{k}: {err:.3e} from JAX's bf16 run, above {RTOL:g}"
        assert gap <= GAP or err < 0.1 * gap, \
            f"{k}: {err:.3e} from JAX's bf16 run, not below a tenth of its f32 gap {gap:.3e}"


def _configs(kind, mode):
    jr = dataclasses.replace(_rcfg(jconfigs, kind, mode), march_bwd_precision="f32stash",
                             thin_dots="vpu")
    return jr, _rcfg(configs, kind, mode)


@pytest.mark.parametrize("kind,mode", CASES, ids=[k for k, _ in CASES])
def test_pipeline_bf16_twin_matches_tpu_arithmetic(kind, mode):
    jr, pr = _configs(kind, mode)
    params = _params(jr, seed=3)
    pts, dirs = _pts_dirs(97, seed=4)
    cots = _cotangents(97, seed=6)
    gbar = np.concatenate(cots + [np.zeros((97, 3), np.float32)], axis=1)
    dense = JPP.resolve_dense(params, jr)
    runs = {}
    for bf16 in (True, False):
        out, ph, dh, g = _jit(partial(_jax_pipeline, jr, bf16))(dense, pts, dirs, gbar)
        d = {name: np.asarray(out[:, a:b]) for name, a, b in
             zip(("sdf", "grad", "gc", "relit", "delta"), (0, 1, 4, 7, 10), (1, 4, 7, 10, 13))}
        d.update(pts=np.asarray(ph), dirs=np.asarray(dh))
        runs[bf16] = _leaves(d, kind, g)
    pw = PP.resolve_pipeline_weights(state_from_numpy(params), pr)
    tp, td = torch.from_numpy(pts), torch.from_numpy(dirs)
    fwd = PP.point_pipeline_plain(pw, tp, td, bf16=True)
    ph, dh, grads = PP.point_pipeline_bwd_plain(pw, tp, td, [torch.from_numpy(c) for c in cots],
                                                bf16=True)
    port = {name: t.numpy() for name, t in zip(("sdf", "grad", "gc", "relit", "delta"), fwd)}
    port.update(pts=ph.numpy(), dirs=dh.numpy())
    _compare(_leaves(port, kind, grads), runs[True], runs[False])


@pytest.mark.parametrize("kind,mode", CASES, ids=[k for k, _ in CASES])
def test_march_bf16_twin_matches_tpu_arithmetic(kind, mode):
    jr, pr = _configs(kind, mode)
    params = _params(jr, seed=5)
    rng = np.random.RandomState(7)
    R, S = 3, 16
    d = rng.randn(R, 3)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = (-1.4 * d + 0.1 * rng.randn(R, 3)).astype(np.float32)
    z = (0.5 + 1.8 * np.sort(rng.rand(R, S), axis=1)).astype(np.float32)
    inv_s = np.float32(20.0)
    gbar = rng.randn(R, 16).astype(np.float32)
    gbar[:, 7:] = 0.0
    dense = JPP.resolve_dense(params, jr)
    runs = {}
    for bf16 in (True, False):
        out, ro_h, rd_h, s_h, g = _jit(partial(_jax_march, jr, bf16))(dense, o, d, z, inv_s,
                                                                      gbar)
        runs[bf16] = _leaves({"out": np.asarray(out[:, :7]), "rays_o": np.asarray(ro_h),
                              "rays_d": np.asarray(rd_h), "inv_s": np.asarray(s_h)}, kind, g)
    pw = PP.resolve_pipeline_weights(state_from_numpy(params), pr)
    args = [torch.from_numpy(a) for a in (o, d, z)] + [torch.tensor([inv_s]), 2.0 / pr.n_samples]
    out = RM.ray_march_plain(pw, *args, bf16=True)
    ro_h, rd_h, s_h, grads = RM.ray_march_bwd_plain(pw, *args, torch.from_numpy(gbar), bf16=True)
    port = {"out": out[:, :7].numpy(), "rays_o": ro_h.numpy(), "rays_d": rd_h.numpy(),
            "inv_s": s_h.numpy()}
    _compare(_leaves(port, kind, grads), runs[True], runs[False])
