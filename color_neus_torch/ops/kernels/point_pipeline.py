"""The per-point pipeline and its backward: counterpart of
color_neus_tpu/ops/pallas/point_pipeline.py (fused_point_pipeline_fwd,
fused_point_pipeline and its custom_vjp _pipeline_core).

The pipeline maps (pts [N,3], dirs [N,3]) to (sdf [N,1], grad [N,3],
gc [N,3], relit [N,3], delta [N,3]): the SDF, its spatial gradient
(reverse mode), the global colour, the relit colour and the relight
residual (NeuS: relit = gc, delta = 0).

Forward, two implementations of one function:
  * launch_point_pipeline: the hand-written CUDA kernel
    csrc/point_pipeline.cu (its source note gives the bound and the
    design: 128-point tiles, every 256-wide product on wgmma from the
    weight slabs _pack_images packs). Runs for CUDA tensors, counts its launches in
    launch_point_pipeline.launches, raises on any build or launch failure.
  * point_pipeline_plain: the same function in plain PyTorch: the
    forward keeps the softplus gates g = 1 - exp(-100 softplus(a)), one
    reverse sweep takes the gradient, then the colour and relight nets.
    Runs for CPU tensors, and is what tests and chip_smoke.py compare the
    kernel against. Its `bf16` flag is the JAX kernels' own (bf16 = not
    interpret): True rounds every product's operands to bf16 and sums in
    f32, the kernel's arithmetic and the TPU's production one, but for the
    SDF chain, which follows rcfg.march_bwd_precision (_sdf_arith: f32
    products on unrounded SDF weights in 'f32', bf16 stores in 'bf16');
    False (the default) computes in f32, JAX's interpret arithmetic, in
    which the three modes are one.
fused_point_pipeline_fwd picks between them by the device of the
tensors it is given, and by nothing else; no gradient flows through it.

Backward (the VJP of the five outputs), two implementations likewise:
  * launch_point_pipeline_bwd: the second entry of csrc/point_pipeline.cu
    (recompute, relight / colour reverse, the SDF second-order
    reverse-over-forward, PE first and second derivative; its products on
    wgmma from the same weight slabs; weight grads summed
    on chip per batch of DW_BATCH tiles into a partial per block, then
    over blocks in a fixed order). Counts its launches in
    launch_point_pipeline_bwd.launches.
  * point_pipeline_bwd_plain: the same pullback in plain PyTorch, in the
    nets' own layouts and at any width (not autograd), with the same
    `bf16` flag.
fused_point_pipeline_bwd picks between them by device likewise.
fused_point_pipeline(params, rcfg, pts, dirs) is the differentiable
entry: PointPipelineFunction, forward = the forward above, backward = the
backward above, each chosen by device. Weight norm is resolved outside
the Function, with grad, so autograd carries the dense weight grads on to
the v / g / b leaves.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from color_neus_torch.models.configs import RendererConfig
from color_neus_torch.models.fields import resolve_linear
from color_neus_torch.ops.embedding import embedding_dim, positional_encoding
from color_neus_torch.ops.transforms import inverse_sigmoid

KERNEL = "point_pipeline"
HID = 256     # the kernel's hidden width
EMB = 48      # the kernel's padded PE / small-input width
MAXL = 16     # the kernel's most layers per network
DW_BATCH = 8  # tiles whose weight grads a backward block sums on chip per read-modify-write
_INV_SQRT2 = 1.0 / math.sqrt(2.0)
_SQRT2 = math.sqrt(2.0)
# slots of the kernel's offset table (csrc/point_pipeline.cu)
W_SDF, WT_SDF, B_SDF, W_COL, B_COL, W_REL, B_REL, WT_COL, WT_REL = (i * MAXL for i in range(9))
W_LAST, B_LAST, W_FEAT, B_FEAT, WT_FEAT = (9 * MAXL + i for i in range(5))
N_OFF = 9 * MAXL + 5
_MAX_BLOCKS: dict = {}   # (device, mode, entry) -> blocks resident at once (sizes the scratch)
# MARCH_BWD_PRECISION: each mode's kernels are their own instantiation, in
# a library of their own (csrc/point_pipeline_tile.cuh Prec), whose
# kernels carry the suffix
MODES = ("f32stash", "bf16", "f32")
SUFFIX = {"f32stash": "", "bf16": "_bf16s", "f32": "_f32s"}


@dataclass
class PipelineWeights:
    """Weight-norm-resolved weights of the three nets, (w [out, in], b [out])
    per layer in the networks' own widths; packed / off: the kernel's f32
    buffer and its offset table (None for CPU weights); n_grad: its length,
    the gradient layout; images / ioff: the kernels' wgmma weight slabs
    (_pack_images) and their offset table (slabs), packed on the weights'
    device at the first launch (weight_images) and shared by every launch
    on these weights (a training step's forward and backward, an
    extraction's chunks)."""
    rcfg: RendererConfig
    sdf: list
    color: list
    relight: list
    packed: torch.Tensor | None = None
    off: np.ndarray | None = None
    n_grad: int = 0
    images: torch.Tensor | None = None
    ioff: np.ndarray | None = None


def _color_dv(rcfg: RendererConfig) -> int:
    c = rcfg.color
    if c.mode == "no_view_dir":
        return 0
    return embedding_dim(3, c.multires_view) if c.multires_view > 0 else 3


def _relight_dv(rcfg: RendererConfig) -> int:
    r = rcfg.relight
    return embedding_dim(3, r.multires_view) if r.multires_view > 0 else 3


def _check_kernel_shape(rcfg: RendererConfig):
    """The shapes the CUDA kernel takes; anything else raises ValueError."""
    s, c, r = rcfg.sdf, rcfg.color, rcfg.relight
    d0 = embedding_dim(s.d_in, s.multires) if s.multires > 0 else s.d_in
    n_sdf = s.n_layers + 1
    skips = tuple(s.skip_in)
    ok = (s.d_in == 3 and s.multires > 0 and d0 <= EMB and s.d_hidden == HID
          and len(skips) <= 1 and all(1 <= k <= n_sdf - 2 for k in skips)
          and s.d_out - 1 == HID and 2 <= n_sdf <= MAXL + 1)
    ok = ok and (c.mode in ("idr", "no_view_dir") and c.d_feature == HID and c.d_hidden == HID
                 and c.d_out == 3 and 1 <= c.n_layers < MAXL and 6 + _color_dv(rcfg) <= EMB)
    if rcfg.kind == "color_neus":
        ok = ok and (r.d_in == 6 and r.d_hidden == HID and r.d_out == 3
                     and 1 <= r.n_layers < MAXL and 1 <= r.y_in_layer <= r.n_layers
                     and 6 + _relight_dv(rcfg) <= EMB)
    if not ok:
        raise ValueError(
            "the point_pipeline CUDA kernel supports an SDF of d_in=3, 0<multires<=7, "
            f"d_hidden={HID}, 256 features and at most one skip layer inside the net; a "
            f"colour net in idr or no_view_dir mode of width {HID} with 3 outputs; a relight "
            f"net of width {HID} with 3 outputs and 1 <= y_in_layer <= n_layers; got {rcfg}")
    return d0, (skips[0] if skips else -1), n_sdf


def _layout(pw: PipelineWeights):
    """The kernel's weight blocks: ([(slot, block)] of the f32 buffer in
    its order, [(W slot, WT slot, block)] of the 256-wide layers). The f32
    buffer holds every block a gradient flows to: SDF hidden layers as [K,
    256] ([in, out]; K = 48 for the PE layer, 256 + 48 for the skip layer's
    [h, emb], else 256); the last SDF layer as its sdf row [256] and the
    features [256, 256] ([in, out]); colour layer 0 as [features 256 | pts,
    grad, PE(dirs)] x 256; relight layer 0 as [pts, grad, PE(dirs)] x 256
    and the y_in layer as [h 256 | gc] x out; hidden layers [256, 256]; the
    last colour / relight layer row-major [3, K]. Zero padding keeps the
    math exact: padded inputs meet zero weight rows."""
    rcfg = pw.rcfg
    d0, skip, n_sdf = _check_kernel_shape(rcfg)
    dev = pw.sdf[0][0].device
    blocks, wide = [], []

    def put(slot, t):
        blocks.append((slot, t))

    def put_wide(w_slot, wt_slot, wp):
        # a [K, 256] block of a 256-wide layer; the reverse products read its
        # transpose (wt_slot)
        wide.append((w_slot, wt_slot, wp))

    def z(*shape):
        return torch.zeros(shape, device=dev)

    def bias(b, n=HID):
        out = z(n)
        out[:b.shape[0]] = b
        return out

    for l, (w, b) in enumerate(pw.sdf[:-1]):
        wt = w.T                                       # [in, out]
        d_in, d_out = wt.shape
        if l == 0:
            wp = z(EMB, HID)
            wp[:d0, :d_out] = wt
        elif l == skip:
            h = d_in - d0
            wp = z(HID + EMB, HID)
            wp[:h, :d_out] = wt[:h]
            wp[HID:HID + d0, :d_out] = wt[h:]
        else:
            wp = z(HID, HID)
            wp[:d_in, :d_out] = wt
        put(W_SDF + l, wp)
        put_wide(W_SDF + l, WT_SDF + l, wp)
        put(B_SDF + l, bias(b))
    w, b = pw.sdf[-1]
    put(W_LAST, w[0])
    put(B_LAST, b[:1])
    put(W_FEAT, w[1:].T)
    put(B_FEAT, b[1:])
    put_wide(W_FEAT, WT_FEAT, w[1:].T)

    dv = _color_dv(rcfg)
    n_color = len(pw.color)
    for l, (w, b) in enumerate(pw.color):
        wt = w.T
        last = l == n_color - 1
        if l == 0:
            # the net's input order: [pts, PE(dirs) (idr), grad, features]
            wp = z(HID + EMB, HID)
            wp[HID:HID + 3] = wt[0:3]
            wp[HID + 6:HID + 6 + dv] = wt[3:3 + dv]
            wp[HID + 3:HID + 6] = wt[3 + dv:6 + dv]
            wp[:HID] = wt[6 + dv:]
        elif last:
            wp = w                                     # [3, 256]
        else:
            wp = wt
        put(W_COL + l, wp)
        put(B_COL + l, b if last else bias(b))
        if not last:
            put_wide(W_COL + l, WT_COL + l, wp)

    if rcfg.kind == "color_neus":
        rl = rcfg.relight
        rdv = _relight_dv(rcfg)
        n_rel = len(pw.relight)
        for l, (w, b) in enumerate(pw.relight):
            wt = w.T
            last = l == n_rel - 1
            if l == 0:
                # the net's input order: [pts, PE(dirs), grad]
                wp = z(EMB, HID)
                wp[0:3] = wt[0:3]
                wp[6:6 + rdv] = wt[3:3 + rdv]
                if rl.include_grad:
                    wp[3:6] = wt[3 + rdv:6 + rdv]
            elif l == rl.y_in_layer:
                # the net's input order: [gc, h]
                wp = z(HID + EMB, wt.shape[1])
                wp[:HID] = wt[3:]
                wp[HID:HID + 3] = wt[:3]
                if last:
                    wp = wp.T                          # [3, 304]
            else:
                wp = w if last else wt
            put(W_REL + l, wp)
            put(B_REL + l, b if last else bias(b))
            if not last:
                put_wide(W_REL + l, WT_REL + l, wp)
    return blocks, wide


def _frag(b: torch.Tensor) -> torch.Tensor:
    """A [K, N] block (K a multiple of 16, N of 8) in mma.m16n8k16 B
    fragment order, bf16: for each 16-row k-step and 8-column n-tile, 32
    lanes x 4 values, lane 4 g + t holding rows 2t, 2t + 1, 2t + 8, 2t + 9
    of column g (the SDF sweep's and grid SDF's bf16 weight slabs,
    csrc/sdf_rays.cu)."""
    K, N = b.shape
    t = b.reshape(K // 16, 2, 4, 2, N // 8, 8).permute(0, 4, 5, 2, 1, 3)
    return t.reshape(-1).to(torch.bfloat16)


def _pack(pw: PipelineWeights):
    """The kernel's f32 weight buffer (see csrc/point_pipeline_tile.cuh):
    _layout's blocks flattened in order, each from a multiple of 4 floats
    (zeros between: the march's load entry adds its weight grads into the
    same layout with 16-byte vector reductions), its offset table and its
    length (a multiple of 4), the gradient layout."""
    blocks, _ = _layout(pw)
    off, pos, flat = np.zeros(N_OFF, np.int64), 0, []
    dev = blocks[0][1].device

    def pad():
        nonlocal pos
        if pos % 4:
            flat.append(torch.zeros(4 - pos % 4, device=dev))
            pos += 4 - pos % 4

    for slot, t in blocks:
        pad()
        off[slot] = pos
        flat.append(t.reshape(-1).float())
        pos += flat[-1].numel()
    pad()
    return torch.cat(flat).contiguous(), off, pos


SLAB_ROWS, SLAB_K = 64, 64    # a wgmma weight slab: 64 rows x 64 k of bf16, 8 KB


def _slabs(mat: torch.Tensor) -> torch.Tensor:
    """mat [N, D] (rows: a product's output columns, D its depth) as the
    kernels' weight slabs, bf16: chunks of 64 rows (the last one
    N % 64 rows), each cut into ceil(D / 64) slabs of 64 k, zero-padded
    to 64 x 64; a slab is K-major, row n's 16-byte chunk c (k 8 c .. 8 c
    + 8) stored at chunk c ^ (n % 8), the 128-byte swizzle
    (csrc/mlp_common.cuh sw128_offset; mlp_chain.pack_w_image's layout)."""
    n_rows, depth = mat.shape
    dp = -(-depth // SLAB_K) * SLAB_K
    n_ch = -(-n_rows // SLAB_ROWS)
    pad = torch.zeros((n_ch * SLAB_ROWS, dp), dtype=torch.float32, device=mat.device)
    pad[:n_rows, :depth] = mat
    t = pad.reshape(n_ch, SLAB_ROWS, dp // SLAB_K, 8, 8).permute(0, 2, 1, 3, 4)  # ch, k slab, n, c, e
    n = torch.arange(SLAB_ROWS, device=mat.device)
    chunk = torch.arange(8, device=mat.device)[None, :] ^ (n % 8)[:, None]       # [n, p] -> c
    return t[:, :, n[:, None], chunk].to(torch.bfloat16).reshape(-1)


def _is_sdf_slot(slot: int) -> bool:
    return W_SDF <= slot < W_SDF + MAXL or slot == W_FEAT


def split3(w: torch.Tensor):
    """(hi, mid, lo) of an f32 tensor, each bf16-representable (float32
    tensors): hi = bf16(w), mid = bf16(w - hi), lo = bf16(w - hi - mid),
    rounded to nearest even; hi + mid + lo == w exactly for normal w (JAX's
    Precision.HIGHEST split, the kernels' load_a3 / save_t3)."""
    w = w.float()
    hi = w.to(torch.bfloat16).float()
    mid = (w - hi).to(torch.bfloat16).float()
    lo = (w - hi - mid).to(torch.bfloat16).float()
    return hi, mid, lo


def _hp_steps(mat: torch.Tensor) -> torch.Tensor:
    """mat [N, D] (D a multiple of 16) as the six-pass product's B steps,
    [N, 64 D / 16]: k16 step s is 64 columns, split3's hi, mid and lo of
    mat[:, 16 s:16 s + 16] then 16 zeros, so that _slabs makes it one slab
    whose 128-byte row holds the step's three parts at 32-byte offsets
    (csrc/point_pipeline_tile.cuh hp_step)."""
    n, depth = mat.shape
    steps = torch.zeros((n, depth // 16, 4, 16), dtype=torch.float32, device=mat.device)
    for p, part in enumerate(split3(mat)):
        steps[:, :, p] = part.reshape(n, depth // 16, 16)
    return steps.reshape(n, -1)


def _pack_images(pw: PipelineWeights):
    """The kernels' wgmma weight slabs (csrc/point_pipeline_tile.cuh,
    wg_product) and their offset table in slabs: every 256-wide layer's
    [K, 256] block twice, in its forward slot (W_*: the transpose, rows the
    256 outputs, depth K) and in its reverse slot (WT_*: rows the layer's K
    inputs, depth its 256 outputs). In march_bwd_precision 'f32' the SDF
    layers' (and the features') products run in six bf16 passes
    (hp_product): their slots hold the three parts of split3 instead, one
    slab a k16 step of the product (_hp_steps)."""
    _, wide = _layout(pw)
    f32 = pw.rcfg.march_bwd_precision == "f32"
    ioff, pos, parts = np.zeros(N_OFF, np.int64), 0, []
    for w_slot, wt_slot, wp in wide:
        for slot, mat in ((w_slot, wp.T), (wt_slot, wp)):
            ioff[slot] = pos
            if f32 and _is_sdf_slot(w_slot):
                parts.append(_slabs(_hp_steps(mat.float())))
            else:
                parts.append(_slabs(mat.float()))
            pos += parts[-1].numel() // (SLAB_ROWS * SLAB_K)
    return torch.cat(parts).contiguous(), ioff


def weight_images(pw: PipelineWeights):
    """(images, ioff) of pw, packed on pw's device at the first call."""
    if pw.images is None:
        pw.images, pw.ioff = _pack_images(pw)
    return pw.images, pw.ioff


def _unpack_grads(pw: PipelineWeights, packed_grad: torch.Tensor) -> dict:
    """The transpose of _pack on a buffer in its layout (a gradient from the
    backward kernel): {"sdf" / "color" / "relight": [(dW [out, in], db
    [out]) per layer]} in each net's own layout. The last SDF layer comes
    back as one [257, 256] matrix; the transposed slots carry nothing."""
    rcfg = pw.rcfg
    d0, skip, _ = _check_kernel_shape(rcfg)
    off = pw.off
    g = packed_grad

    def blk(slot, rows, cols):
        return g[off[slot]:off[slot] + rows * cols].reshape(rows, cols)

    def vec(slot, n):
        return g[off[slot]:off[slot] + n]

    sdf = []
    for l, (w, _) in enumerate(pw.sdf[:-1]):
        d_out, d_in = w.shape
        if l == 0:
            wt = blk(W_SDF + l, EMB, HID)[:d0, :d_out]
        elif l == skip:
            wp = blk(W_SDF + l, HID + EMB, HID)
            h = d_in - d0
            wt = torch.cat([wp[:h, :d_out], wp[HID:HID + d0, :d_out]])
        else:
            wt = blk(W_SDF + l, HID, HID)[:d_in, :d_out]
        sdf.append((wt.T.contiguous(), vec(B_SDF + l, d_out).clone()))
    sdf.append((torch.cat([vec(W_LAST, HID)[None], blk(W_FEAT, HID, HID).T]),
                torch.cat([vec(B_LAST, 1), vec(B_FEAT, HID)])))

    dv = _color_dv(rcfg)
    color = []
    for l, (w, b) in enumerate(pw.color):
        d_out, d_in = w.shape
        if l == len(pw.color) - 1:
            color.append((blk(W_COL + l, d_out, d_in).clone(), vec(B_COL + l, d_out).clone()))
            continue
        if l == 0:
            wp = blk(W_COL + l, HID + EMB, HID)
            wt = torch.cat([wp[HID:HID + 3], wp[HID + 6:HID + 6 + dv], wp[HID + 3:HID + 6],
                            wp[:HID]])
        else:
            wt = blk(W_COL + l, HID, HID)
        color.append((wt.T.contiguous(), vec(B_COL + l, d_out).clone()))

    relight = []
    if rcfg.kind == "color_neus":
        rl = rcfg.relight
        rdv = _relight_dv(rcfg)
        for l, (w, b) in enumerate(pw.relight):
            d_out, d_in = w.shape
            last = l == len(pw.relight) - 1
            if l == 0:
                wp = blk(W_REL + l, EMB, HID)
                parts = [wp[0:3], wp[6:6 + rdv]] + ([wp[3:6]] if rl.include_grad else [])
                dw = torch.cat(parts).T
            elif l == rl.y_in_layer:
                wp = blk(W_REL + l, d_out, HID + EMB).T if last \
                    else blk(W_REL + l, HID + EMB, HID)
                dw = torch.cat([wp[HID:HID + 3], wp[:HID]]).T
            elif last:
                dw = blk(W_REL + l, d_out, d_in)
            else:
                dw = blk(W_REL + l, HID, HID).T
            relight.append((dw.contiguous(), vec(B_REL + l, d_out).clone()))
    return {"sdf": sdf, "color": color, "relight": relight}


def _layer_names(rcfg: RendererConfig) -> dict:
    names = {"sdf": [f"lin{l}" for l in range(rcfg.sdf.n_layers + 1)],
             "color": [f"lin{l}" for l in range(rcfg.color.n_layers + 1)], "relight": []}
    if rcfg.kind == "color_neus":
        names["relight"] = ["in_layer"] + [f"mlp{i}" for i in range(rcfg.relight.n_layers)]
    return names


def _make_weights(rcfg: RendererConfig, layers: dict) -> PipelineWeights:
    """PipelineWeights of detached f32 (w, b) per net; packed for CUDA."""
    def net(name):
        return [(w.detach().float(), b.detach().float()) for w, b in layers[name]]
    pw = PipelineWeights(rcfg, net("sdf"), net("color"), net("relight"))
    if pw.sdf[0][0].is_cuda:
        pw.packed, pw.off, pw.n_grad = _pack(pw)
    return pw


def resolve_pipeline_weights(params, rcfg: RendererConfig) -> PipelineWeights:
    """Resolve weight norm once (no grad: forward only) and, for CUDA
    weights, pack the kernel's buffer."""
    with torch.no_grad():
        layers = {net: [resolve_linear(params[net][n]) for n in names]
                  for net, names in _layer_names(rcfg).items()}
        return _make_weights(rcfg, layers)


def _softplus100_and_gate(a: torch.Tensor):
    # the kernel's forms: softplus max(a,0) + log1p(exp(-100|a|))/100, and
    # its gate rebuilt from the value, g = 1 - exp(-100 sp)
    sp = torch.clamp_min(a, 0.0) + torch.log1p(torch.exp(-100.0 * torch.abs(a))) / 100.0
    return sp, 1.0 - torch.exp(-100.0 * sp)


def _pe_slopes(x: torch.Tensor, multires: int) -> torch.Tensor:
    """d PE(x)_c / d x_j for each column c of its coordinate j: [N, d0]."""
    freqs = 2.0 ** torch.arange(multires, dtype=x.dtype, device=x.device)
    xb = x[:, None, :] * freqs[:, None]                                # [N, L, 3]
    f = freqs[None, :, None]
    slope = torch.stack([f * torch.cos(xb), -f * torch.sin(xb)], dim=-2)  # [N, L, 2, 3]
    return torch.cat([torch.ones_like(x), slope.reshape(x.shape[0], -1)], dim=-1)


def _pe_curvatures(x: torch.Tensor, multires: int) -> torch.Tensor:
    """d^2 PE(x)_c / d x_j^2 for each column c of its coordinate j: [N, d0]."""
    freqs = 2.0 ** torch.arange(multires, dtype=x.dtype, device=x.device)
    xb = x[:, None, :] * freqs[:, None]
    f2 = (freqs * freqs)[None, :, None]
    curv = torch.stack([-f2 * torch.sin(xb), -f2 * torch.cos(xb)], dim=-2)
    return torch.cat([torch.zeros_like(x), curv.reshape(x.shape[0], -1)], dim=-1)


def _per_coord(t: torch.Tensor) -> torch.Tensor:
    """[N, 3k] PE-column values -> [N, 3]: the sum over each column's coordinate."""
    return t.reshape(t.shape[0], -1, 3).sum(dim=1)


@dataclass
class _Stash:
    """What point_pipeline_bwd_plain reads of the forward: the scaled
    points, the SDF layer inputs and gates, the colour and relight layer
    inputs (each in its net's own layout); and the softplus outputs of the
    SDF's hidden layers, which the save mode keeps."""
    x: torch.Tensor
    xs: list
    gates: list
    cs: list
    rs: list
    sps: list


@dataclass
class ActStash:
    """The activations the fused march's save mode keeps per point, what
    its forward kernel writes to the activation stash (csrc/
    point_pipeline_tile.cuh act_layout), in each net's own layout: sp, the
    softplus of every hidden SDF layer (the inputs' dtype; with bf16 in
    march_bwd_precision 'bf16', the next layer's input as JAX stores it:
    the softplus times 1/sqrt(2) before the skip layer, rounded to bf16);
    cs, the hidden
    part of each colour layer's input (layer 0: the features); rs, each
    relight layer's from layer 1 on (the y_in layer without its gc); cs and
    rs in bf16 when bf16 (values rounded, the inputs' dtype kept); outs, the
    five outputs. _unstash rebuilds the rest, as the load kernel does."""
    sp: list
    cs: list
    rs: list
    outs: tuple


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to the nearest bfloat16 (ties to even), kept in t's dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def _hilo(t: torch.Tensor) -> torch.Tensor:
    """hi + lo of t's split into two bfloat16 (hi = bf16(t), lo = bf16(t -
    hi)), summed exactly in t's dtype: what the layer-0 weight grad's two
    bf16 passes see of its f32 operand (JAX _kdot_b_split)."""
    hi = _bf16(t)
    return hi + _bf16(t - hi)


def _operand(bf16: bool):
    """The rounding of a product's operands: bf16 (the kernels' tensor-core
    products, JAX's bf16=True dots) or none (f32, JAX's interpret mode)."""
    return _bf16 if bf16 else (lambda t: t)


def _rounded(pw: PipelineWeights, bf16: bool) -> PipelineWeights:
    """pw with every weight matrix rounded to bf16 when bf16 (JAX
    cast_kernel_weights; the biases stay f32) but the SDF layers' in
    march_bwd_precision 'f32', else pw itself."""
    if not bf16:
        return pw
    f32_sdf = pw.rcfg.march_bwd_precision == "f32"
    return PipelineWeights(pw.rcfg, *[[(w if net == "sdf" and f32_sdf else _bf16(w), b)
                                       for w, b in getattr(pw, net)]
                                      for net in ("sdf", "color", "relight")])


def _sdf_arith(rcfg: RendererConfig, bf16: bool):
    """(operand rounding of the SDF chain's products, store rounding of its
    tangent pre-gates): JAX's _sdf_bf / _sdf_store under
    rcfg.march_bwd_precision. bf16 products unless 'f32'; bf16 stores in
    'bf16' only; in f32 arithmetic (bf16 False) neither rounds."""
    mode = rcfg.march_bwd_precision
    keep = (lambda t: t)
    return (_bf16 if bf16 and mode != "f32" else keep,
            _bf16 if bf16 and mode == "bf16" else keep)


def _forward(pw: PipelineWeights, pts: torch.Tensor, dirs: torch.Tensor, bf16: bool = False):
    """The plain forward, op for op the kernel's arithmetic (summed in
    another order): returns the five outputs and the _Stash. bf16: every
    product rounds its operands to bf16 and sums in pts' dtype, as the CUDA
    kernels and the TPU kernels do (f32: JAX's interpret arithmetic), the
    SDF chain's products as rcfg.march_bwd_precision says (_sdf_arith).
    The layer inputs kept for the backward stay unrounded: JAX's bf16
    mode stores them in bf16, but every reader takes them as a bf16
    product operand, where that rounding is a no-op."""
    rcfg = pw.rcfg
    s = rcfg.sdf
    n = pts.shape[0]
    q = _operand(bf16)
    sq, _ = _sdf_arith(rcfg, bf16)
    pw = _rounded(pw, bf16)
    x = pts * s.scale
    emb = positional_encoding(x, s.multires)
    d0 = emb.shape[1]
    h, xs, gates, sps = emb, [], [], []
    for l, (w, b) in enumerate(pw.sdf):
        if l in s.skip_in:
            h = torch.cat([h, emb], dim=-1) * _INV_SQRT2
        xs.append(h)
        a = sq(h) @ w.T + b
        if l < len(pw.sdf) - 1:
            h, g = _softplus100_and_gate(a)
            gates.append(g)
            sps.append(h)
    sdf = a[:, :1] * (1.0 / s.scale)
    feat = a[:, 1:]

    # reverse sweep: p = d raw / d (layer input); the last layer's is its row 0
    emb_g = torch.zeros((n, d0), dtype=pts.dtype, device=pts.device)
    p = pw.sdf[-1][0][0].expand(n, -1)
    for l in range(len(pw.sdf) - 1, -1, -1):
        if l < len(pw.sdf) - 1:
            p = sq(p * gates[l]) @ pw.sdf[l][0]
        if l in s.skip_in:
            emb_g = emb_g + p[:, -d0:] * _INV_SQRT2
            p = p[:, :-d0] * _INV_SQRT2
    emb_g = emb_g + p
    contrib = emb_g * _pe_slopes(x, s.multires)
    grad = contrib[:, :3] + contrib[:, 3:].reshape(n, -1, 3).sum(dim=1)

    c = rcfg.color
    vd = positional_encoding(dirs, c.multires_view)
    if c.mode == "idr":
        h = torch.cat([pts, vd, grad, feat], dim=-1)
    elif c.mode == "no_view_dir":
        h = torch.cat([pts, grad, feat], dim=-1)
    else:
        raise ValueError(f"colour mode {c.mode!r}")
    cs = []
    for l, (w, b) in enumerate(pw.color):
        cs.append(h)
        h = q(h) @ w.T + b
        if l < len(pw.color) - 1:
            h = torch.relu(h)
    gc = torch.sigmoid(h) if c.squeeze_out else h

    stash = _Stash(x, xs, gates, cs, [], sps)
    if rcfg.kind != "color_neus":
        return (sdf, grad, gc, gc, torch.zeros_like(gc)), stash
    r = rcfg.relight
    feats = [pts, positional_encoding(dirs, r.multires_view)]
    if r.include_grad:
        feats.append(grad)
    h = torch.cat(feats, dim=-1)
    for l, (w, b) in enumerate(pw.relight):
        if l > 0:
            h = torch.relu(h)
            if l == r.y_in_layer:
                h = torch.cat([gc, h], dim=-1)
        stash.rs.append(h)
        h = q(h) @ w.T + b
    delta = h
    if r.inv_sigmoid:
        relit = torch.sigmoid(inverse_sigmoid(gc) + delta)
    else:
        relit = torch.clamp(gc + torch.sigmoid(delta) - 0.5, 0.0, 1.0)
    return (sdf, grad, gc, relit, delta), stash


def point_pipeline_plain(pw: PipelineWeights, pts: torch.Tensor, dirs: torch.Tensor,
                         bf16: bool = False):
    """Plain PyTorch pipeline forward, the kernel's arithmetic op for op
    (summed in another order); bf16 as _forward."""
    with torch.no_grad():
        return _forward(pw, pts, dirs, bf16)[0]


def stash_activations(rcfg: RendererConfig, outs, st: _Stash, bf16: bool = False) -> ActStash:
    """The ActStash of a forward (_forward's outputs and _Stash): bf16
    rounds the colour and relight parts, as the kernel stores them, and in
    march_bwd_precision 'bf16' the SDF part too (each hidden layer's
    output as the next layer takes it: JAX's SX stash)."""
    keep = _bf16 if bf16 else (lambda t: t)
    y_in = rcfg.relight.y_in_layer
    cs = [keep(st.cs[0][:, -rcfg.color.d_feature:])] + [keep(c) for c in st.cs[1:]]
    rs = [keep(r[:, 3:] if l == y_in else r) for l, r in enumerate(st.rs) if l > 0]
    sp = list(st.sps)
    if bf16 and rcfg.march_bwd_precision == "bf16":
        sp = [_bf16(h * _INV_SQRT2 if l + 1 in rcfg.sdf.skip_in else h)
              for l, h in enumerate(sp)]
    return ActStash(sp, cs, rs, tuple(outs))


def _unstash(pw: PipelineWeights, pts: torch.Tensor, dirs: torch.Tensor, a: ActStash,
             bf16: bool = False):
    """(outs, _Stash) from an ActStash, as the load kernel rebuilds them:
    the gates 1 - exp(-100 sp), the skip input [sp, PE] / sqrt(2), the PE
    and the small inputs from the points, the y_in layer's gc from outs.
    With bf16 in march_bwd_precision 'bf16' the stash holds the layer
    inputs in bf16 (stash_activations): the skip input is [x, PE /
    sqrt(2)], and the gate's softplus x sqrt(2) there (JAX
    unflatten_stash)."""
    rcfg = pw.rcfg
    s, c, r = rcfg.sdf, rcfg.color, rcfg.relight
    _, grad, gc, _, _ = a.outs
    x = pts * s.scale
    emb = positional_encoding(x, s.multires)
    xs, gates = [emb], []
    stored16 = bf16 and rcfg.march_bwd_precision == "bf16"
    for l, sp in enumerate(a.sp):
        skip = l + 1 in s.skip_in
        if stored16:
            gates.append(1.0 - torch.exp(-100.0 * (sp * _SQRT2 if skip else sp)))
            xs.append(torch.cat([sp, emb * _INV_SQRT2], dim=-1) if skip else sp)
            continue
        gates.append(1.0 - torch.exp(-100.0 * sp))
        xs.append(torch.cat([sp, emb], dim=-1) * _INV_SQRT2 if skip else sp)
    if c.mode == "idr":
        small = [pts, positional_encoding(dirs, c.multires_view), grad]
    else:
        small = [pts, grad]
    cs = [torch.cat(small + [a.cs[0]], dim=-1)] + list(a.cs[1:])
    rs = []
    if rcfg.kind == "color_neus":
        feats = [pts, positional_encoding(dirs, r.multires_view)] + ([grad] if r.include_grad
                                                                     else [])
        rs = [torch.cat(feats, dim=-1)] + [torch.cat([gc, h], dim=-1) if l + 1 == r.y_in_layer
                                           else h for l, h in enumerate(a.rs)]
    return a.outs, _Stash(x, xs, gates, cs, rs, list(a.sp))


def point_pipeline_bwd_plain(pw: PipelineWeights, pts: torch.Tensor, dirs: torch.Tensor,
                             cotangents, bf16: bool = False, stash: ActStash | None = None):
    """Plain PyTorch VJP of the pipeline, the JAX kernel's pullback
    (_mlp_recompute + _mlp_pullback) op for op in the nets' own layouts.
    cotangents: those of (sdf, grad, gc, relit, delta). Returns (pts_hat
    [N,3], dirs_hat [N,3], {"sdf" / "color" / "relight": [(dW [out, in],
    db [out]) per layer]}). bf16: the TPU kernels' production arithmetic
    (bf16 = not interpret, f32stash): every product rounds its operands to
    bf16 and sums in pts' dtype, but for layer 0's weight grad, whose f32
    operands (the PE and the tangent seed) go in as hi + lo bf16 pairs, and
    the last layer's rank-1 tangent term, summed in f32; the SDF chain as
    rcfg.march_bwd_precision says (_sdf_arith: 'bf16' rounds the stored
    tangent pre-gates z, 'f32' computes every SDF product, layer 0's
    weight grad included, in f32 on unrounded SDF weights). stash: the save
    mode's (stash_activations of the forward on these points, with the
    same bf16), read instead of recomputing the forward (JAX's
    unflatten_stash + _mlp_pullback)."""
    rcfg = pw.rcfg
    s = rcfg.sdf
    q = _operand(bf16)
    sq, zstore = _sdf_arith(rcfg, bf16)
    with torch.no_grad():
        (_, _, gc, relit, delta), st = (_forward(pw, pts, dirs, bf16) if stash is None
                                        else _unstash(pw, pts, dirs, stash, bf16))
        pw = _rounded(pw, bf16)
        sdf_hat, grad_hat, gc_hat, relit_hat, delta_hat = cotangents
        pts_hat = torch.zeros_like(pts)
        dirs_hat = torch.zeros_like(dirs)
        grads = {"sdf": [None] * len(pw.sdf), "color": [None] * len(pw.color),
                 "relight": [None] * len(pw.relight)}

        def layer_back(net, l, x, hbar):
            """dW, db of layer l from its input x and output cotangent hbar;
            returns the input cotangent."""
            grads[net][l] = (q(hbar).T @ q(x), hbar.sum(dim=0))
            return q(hbar) @ getattr(pw, net)[l][0]

        # relit / relight
        if rcfg.kind == "color_neus":
            r = rcfg.relight
            if r.inv_sigmoid:
                sbar = relit * (1.0 - relit) * relit_hat
                delta_tot = delta_hat + sbar
                zero = torch.zeros_like(gc)
                dlogit = torch.where(gc > 1e-5, 1.0 / torch.clamp_min(gc, 1e-5), zero) \
                    + torch.where(1.0 - gc > 1e-5, 1.0 / torch.clamp_min(1.0 - gc, 1e-5), zero)
                inside = ((gc > 0.0) & (gc < 1.0)).to(gc.dtype)
                gc_tot = gc_hat + sbar * dlogit * inside
            else:
                sd = torch.sigmoid(delta)
                pre = gc + sd - 0.5
                gate = ((pre > 0.0) & (pre < 1.0)).to(gc.dtype)
                gc_tot = gc_hat + gate * relit_hat
                delta_tot = delta_hat + gate * relit_hat * sd * (1.0 - sd)
            hbar = delta_tot
            for l in range(len(pw.relight) - 1, -1, -1):
                xbar = layer_back("relight", l, st.rs[l], hbar)
                x_h = st.rs[l]
                if l == r.y_in_layer:
                    gc_tot = gc_tot + xbar[:, :3]
                    xbar, x_h = xbar[:, 3:], x_h[:, 3:]
                if l > 0:
                    hbar = xbar * (x_h > 0.0)
            rdv = _relight_dv(rcfg)
            pts_hat += xbar[:, :3]
            dirs_hat += _per_coord(xbar[:, 3:3 + rdv] * _pe_slopes(dirs, r.multires_view))
            if r.include_grad:
                grad_hat = grad_hat + xbar[:, 3 + rdv:6 + rdv]
        else:
            gc_tot = gc_hat + relit_hat                    # relit aliases gc

        # colour
        c = rcfg.color
        hbar = gc * (1.0 - gc) * gc_tot if c.squeeze_out else gc_tot
        for l in range(len(pw.color) - 1, -1, -1):
            xbar = layer_back("color", l, st.cs[l], hbar)
            if l > 0:
                hbar = xbar * (st.cs[l] > 0.0)
        dv = _color_dv(rcfg)
        pts_hat += xbar[:, :3]
        if dv:
            dirs_hat += _per_coord(xbar[:, 3:3 + dv] * _pe_slopes(dirs, c.multires_view))
        grad_hat = grad_hat + xbar[:, 3 + dv:6 + dv]
        feat_hat = xbar[:, 6 + dv:]

        # SDF, second order: <grad, grad_hat> is 1/scale times the derivative
        # of the raw sdf along grad_hat, so one forward tangent stream v along
        # grad_hat, then value and tangent reversed together
        L = len(pw.sdf)
        inv_scale = 1.0 / s.scale
        slopes = _pe_slopes(st.x, s.multires)
        d0 = slopes.shape[1]
        gh = grad_hat.repeat(1, d0 // 3)                   # column c -> grad_hat[:, c % 3]
        v0 = s.scale * slopes * gh                          # d emb . grad_hat
        v, us, zs = v0, [], []
        for l in range(L - 1):
            if l in s.skip_in:
                v = torch.cat([v, v0], dim=-1) * _INV_SQRT2
            us.append(v)
            z = sq(v) @ pw.sdf[l][0].T
            zs.append(zstore(z))
            v = st.gates[l] * z
        if L - 1 in s.skip_in:
            v = torch.cat([v, v0], dim=-1) * _INV_SQRT2
        # last layer: value cotangent ybar, tangent cotangent inv_scale e0
        w_last = pw.sdf[-1][0]
        ybar = torch.cat([sdf_hat * inv_scale, feat_hat], dim=-1)
        dw = sq(ybar).T @ sq(st.xs[-1])
        dw[0] += inv_scale * v.sum(dim=0)
        grads["sdf"][L - 1] = (dw, ybar.sum(dim=0))
        emb_hat = torch.zeros_like(slopes)
        v0_hat = torch.zeros_like(slopes)

        def split(l, hbar, ubar):
            nonlocal emb_hat, v0_hat
            if l in s.skip_in:
                emb_hat = emb_hat + hbar[:, -d0:] * _INV_SQRT2
                v0_hat = v0_hat + ubar[:, -d0:] * _INV_SQRT2
                return hbar[:, :-d0] * _INV_SQRT2, ubar[:, :-d0] * _INV_SQRT2
            return hbar, ubar

        # ubar: JAX multiplies its bf16 weight row by 1/scale cast to bf16,
        # in bf16 (in 'f32' its f32 row by 1/scale, in f32)
        inv_s = sq(torch.tensor(inv_scale, dtype=pts.dtype, device=pts.device))
        hbar, ubar = split(L - 1, sq(ybar) @ w_last,
                           sq(inv_s * w_last[0]).expand(pts.shape[0], -1))
        for l in range(L - 2, -1, -1):
            g, z = st.gates[l], zs[l]
            abar = g * hbar + (ubar * z) * (100.0 * g * (1.0 - g))
            zbar = g * ubar
            xq = _hilo if bf16 and l == 0 and rcfg.march_bwd_precision != "f32" else sq
            grads["sdf"][l] = (sq(abar).T @ xq(st.xs[l]) + sq(zbar).T @ xq(us[l]),
                               abar.sum(dim=0))
            w = pw.sdf[l][0]
            hbar, ubar = split(l, sq(abar) @ w, sq(zbar) @ w)
        emb_hat = emb_hat + hbar
        v0_hat = v0_hat + ubar

        # the PE's first derivative, and its second through the tangent seed
        # v0 = scale * slope(x) * grad_hat
        pts_hat += s.scale * _per_coord(emb_hat * slopes)
        pts_hat += s.scale * s.scale * _per_coord(v0_hat * _pe_curvatures(st.x, s.multires) * gh)
        return pts_hat, dirs_hat, grads


def _check(name, t, n, device, width=3):
    if t.dtype != torch.float32 or not t.is_contiguous() or t.device != device \
            or tuple(t.shape) != (n, width):
        raise ValueError(f"point_pipeline: {name} must be a contiguous float32 tensor of "
                         f"shape ({n}, {width}) on {device}; got {t.dtype} {tuple(t.shape)} "
                         f"on {t.device}")


def _max_blocks(lib, dev, mode: str, entry: str) -> int:
    key = (dev, mode, entry)
    if key not in _MAX_BLOCKS:
        nb = ctypes.c_int(0)
        with torch.cuda.device(dev):
            rc = getattr(lib, f"point_pipeline_{entry}_max_blocks")(ctypes.byref(nb))
        _raise_on(lib, rc, "occupancy query")
        _MAX_BLOCKS[key] = nb.value
    return _MAX_BLOCKS[key]


def _raise_on(lib, rc, what):
    if rc != 0:
        raise RuntimeError(f"point_pipeline {what} failed: CUDA error {rc} "
                           f"({lib.point_pipeline_error_string(rc).decode()})")


def _net_args(pw: PipelineWeights):
    """The kernels' network arguments, after the per-call ones, the weight
    images (weight_images) and the offset tables the arguments point to
    (keep them alive through the call): (tables, images, net)."""
    d0, skip, n_sdf = _check_kernel_shape(pw.rcfg)
    rcfg = pw.rcfg
    kind_cn = rcfg.kind == "color_neus"
    images, ioff = weight_images(pw)
    tables = (np.ascontiguousarray(pw.off, np.int64), np.ascontiguousarray(ioff, np.int64))
    return tables, images, (n_sdf, skip, d0, float(rcfg.sdf.scale), len(pw.color),
                            _color_dv(rcfg), int(rcfg.color.squeeze_out), len(pw.relight),
                            _relight_dv(rcfg) if kind_cn else 0,
                            rcfg.relight.y_in_layer if kind_cn else -1,
                            int(rcfg.relight.inv_sigmoid), tables[0].ctypes.data,
                            tables[1].ctypes.data, N_OFF)


def dw_batch(n_tiles: int, grid: int) -> int:
    """Tiles whose weight grads a backward block sums on chip per flush:
    DW_BATCH, or fewer when a block has fewer tiles."""
    return max(1, min(DW_BATCH, -(-n_tiles // grid)))


def _shape_args(net):
    """(n_sdf, skip, n_color, n_relight, y_in) of the network arguments."""
    return net[0], net[1], net[4], net[7], net[9]


def _check_inputs(pw: PipelineWeights, pts, dirs):
    if pw.packed is None:
        raise ValueError("point_pipeline: weights were resolved on the CPU")
    n, dev = pts.shape[0], pts.device
    _check("pts", pts, n, dev)
    _check("dirs", dirs, n, dev)
    if pw.packed.device != dev:
        raise ValueError("point_pipeline: weights and points are on different devices")
    return n, dev


class ModeLaunches:
    """The launch count of one non-default MARCH_BWD_PRECISION mode's
    kernel (its library's instantiation): launchers() lists it beside its
    wrapper, whose own .launches counts the f32stash kernel's."""

    def __init__(self):
        self.launches = 0


def _mode(pw: PipelineWeights) -> str:
    return pw.rcfg.march_bwd_precision


def _counter(wrapper, pw: PipelineWeights):
    """The count of the kernel `wrapper` launches for pw's mode."""
    return wrapper if _mode(pw) == "f32stash" else wrapper.modes[_mode(pw)]


def mode_counters(wrapper) -> dict:
    """{mode: the launch count of its kernel} of a wrapper."""
    return {"f32stash": wrapper, **wrapper.modes}


def launch_point_pipeline(pw: PipelineWeights, pts, dirs) -> torch.Tensor:
    """Launch the forward kernel of pw's march_bwd_precision on the current
    stream; returns [N, 16]: sdf, grad, gc, relit, delta, 0, 0, 0."""
    n, dev = _check_inputs(pw, pts, dirs)
    lib = _library(_mode(pw))
    tables, images, net = _net_args(pw)
    out = torch.empty((n, 16), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    grid = min(-(-n // lib.point_pipeline_fwd_rows()), _max_blocks(lib, dev, _mode(pw), "fwd"))
    # per block: the gates of the n_sdf - 1 hidden layers and the features of a tile
    scratch = torch.empty(grid * lib.point_pipeline_fwd_scratch_floats(net[0]),
                          dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.point_pipeline_fwd_launch(
            pts.data_ptr(), dirs.data_ptr(), pw.packed.data_ptr(), images.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), n, grid, *net, stream)
    _raise_on(lib, rc, "kernel launch")
    _counter(launch_point_pipeline, pw).launches += 1
    return out


launch_point_pipeline.launches = 0
launch_point_pipeline.modes = {"bf16": ModeLaunches(), "f32": ModeLaunches()}


def reduce_partials(partial: torch.Tensor) -> torch.Tensor:
    """[blocks, n_grad] per-block weight-grad partials -> [n_grad], summed
    over the blocks in index order by the reduction kernel (deterministic:
    no atomics)."""
    lib = _library()
    nb, n_grad = partial.shape
    out = torch.empty(n_grad, dtype=torch.float32, device=partial.device)
    with torch.cuda.device(partial.device):
        stream = torch.cuda.current_stream(partial.device).cuda_stream
        rc = lib.point_pipeline_reduce_launch(partial.data_ptr(), out.data_ptr(), nb, n_grad,
                                              stream)
    _raise_on(lib, rc, "reduction launch")
    return out


def launch_point_pipeline_bwd(pw: PipelineWeights, pts, dirs, gbar):
    """Launch the backward kernel and the reduction on the current stream.
    gbar [N, 16]: the cotangents of sdf, grad, gc, relit, delta in the
    forward kernel's output lanes. Returns (pts_hat [N,3], dirs_hat [N,3],
    the weight grads [n_grad] in the packed layout: _unpack_grads). The
    kernel is pw's march_bwd_precision's."""
    n, dev = _check_inputs(pw, pts, dirs)
    _check("gbar", gbar, n, dev, 16)
    lib = _library(_mode(pw))
    pts_hat = torch.empty((n, 3), dtype=torch.float32, device=dev)
    dirs_hat = torch.empty((n, 3), dtype=torch.float32, device=dev)
    if n == 0:
        return pts_hat, dirs_hat, torch.zeros(pw.n_grad, dtype=torch.float32, device=dev)
    n_tiles = -(-n // 64)
    grid = min(n_tiles, _max_blocks(lib, dev, _mode(pw), "bwd"))
    batch = dw_batch(n_tiles, grid)
    tables, images, net = _net_args(pw)
    # per block: the recompute's gates, tangent stream and colour / relight
    # inputs, and the weight-grad operands of `batch` tiles; then a
    # weight-grad partial in the packed layout, summed afterwards
    per_block = lib.point_pipeline_bwd_scratch_floats(*_shape_args(net), batch)
    scratch = torch.empty(grid * per_block, dtype=torch.float32, device=dev)
    partial = torch.zeros((grid, pw.n_grad), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.point_pipeline_bwd_launch(
            pts.data_ptr(), dirs.data_ptr(), gbar.data_ptr(), pw.packed.data_ptr(),
            images.data_ptr(), pts_hat.data_ptr(), dirs_hat.data_ptr(),
            partial.data_ptr(), scratch.data_ptr(), n, grid, pw.n_grad, batch, *net, stream)
    _raise_on(lib, rc, "backward kernel launch")
    _counter(launch_point_pipeline_bwd, pw).launches += 1
    return pts_hat, dirs_hat, reduce_partials(partial)


launch_point_pipeline_bwd.launches = 0
launch_point_pipeline_bwd.modes = {"bf16": ModeLaunches(), "f32": ModeLaunches()}


def library_name(kernel: str, mode: str) -> str:
    """The library of `kernel`'s march_bwd_precision `mode` (build.VARIANTS)."""
    return kernel + SUFFIX[mode]


def _library(mode: str = "f32stash"):
    """The loaded library of a march_bwd_precision mode's kernels."""
    from color_neus_torch.ops.kernels import build
    lib = build.load(library_name(KERNEL, mode))
    if lib.point_pipeline_fwd_launch.argtypes is None:
        p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        net = [i, i, i, f, i, i, i, i, i, i, i, p, p, i]
        lib.point_pipeline_fwd_launch.argtypes = [p] * 6 + [ll, i] + net + [p]
        lib.point_pipeline_bwd_launch.argtypes = [p] * 9 + [ll, i, ll, i] + net + [p]
        lib.point_pipeline_reduce_launch.argtypes = [p, p, i, ll, p]
        for fn in (lib.point_pipeline_fwd_launch, lib.point_pipeline_bwd_launch,
                   lib.point_pipeline_reduce_launch, lib.point_pipeline_n_off,
                   lib.point_pipeline_fwd_rows):
            fn.restype = i
        for fn in (lib.point_pipeline_fwd_max_blocks, lib.point_pipeline_bwd_max_blocks):
            fn.argtypes = [ctypes.POINTER(i)]
            fn.restype = i
        lib.point_pipeline_bwd_scratch_floats.argtypes = [i] * 6
        lib.point_pipeline_bwd_scratch_floats.restype = ll
        lib.point_pipeline_fwd_scratch_floats.argtypes = [i]
        lib.point_pipeline_fwd_scratch_floats.restype = ll
        lib.point_pipeline_error_string.argtypes = [i]
        lib.point_pipeline_error_string.restype = ctypes.c_char_p
        lib.point_pipeline_prec.restype = i
        if lib.point_pipeline_n_off() != N_OFF:
            raise RuntimeError("point_pipeline: the kernel's offset table does not match")
        if lib.point_pipeline_prec() != MODES.index(mode):
            raise RuntimeError(f"point_pipeline: the {mode} library computes another mode")
    return lib


def fused_point_pipeline_fwd(params, rcfg: RendererConfig, pts, dirs, weights=None):
    """(sdf [N,1], grad [N,3], gc [N,3], relit [N,3], delta [N,3]): the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors. `weights`
    (resolve_pipeline_weights) may be passed to resolve once for many
    calls."""
    pw = weights if weights is not None else resolve_pipeline_weights(params, rcfg)
    pts, dirs = pts.contiguous(), dirs.contiguous()
    if pts.is_cuda:
        out = launch_point_pipeline(pw, pts, dirs)
        return out[:, 0:1], out[:, 1:4], out[:, 4:7], out[:, 7:10], out[:, 10:13]
    return point_pipeline_plain(pw, pts, dirs)


def fused_point_pipeline_bwd(pw: PipelineWeights, pts, dirs, cotangents):
    """The VJP of the five outputs (cotangents of sdf, grad, gc, relit,
    delta): (pts_hat [N,3], dirs_hat [N,3], {"sdf" / "color" / "relight":
    [(dW, db) per layer]}), the backward kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if pts.is_cuda:
        zeros = torch.zeros((pts.shape[0], 3), device=pts.device)
        gbar = torch.cat(list(cotangents) + [zeros], dim=1).contiguous()
        pts_hat, dirs_hat, packed = launch_point_pipeline_bwd(pw, pts, dirs, gbar)
        return pts_hat, dirs_hat, _unpack_grads(pw, packed)
    return point_pipeline_bwd_plain(pw, pts, dirs, list(cotangents))


class PointPipelineFunction(torch.autograd.Function):
    """The pipeline with its hand-written VJP (JAX _pipeline_core).
    apply(rcfg, pts, dirs, *flat) with flat the resolved (w, b) of every
    layer, sdf then colour then relight. Forward: row 5's kernel (CUDA) or
    point_pipeline_plain (CPU); it saves only its inputs, the backward
    recomputes. Backward: row 6's kernel (CUDA) or point_pipeline_bwd_plain
    (CPU), the device alone deciding."""

    @staticmethod
    def forward(ctx, rcfg, pts, dirs, *flat):
        pw = _make_weights(rcfg, _split_layers(rcfg, flat))
        pts, dirs = pts.detach().contiguous(), dirs.detach().contiguous()
        ctx.pw, ctx.pts, ctx.dirs = pw, pts, dirs
        if pts.is_cuda:
            out = launch_point_pipeline(pw, pts, dirs)
            return tuple(out[:, a:b].contiguous()
                         for a, b in ((0, 1), (1, 4), (4, 7), (7, 10), (10, 13)))
        sdf, grad, gc, relit, delta = point_pipeline_plain(pw, pts, dirs)
        return sdf, grad, gc, relit.clone() if relit is gc else relit, delta

    @staticmethod
    @once_differentiable
    def backward(ctx, *cots):
        # autograd passes zeros for outputs the loss does not reach
        pts_hat, dirs_hat, grads = fused_point_pipeline_bwd(ctx.pw, ctx.pts, ctx.dirs, cots)
        flat = [t for net in _layer_counts(ctx.pw.rcfg) for wb in grads[net] for t in wb]
        return (None, pts_hat, dirs_hat, *flat)


def _layer_counts(rcfg: RendererConfig) -> dict:
    return {net: len(names) for net, names in _layer_names(rcfg).items()}


def _split_layers(rcfg: RendererConfig, flat) -> dict:
    """The flat (w, b, w, b, ...) of every layer, sdf then colour then
    relight, as {net: [(w, b) per layer]}."""
    layers, i = {}, 0
    for net, k in _layer_counts(rcfg).items():
        layers[net] = [(flat[i + 2 * j], flat[i + 2 * j + 1]) for j in range(k)]
        i += 2 * k
    return layers


def fused_point_pipeline(params, rcfg: RendererConfig, pts, dirs):
    """Differentiable pipeline (JAX fused_point_pipeline): the outputs of
    fused_point_pipeline_fwd, with gradients to the params' leaves (through
    the weight norm resolved here) and to pts and dirs (including the PE
    second derivative the eikonal and colour paths reach)."""
    flat = [t for net, names in _layer_names(rcfg).items() for n in names
            for t in resolve_linear(params[net][n])]
    return PointPipelineFunction.apply(rcfg, pts, dirs, *flat)
