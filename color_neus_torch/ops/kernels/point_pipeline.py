"""The per-point pipeline forward: counterpart of
color_neus_tpu/ops/pallas/point_pipeline.py (fused_point_pipeline_fwd).

fused_point_pipeline_fwd(params, rcfg, pts [N,3], dirs [N,3]) returns
(sdf [N,1], grad [N,3], gc [N,3], relit [N,3], delta [N,3]): the SDF, its
spatial gradient (reverse mode), the global colour, the relit colour and
the relight residual (NeuS: relit = gc, delta = 0). Forward only: no
gradient flows through it (the backward kernel is a later slice).

Two implementations of one function:
  * launch_point_pipeline: the hand-written CUDA kernel
    csrc/point_pipeline.cu (its source note gives the bound and the
    design). Runs for CUDA tensors, counts its launches in
    launch_point_pipeline.launches, raises on any build or launch failure.
  * point_pipeline_plain: the same arithmetic in plain PyTorch: the
    forward keeps the softplus gates g = 1 - exp(-100 softplus(a)), one
    reverse sweep takes the gradient, then the colour and relight nets.
    Runs for CPU tensors, and is what tests and chip_smoke.py compare the
    kernel against.
fused_point_pipeline_fwd picks between them by the device of the
tensors it is given, and by nothing else.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch

from color_neus_torch.models.configs import RendererConfig
from color_neus_torch.models.fields import resolve_linear
from color_neus_torch.ops.embedding import embedding_dim, positional_encoding
from color_neus_torch.ops.transforms import inverse_sigmoid

KERNEL = "point_pipeline"
HID = 256     # the kernel's hidden width
EMB = 48      # the kernel's padded PE / small-input width
MAXL = 16     # the kernel's most layers per network
_INV_SQRT2 = 1.0 / math.sqrt(2.0)
# slots of the kernel's offset table (csrc/point_pipeline.cu)
W_SDF, WT_SDF, B_SDF, W_COL, B_COL, W_REL, B_REL = (i * MAXL for i in range(7))
W_LAST, B_LAST, W_FEAT, B_FEAT = 7 * MAXL, 7 * MAXL + 1, 7 * MAXL + 2, 7 * MAXL + 3
N_OFF = 7 * MAXL + 4
_MAX_BLOCKS: dict = {}   # device -> blocks resident at once (sizes the scratch)


@dataclass
class PipelineWeights:
    """Weight-norm-resolved weights of the three nets, (w [out, in], b [out])
    per layer in the networks' own widths; packed / off: the kernel's f32
    buffer and its offset table (None for CPU weights)."""
    rcfg: RendererConfig
    sdf: list
    color: list
    relight: list
    packed: torch.Tensor | None = None
    off: np.ndarray | None = None


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


def _pack(pw: PipelineWeights):
    """The kernel's f32 buffer and offset table (see csrc/point_pipeline.cu):
    SDF hidden layers as [K, 256] ([in, out]; K = 48 for the PE layer,
    256 + 48 for the skip layer's [h, emb], else 256) and transposed as
    [256, K padded to 32]; the last SDF layer as its sdf row [256] and the
    features [256, 256]; colour layer 0 as [features 256 | pts, grad,
    PE(dirs)] x 256; relight layer 0 as [pts, grad, PE(dirs)] x 256 and the
    y_in layer as [h 256 | gc] x out; hidden layers [256, 256]; the last
    colour / relight layer row-major [3, K]. Zero padding keeps the math
    exact: padded inputs meet zero weight rows."""
    rcfg = pw.rcfg
    d0, skip, n_sdf = _check_kernel_shape(rcfg)
    dev = pw.sdf[0][0].device
    blocks, off, pos = [], np.zeros(N_OFF, np.int64), [0]

    def put(slot, t):
        off[slot] = pos[0]
        t = t.reshape(-1).float()
        blocks.append(t)
        pos[0] += t.numel()

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
        K = wp.shape[0]
        kp = (K + 31) // 32 * 32
        wtp = z(HID, kp)
        wtp[:, :K] = wp.T
        put(W_SDF + l, wp)
        put(WT_SDF + l, wtp)
        put(B_SDF + l, bias(b))
    w, b = pw.sdf[-1]
    put(W_LAST, w[0])
    put(B_LAST, b[:1])
    put(W_FEAT, w[1:].T)
    put(B_FEAT, b[1:])

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
    return torch.cat(blocks).contiguous(), off


def resolve_pipeline_weights(params, rcfg: RendererConfig) -> PipelineWeights:
    """Resolve weight norm once (no grad: forward only) and, for CUDA
    weights, pack the kernel's buffer."""
    with torch.no_grad():
        def net(p, names):
            return [tuple(t.detach().float() for t in resolve_linear(p[n])) for n in names]
        sdf = net(params["sdf"], [f"lin{l}" for l in range(rcfg.sdf.n_layers + 1)])
        color = net(params["color"], [f"lin{l}" for l in range(rcfg.color.n_layers + 1)])
        relight = []
        if rcfg.kind == "color_neus":
            relight = net(params["relight"], ["in_layer"] + [
                f"mlp{i}" for i in range(rcfg.relight.n_layers)])
        pw = PipelineWeights(rcfg, sdf, color, relight)
        if sdf[0][0].is_cuda:
            pw.packed, pw.off = _pack(pw)
    return pw


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


def point_pipeline_plain(pw: PipelineWeights, pts: torch.Tensor, dirs: torch.Tensor):
    """Plain PyTorch pipeline forward, the kernel's arithmetic op for op
    (summed in another order)."""
    rcfg = pw.rcfg
    s = rcfg.sdf
    with torch.no_grad():
        n = pts.shape[0]
        x = pts * s.scale
        emb = positional_encoding(x, s.multires)
        d0 = emb.shape[1]
        h, gates = emb, []
        for l, (w, b) in enumerate(pw.sdf[:-1]):
            if l in s.skip_in:
                h = torch.cat([h, emb], dim=-1) * _INV_SQRT2
            h, g = _softplus100_and_gate(h @ w.T + b)
            gates.append(g)
        w_last, b_last = pw.sdf[-1]
        if len(pw.sdf) - 1 in s.skip_in:
            h = torch.cat([h, emb], dim=-1) * _INV_SQRT2
        y = h @ w_last.T + b_last
        sdf = y[:, :1] * (1.0 / s.scale)
        feat = y[:, 1:]

        # reverse sweep: p = d raw / d (layer input); the last layer's is its row 0
        emb_g = torch.zeros((n, d0), dtype=pts.dtype, device=pts.device)
        p = w_last[0].expand(n, -1)
        for l in range(len(pw.sdf) - 1, -1, -1):
            if l < len(pw.sdf) - 1:
                p = (p * gates[l]) @ pw.sdf[l][0]
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
        for l, (w, b) in enumerate(pw.color):
            h = h @ w.T + b
            if l < len(pw.color) - 1:
                h = torch.relu(h)
        gc = torch.sigmoid(h) if c.squeeze_out else h

        if rcfg.kind != "color_neus":
            return sdf, grad, gc, gc, torch.zeros_like(gc)
        r = rcfg.relight
        feats = [pts, positional_encoding(dirs, r.multires_view)]
        if r.include_grad:
            feats.append(grad)
        w, b = pw.relight[0]
        h = torch.cat(feats, dim=-1) @ w.T + b
        for i, (w, b) in enumerate(pw.relight[1:]):
            h = torch.relu(h)
            if i == r.y_in_layer - 1:
                h = torch.cat([gc, h], dim=-1)
            h = h @ w.T + b
        delta = h
        if r.inv_sigmoid:
            relit = torch.sigmoid(inverse_sigmoid(gc) + delta)
        else:
            relit = torch.clamp(gc + torch.sigmoid(delta) - 0.5, 0.0, 1.0)
        return sdf, grad, gc, relit, delta


def _check(name, t, n, device):
    if t.dtype != torch.float32 or not t.is_contiguous() or t.device != device \
            or tuple(t.shape) != (n, 3):
        raise ValueError(f"point_pipeline: {name} must be a contiguous float32 tensor of "
                         f"shape ({n}, 3) on {device}; got {t.dtype} {tuple(t.shape)} "
                         f"on {t.device}")


def launch_point_pipeline(pw: PipelineWeights, pts, dirs) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; returns [N, 16]:
    sdf, grad, gc, relit, delta, 0, 0, 0."""
    if pw.packed is None:
        raise ValueError("point_pipeline: weights were resolved on the CPU")
    n = pts.shape[0]
    dev = pts.device
    _check("pts", pts, n, dev)
    _check("dirs", dirs, n, dev)
    if pw.packed.device != dev:
        raise ValueError("point_pipeline: weights and points are on different devices")
    d0, skip, n_sdf = _check_kernel_shape(pw.rcfg)
    lib = _library()
    out = torch.empty((n, 16), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    blocks = _MAX_BLOCKS.get(dev)
    if blocks is None:
        nb = ctypes.c_int(0)
        with torch.cuda.device(dev):
            rc = lib.point_pipeline_max_blocks(ctypes.byref(nb))
        if rc != 0:
            raise RuntimeError(f"point_pipeline: occupancy query failed: CUDA error {rc} "
                               f"({lib.point_pipeline_error_string(rc).decode()})")
        blocks = _MAX_BLOCKS[dev] = nb.value
    grid = min(-(-n // 64), blocks)
    # per block: the gates of the n_sdf - 1 hidden layers and the features
    scratch = torch.empty(grid * n_sdf * 64 * HID, dtype=torch.float32, device=dev)
    rcfg = pw.rcfg
    kind_cn = rcfg.kind == "color_neus"
    off = np.ascontiguousarray(pw.off, np.int64)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.point_pipeline_fwd_launch(
            pts.data_ptr(), dirs.data_ptr(), pw.packed.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), n, grid, n_sdf, skip, d0, float(rcfg.sdf.scale),
            len(pw.color), _color_dv(rcfg), int(rcfg.color.squeeze_out),
            len(pw.relight), _relight_dv(rcfg) if kind_cn else 0,
            rcfg.relight.y_in_layer if kind_cn else -1,
            int(rcfg.relight.inv_sigmoid), off.ctypes.data, N_OFF, stream)
    if rc != 0:
        raise RuntimeError(f"point_pipeline kernel launch failed: CUDA error {rc} "
                           f"({lib.point_pipeline_error_string(rc).decode()})")
    launch_point_pipeline.launches += 1
    return out


launch_point_pipeline.launches = 0


def _library():
    from color_neus_torch.ops.kernels import build
    lib = build.load(KERNEL)
    if lib.point_pipeline_fwd_launch.argtypes is None:
        p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        lib.point_pipeline_fwd_launch.argtypes = [p, p, p, p, p, ll, i, i, i, i, f, i, i, i,
                                                  i, i, i, i, p, i, p]
        lib.point_pipeline_fwd_launch.restype = i
        lib.point_pipeline_max_blocks.argtypes = [ctypes.POINTER(i)]
        lib.point_pipeline_max_blocks.restype = i
        lib.point_pipeline_n_off.restype = i
        lib.point_pipeline_error_string.argtypes = [i]
        lib.point_pipeline_error_string.restype = ctypes.c_char_p
        if lib.point_pipeline_n_off() != N_OFF:
            raise RuntimeError("point_pipeline: the kernel's offset table does not match")
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
