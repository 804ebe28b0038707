"""The MLP-chain microbenchmark's kernels: counterpart of the two Pallas
kernels of tools/mlp_microbench.py (chain_kernel and chain_kernel_deferred).

chain: x [N, 256] f32, W [256, 256] f32 ([in, out]); L times
    x <- act(x @ W), one W for every layer, in one of nine activations;
    the products in bf16 (W rounded to bf16 once, each layer's input cast
    to bf16, exact products summed in f32) or in f32 (the kernel: JAX's f32
    dot, six bf16 passes; the plain version: PyTorch's f32 matmul); the
    activation in f32; out [N, 256] f32.
chain_deferred: the same chain in bf16 with the sp-only softplus, each
    layer's gate 1 - exp(-100 sp) rebuilt from the previous layer's kept
    f32 output one layer later and summed as acc += gate * gate_w;
    out = x + acc.

The gated variants keep their gate alive as sp + g * gate_w. The JAX tool
hard-codes gate_w = 1e-30, where the gate cannot be seen in the output;
gate_w is an argument here (default 1e-30) so that a check can run the
gates at 1.0.

Two implementations of each:
  * launch_chain / launch_chain_deferred: for CUDA tensors, the
    hand-written kernels of csrc/mlp_chain.cu (its note gives the bound
    and the design; all on wgmma, reading W from the image that
    pack_w_image, or pack_w3_image for f32, makes on the card once per
    call); each counts its launches in .launches (launch_chain's f32
    kernel in .f32.launches) and raises on a build or launch failure. For
    CPU tensors they return the plain version.
  * chain_plain / chain_deferred_plain: the same arithmetic in plain
    PyTorch, on any device; what tests and chip_smoke.py hold the kernels
    against.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace

import torch

KERNEL = "mlp_chain"
WIDTH = 256
GATE_W = 1e-30     # the JAX tool's gate weight


def act_none(x, gate_w=GATE_W):
    return x


def act_relu(x, gate_w=GATE_W):
    return torch.clamp_min(x, 0.0)


def _softplus(x):
    # fields.py softplus beta=100 form
    bx = x * 100.0
    return torch.where(bx > 30.0, x, torch.log1p(torch.exp(bx)) * 0.01)


def act_softplus(x, gate_w=GATE_W):
    return _softplus(x)


def act_sigmoid(x, gate_w=GATE_W):
    return torch.sigmoid(x)


def act_softplus_gate(x, gate_w=GATE_W):
    # softplus value and sigmoid gate: two independent transcendental chains
    return _softplus(x) + torch.sigmoid(x * 100.0) * gate_w


def _shared_sp(x):
    # shared-exp form (point_pipeline._softplus100_and_gate)
    e = torch.exp(-100.0 * torch.abs(x))
    return e, torch.clamp_min(x, 0.0) + torch.log1p(e) * 0.01


def _select_gate(x, r):
    return torch.where(x >= 0.0, r, 1.0 - r)


def act_shared_gate(x, gate_w=GATE_W):
    e, sp = _shared_sp(x)
    return sp + _select_gate(x, 1.0 / (1.0 + e)) * gate_w


def act_expm1_gate(x, gate_w=GATE_W):
    # the gate from the value: 1 - sigmoid(z) = exp(-softplus(z))
    _, sp = _shared_sp(x)
    return sp + (1.0 - torch.exp(-100.0 * sp)) * gate_w


def act_recip_approx_gate(x, gate_w=GATE_W):
    # the kernel takes the card's approximate reciprocal (rcp.approx, ~1 ulp
    # in f32 on Hopper; the TPU's ~2^-14); the plain version the exact one
    e, sp = _shared_sp(x)
    return sp + _select_gate(x, 1.0 / (1.0 + e)) * gate_w


def act_recip_newton_gate(x, gate_w=GATE_W):
    # approximate reciprocal + one Newton step
    e, sp = _shared_sp(x)
    d = 1.0 + e
    r = 1.0 / d
    r = r * (2.0 - d * r)
    return sp + _select_gate(x, r) * gate_w


def act_sp_only(x):
    # the deferred chain's activation: sp only, in the shared-exp form
    return _shared_sp(x)[1]


# the tool's nine variants in its order; the index is the kernel's ACT
ACTIVATIONS = (("none", act_none), ("relu", act_relu), ("softplus", act_softplus),
               ("sigmoid", act_sigmoid), ("sp+gate", act_softplus_gate),
               ("shared", act_shared_gate), ("expm1gate", act_expm1_gate),
               ("recip~", act_recip_approx_gate), ("recipNt", act_recip_newton_gate))
ACT_BY_NAME = dict(ACTIVATIONS)
GATED = ("sp+gate", "shared", "expm1gate", "recip~", "recipNt")
_ACT_ID = {fn: i for i, (_, fn) in enumerate(ACTIVATIONS)}


def act_id(act) -> int:
    """The kernel's index of an activation, given as its function or name."""
    fn = ACT_BY_NAME.get(act, act)
    if fn not in _ACT_ID:
        raise ValueError(f"mlp_chain: unknown activation {act!r}; one of "
                         f"{[n for n, _ in ACTIVATIONS]}")
    return _ACT_ID[fn]


def _bf16(t):
    return t.to(torch.bfloat16).float()


def chain_plain(x, w, L: int, act, bf16: bool = True, gate_w: float = GATE_W):
    """Plain PyTorch chain_kernel: L times x <- act(x @ W)."""
    fn = ACTIVATIONS[act_id(act)][1]
    with torch.no_grad():
        w = _bf16(w) if bf16 else w
        for _ in range(L):
            x = fn((_bf16(x) if bf16 else x) @ w, gate_w)
    return x


def chain_deferred_plain(x, w, L: int, gate_w: float = GATE_W):
    """Plain PyTorch chain_kernel_deferred (bf16 products)."""
    with torch.no_grad():
        w = _bf16(w)
        prev_sp, acc = None, 0.0
        for _ in range(L):
            x = _bf16(x) @ w
            if prev_sp is not None:
                acc = acc + (1.0 - torch.exp(-100.0 * prev_sp)) * gate_w
            x = act_sp_only(x)
            prev_sp = x
    return x + acc


def pack_w_image(w):
    """W [256, 256] f32 ([in, out]) as the byte image the bf16 kernels'
    wgmma B descriptors read, a plain permutation of bf16 W^T: four k
    blocks (k 64 b .. 64 b + 64), each 256 rows n of 128 bytes (the 64 k of
    that block), the 16-byte chunk c (k 8 c .. 8 c + 8) of row n stored at
    chunk c ^ (n % 8), the 128-byte swizzle (csrc/mlp_common.cuh,
    sw128_offset). Returns [4, 256, 8, 8] bf16, contiguous (128 KB), on
    w's device."""
    wt = w.t().to(torch.bfloat16).reshape(WIDTH, 4, 8, 8).permute(1, 0, 2, 3)   # b, n, c, e
    n = torch.arange(WIDTH, device=w.device)
    chunk = torch.arange(8, device=w.device)[None, :] ^ (n % 8)[:, None]          # [n, p] -> c
    return wt[:, n[:, None], chunk].contiguous()


def pack_w3_image(w):
    """W [256, 256] f32 ([in, out]) as the f32 kernel's three-part image,
    the slabs point_pipeline._pack_images makes for a six-pass product
    (split3's hi, mid and lo of a k16 step of W^T at 32-byte offsets of a
    128-byte row, 16 zero k, the 128-byte swizzle; 64 output columns x one
    k16 step a slab, 8 KB), ordered step after step, a step's four slabs
    of 64 columns together: the kernel's 16 KB slab of 128 columns is two
    of them (csrc/mlp_chain.cu, chain_f32_kernel). Returns [16 steps, 4,
    4096] bf16, contiguous (512 KB), on w's device."""
    from color_neus_torch.ops.kernels.point_pipeline import _hp_steps, _slabs
    slabs = _slabs(_hp_steps(w.t().float())).reshape(WIDTH // 64, WIDTH // 16, 64 * 64)
    return slabs.transpose(0, 1).contiguous()


def _check(x, w, L):
    if x.dim() != 2 or x.shape[1] != WIDTH or tuple(w.shape) != (WIDTH, WIDTH):
        raise ValueError(f"mlp_chain: x must be [N, {WIDTH}] and w [{WIDTH}, {WIDTH}]; got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    for name, t in (("x", x), ("w", w)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"mlp_chain: {name} must be contiguous float32; got {t.dtype}")
    if w.device != x.device:
        raise ValueError(f"mlp_chain: x on {x.device}, w on {w.device}")
    if x.data_ptr() % 16:
        raise ValueError("mlp_chain: x must be 16-byte aligned")
    if L < 1:
        raise ValueError(f"mlp_chain: L must be >= 1; got {L}")


def _stream(dev):
    with torch.cuda.device(dev):
        return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(lib, rc, what):
    if rc != 0:
        raise RuntimeError(f"mlp_chain {what} failed: CUDA error {rc} "
                           f"({lib.mlp_chain_error_string(rc).decode()})")


def launch_chain(x, w, L: int, act, bf16: bool = True, gate_w: float = GATE_W):
    """chain_kernel: the CUDA kernel for CUDA tensors (launched on the
    current stream), the plain version for CPU tensors; returns [N, 256]."""
    _check(x, w, L)
    a = act_id(act)
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"mlp_chain: no kernel for {x.device}")
        return chain_plain(x, w, L, act, bf16, gate_w)
    lib = _library()
    out = torch.empty_like(x)
    wimg = pack_w_image(w) if bf16 else pack_w3_image(w)
    rc = lib.mlp_chain_launch(x.data_ptr(), wimg.data_ptr(), out.data_ptr(), x.shape[0], L, a,
                              int(bool(bf16)), float(gate_w), _stream(x.device))
    _raise_on(lib, rc, "kernel launch")
    (launch_chain if bf16 else launch_chain.f32).launches += 1
    return out


launch_chain.launches = 0
# the f32 chain kernel's count: launchers() lists it as mlp_chain_f32
launch_chain.f32 = SimpleNamespace(launches=0)


def launch_chain_deferred(x, w, L: int, gate_w: float = GATE_W):
    """chain_kernel_deferred: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors; returns [N, 256]."""
    _check(x, w, L)
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"mlp_chain: no kernel for {x.device}")
        return chain_deferred_plain(x, w, L, gate_w)
    lib = _library()
    out = torch.empty_like(x)
    wimg = pack_w_image(w)
    rc = lib.mlp_chain_deferred_launch(x.data_ptr(), wimg.data_ptr(), out.data_ptr(), x.shape[0],
                                       L, float(gate_w), _stream(x.device))
    _raise_on(lib, rc, "deferred kernel launch")
    launch_chain_deferred.launches += 1
    return out


launch_chain_deferred.launches = 0


def blocks_per_sm(act, bf16: bool = True) -> int:
    """The blocks an SM holds of the chain kernel of `act` (None: the
    deferred chain); raises on a CUDA error."""
    lib = _library()
    n = lib.mlp_chain_blocks_per_sm(-1 if act is None else act_id(act), int(bool(bf16)))
    _raise_on(lib, max(0, -n), "occupancy query")
    return n


def wgmma_probe(a, b, c):
    """One m64n128k16 bf16 wgmma on the card, d = c + a b: a [64, 16] and
    b [128, 16] (B^T) bf16, c [64, 128] f32, CUDA tensors; returns d
    [64, 128] f32 (chip_smoke.py reads the tensor cores' rounding from it)."""
    lib = _library()
    a16, b16 = (t.to(torch.bfloat16).contiguous().view(torch.int16) for t in (a, b))
    c32 = c.float().contiguous()
    d = torch.empty_like(c32)
    _raise_on(lib, lib.mlp_wgmma_probe_launch(a16.data_ptr(), b16.data_ptr(), c32.data_ptr(),
                                              d.data_ptr(), _stream(c32.device)), "wgmma probe")
    return d


def ring_probe(img, copies: int, slabs: int, blocks: int) -> int:
    """Launches the f32 chain's ring alone (csrc/mlp_chain.cu
    ring_probe_kernel) on `blocks` blocks, each taking `slabs` slabs from
    its copy (block b: b % copies) of img, copies x 512 KB on the card;
    returns the bytes the launch moves into shared memory."""
    lib = _library()
    _raise_on(lib, lib.mlp_ring_probe_launch(img.data_ptr(), copies, slabs, blocks,
                                             _stream(img.device)), "ring probe")
    return blocks * slabs * lib.mlp_chain_f32_slab_bytes()


def _library():
    from color_neus_torch.ops.kernels import build
    lib = build.load(KERNEL)
    if lib.mlp_chain_launch.argtypes is None:
        p, i, u, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_longlong, \
            ctypes.c_float
        lib.mlp_chain_launch.argtypes = [p, p, p, ll, i, i, i, f, p]
        lib.mlp_chain_deferred_launch.argtypes = [p, p, p, ll, i, f, p]
        lib.mlp_chain_blocks_per_sm.argtypes = [i, i]
        lib.mlp_wgmma_probe_launch.argtypes = [p, p, p, p, p]
        lib.mlp_ring_probe_launch.argtypes = [p, i, u, i, p]
        lib.mlp_chain_f32_slab_bytes.argtypes = []
        for fn in (lib.mlp_chain_launch, lib.mlp_chain_deferred_launch,
                   lib.mlp_chain_blocks_per_sm, lib.mlp_wgmma_probe_launch,
                   lib.mlp_ring_probe_launch, lib.mlp_chain_f32_slab_bytes):
            fn.restype = i
        lib.mlp_chain_error_string.argtypes = [i]
        lib.mlp_chain_error_string.restype = ctypes.c_char_p
    return lib
