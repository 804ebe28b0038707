"""Microbenchmark: what does a softplus-beta100 (+ gate) epilogue cost next
to the 256-wide product it follows? The port of tools/mlp_microbench.py.

    python -m color_neus_torch.tools.mlp_microbench              # on the card
    python -c "from color_neus_torch.tools.mlp_microbench import run; \
run(16, 2, 2, 'softplus', 'softplus', device='cpu')"             # one tiny line

`--device cpu` makes the same sweep with the plain versions, at the same
1M-row shapes: minutes and several GB on the host.

Times the chain kernel of csrc/mlp_chain.cu (ops/kernels/mlp_chain.py): L
layers x <- act(x @ W) of [G*T, 256] x [256, 256] with bf16 products and
f32 accumulation, one activation variant per line:

    none      pure product chain (the practical tensor-core ceiling here)
    relu      a cheap FP32-pipe op
    softplus  the SDF activation (beta=100): exp + log1p per element
    sigmoid   the compositing / relight op
    sp+gate, shared, expm1gate, recip~, recipNt
              softplus value and gate in the forms of the TPU tool

then the deferred chain (each gate rebuilt from the kept output one layer
later), the tile-size pairs for none and softplus, and the f32-product
chain. Prints ms per call (CUDA events; the host clock with --device cpu)
and TFLOP/s (2 G T 256^2 L flops) per line.

On the TPU, T was the VMEM block. Here rows are independent and the
kernel tiles them with its own constant (64 rows; the bf16 chains give
each of a block's two warpgroups one such tile), so T and G only set the
row count G*T.
"""

from __future__ import annotations

import argparse
import time

import torch

from color_neus_torch import pin_precision, resolve_device
from color_neus_torch.ops.kernels import mlp_chain as MC

REPS = 20


def inputs(T: int, G: int, device):
    """x [G*T, 256] ~ N(0, 1) and w [256, 256] ~ 0.06 N(0, 1), from seeded
    generators on `device` (seeds 0 and 1)."""
    dev = torch.device(device)
    gx = torch.Generator(device=dev).manual_seed(0)
    gw = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((G * T, MC.WIDTH), generator=gx, device=dev)
    w = torch.randn((MC.WIDTH, MC.WIDTH), generator=gw, device=dev) * 0.06  # keep the chain finite
    return x, w


def _time_ms(fn, device) -> float:
    fn()   # the first call builds the kernel
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / REPS
    t0 = time.perf_counter()
    for _ in range(REPS):
        fn()
    return (time.perf_counter() - t0) * 1e3 / REPS


def _report(name, T, L, G, ms, device):
    fl = 2.0 * G * T * MC.WIDTH * MC.WIDTH * L
    clock = "" if device.type == "cuda" else "  (cpu, host clock)"
    print(f"{name:10s} T={T:5d} L={L} G={G}: {ms:7.2f} ms  {fl / ms / 1e9:6.1f} TFLOP/s{clock}",
          flush=True)


def run(T, L, G, act, name, bf16=True, device=None) -> float:
    """Times the chain of activation `act` (a function of
    ops/kernels/mlp_chain.py or its variant name); prints and returns ms."""
    dev = resolve_device(device)
    x, w = inputs(T, G, dev)
    ms = _time_ms(lambda: MC.launch_chain(x, w, L, act, bf16), dev)
    _report(name, T, L, G, ms, dev)
    return ms


def run_deferred(T, L, G, device=None) -> float:
    """Times the deferred chain; prints and returns ms."""
    dev = resolve_device(device)
    x, w = inputs(T, G, dev)
    ms = _time_ms(lambda: MC.launch_chain_deferred(x, w, L), dev)
    _report("deferred", T, L, G, ms, dev)
    return ms


def main(argv=None):
    """The tool's sweep; returns its lines as (name, T, L, G, ms)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    arg = p.parse_args(argv)
    pin_precision()
    dev = resolve_device(arg.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print("device:", dev.type, name, flush=True)
    lines = []

    def record(name, T, G, act=None, bf16=True):
        ms = run_deferred(T, 25, G, device=dev) if act is None else \
            run(T, 25, G, act, name, bf16, device=dev)
        lines.append((name, T, 25, G, ms))

    # bench-step-like totals: 1M rows, 25-layer chain
    for act_name, act in MC.ACTIVATIONS:
        record(act_name, 1024, 1024, act)
    record("deferred", 1024, 1024)
    # tile-size sweep on the pure chain
    for T, G in ((512, 2048), (2048, 512), (4096, 256)):
        record("none", T, G, MC.act_none)
        record("softplus", T, G, MC.act_softplus)
    # f32 product reference
    record("none-f32", 1024, 1024, MC.act_none, bf16=False)
    return lines


if __name__ == "__main__":
    main()
