"""Where the grid evaluation's time goes: the port of tools/extract_probe.py.

For the mesh extraction's SDF grid at EP_RES^3 (default 256; Color-NeuS
on its geometric init, the bbox [-1.01, 1.01]^3), per EXTRACT_PRECISION
arm of row 2 (f32 | f32x3 | bf16) and per chunk size of a ladder (2^16,
2^18 (ops/mesh.CHUNK), 2^20 points a kernel call):

  * device_only_s: every chunk's points gathered and its kernel launched
    back to back, the outputs kept on the device, one synchronize at the
    end (the kernels and their launches);
  * full_s: evaluate_sdf_grid at that chunk size (each chunk's copy to
    the host and the numpy assembly too);
  * fetch_share_s: full_s - device_only_s, the host's share;
  * dispatches: the kernel calls a grid takes.

Each the fastest of EP_REPS runs (default 2), host clock.

    python -m color_neus_torch.tools.extract_probe             # on the card
    EP_RES=512 python -m color_neus_torch.tools.extract_probe
    EP_RES=16 python -m color_neus_torch.tools.extract_probe --device cpu

Prints one JSON line with JAX's keys (the arms named <prec>_c<chunk>
where JAX's were <prec>_t<tile>) and the card's name and power limit.
"""

from __future__ import annotations

import os
import sys
import time

import torch

from color_neus_torch import pin_precision
from color_neus_torch.ops import mesh as M
from color_neus_torch.ops.kernels.sdf_mlp import make_fused_sdf_fn
from color_neus_torch.tools import parse_device, platform_name, print_report
from color_neus_torch.tools.mesh_extraction_timing import BMAX, BMIN, geometric_renderer

PRECISIONS = ("f32", "f32x3", "bf16")
CHUNKS = (1 << 16, M.CHUNK, 1 << 20)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def run(res: int, reps: int, device, chunks=CHUNKS) -> dict:
    pin_precision()
    params, rcfg = geometric_renderer(device)
    n = res ** 3
    axes = M._axes(BMIN, BMAX, res, device)
    rep = {"what": "grid-eval time split: device kernels vs the copies to the host",
           "platform": platform_name(device), "res": res, "arms": {}}
    for prec in PRECISIONS:
        base = make_fused_sdf_fn(params["sdf"], rcfg.sdf, prec=prec)

        def fn(p):
            return -base(p)

        for chunk in chunks:
            dev, full = [], []
            with torch.no_grad():
                for _ in range(reps):
                    _sync(device)
                    t0 = time.perf_counter()
                    outs = [fn(M._lattice_points(axes, res, s, min(s + chunk, n)))
                            for s in range(0, n, chunk)]
                    _sync(device)
                    dev.append(time.perf_counter() - t0)
                    del outs
            for _ in range(reps):
                t0 = time.perf_counter()
                M.evaluate_sdf_grid(params, rcfg, BMIN, BMAX, res, sdf_chunk_fn=fn, chunk=chunk)
                full.append(time.perf_counter() - t0)
            d, f = min(dev), min(full)
            rep["arms"][f"{prec}_c{chunk}"] = {
                "device_only_s": round(d, 4), "full_s": round(f, 4),
                "fetch_share_s": round(f - d, 4), "dispatches": -(-n // chunk)}
            print(f"# {prec} chunk={chunk}: device {d:.3f}s full {f:.3f}s", file=sys.stderr,
                  flush=True)
    return rep


def main(argv=None) -> dict:
    device = parse_device(argv, "grid-evaluation time split")
    return print_report(run(int(os.environ.get("EP_RES", 256)),
                            int(os.environ.get("EP_REPS", 2)), device), device)


if __name__ == "__main__":
    main()
