"""The readings that a cell's limits are set from (benchmark.compare's
numbers), on the chip at the cell's own size, in one process:

    python3 -m benchmark.calibrate --workload <name> --seeds 1,2,3 \
        [--modes program,control,half_batch,unchanged] [--out FILE]

For each seed, the cell's inputs as a run makes them, then:
  program     the program's set-up calls (the warm-up bundle and the
              first replay), as a run records them, against the reference
              (the lower reading);
  control     the reference in the precision below the configuration's
              (fp8 e4m3 products with a scale per operand) in the
              program's place (the upper reading);
  half_batch, unchanged, unchanged_in_graph, half_mesh, altered
              the program with that fault planted (benchmark/faults.py).
One JSON line a seed and mode: {"seed", "mode", numbers...}. The
benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time

import numpy as np
import torch

from benchmark import compare, faults, scene as S, spec
from benchmark.drivers import train as D
from benchmark.reference import nets


def readings(cell, seed: int, modes, device) -> list:
    if cell.traffic["kind"] == "extract":
        return extract_readings(cell, seed, modes, device)
    return train_readings(cell, seed, modes, device)


def extract_readings(cell, seed: int, modes, device) -> list:
    """The extraction's numbers; the control: vertex_sdf and coverage of
    the program's own bf16 grid (EXTRACT_PRECISION bf16, the precision
    below the configuration's f32), color_gap of the reference's colour
    net in fp8 at the program's vertices."""
    from benchmark.drivers import extract as X
    from benchmark.reference import extract as RX
    cfg, t = cell.config, cell.traffic
    r = cfg["MODEL"]["RENDERER"]
    res, thr = int(t["resolution"]), float(t.get("threshold", 0.0))
    bmin, bmax = (np.asarray(b, np.float32) for b in t["bbox"])
    leaves = X.make_leaves(cell, seed, device)
    out = []
    for mode in modes:
        t0 = time.perf_counter()
        plant = (faults.planted(mode) if mode not in ("program", "control")
                 else contextlib.nullcontext())
        over = {"EXTRACT_PRECISION": "bf16"} if mode == "control" else None
        with plant:
            verts, tris, colors, _ = X.Program(cfg, leaves, device, over).extract(
                res, bmin, bmax, thr)
        g = torch.Generator(device=device).manual_seed(S._seed63(seed, 5))
        nums = RX.judge(leaves, r, verts, tris, colors, bmin, bmax, res, thr,
                        int(t.get("lines", 4096)), g, device)
        if mode == "control" and len(verts):
            v = torch.as_tensor(verts, device=device)
            c8 = RX.colors_at(leaves, r, v, nets.fp8_quant)
            nums["color_gap"] = float((c8 - RX.colors_at(leaves, r, v)).abs().max())
        nums["repeat_mismatch"] = 0.0
        out.append({"seed": seed, "mode": mode, **nums, "n_verts": len(verts),
                    "s": time.perf_counter() - t0})
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def train_readings(cell, seed: int, modes, device) -> list:
    cfg = cell.config
    sizes, _, sc, leaves, start = D.inputs(cell, seed, device)
    n = 2 * D.bundle_k(cfg, sizes)
    ref = D.reference_steps(cfg, leaves, sc, sizes, start, seed, n)
    out = []
    for mode in modes:
        t0 = time.perf_counter()
        if mode == "control":
            got = D.reference_steps(cfg, leaves, sc, sizes, start, seed, n,
                                    quant=nets.fp8_quant)
        else:
            plant = faults.planted(mode) if mode != "program" else contextlib.nullcontext()
            with plant:
                prog = D.Program(cfg, sizes, sc, leaves, start, S.step_seed(seed), device)
                got = prog.setup_calls()
                prog.free()
                del prog
        nums = compare.training(got, ref, leaves, 0)
        out.append({"seed": seed, "mode": mode, **nums, "s": time.perf_counter() - t0})
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default=None,
                    help="default: program, control and the kind's faults")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    cell = spec.Cell(spec.load(), a.workload)
    modes = (a.modes.split(",") if a.modes else
             ["program", "control", *faults.FAULTS[cell.traffic["kind"]],
              *faults.CARD_FAULTS.get(cell.traffic["kind"], ())])
    sink = open(a.out, "a") if a.out else None
    for seed in (int(s) for s in a.seeds.split(",")):
        for row in readings(cell, seed, modes, torch.device("cuda")):
            line = json.dumps({"workload": a.workload, **row})
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
