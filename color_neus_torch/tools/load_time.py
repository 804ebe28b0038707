"""The march's save-mode pair (row 3's save entry, row 4's load entry)
timed on the card beside the recompute pair: in each MARCH_BWD_PRECISION
mode (LT_MODES, default f32stash,bf16,f32) and at each shape (LT_SHAPES,
default 1024x128,1024x512: rays x samples), Color-NeuS at full width on
its geometric init (march_ablate.inputs: JAX's ablation rays, inv_s 64,
cotangents N(0, 0.01)), CUDA events over LT_REPS back-to-back calls
(default 5, after one): row 3's save entry and recompute entry, row 4's
load entry on the save entry's stashes and row 4's recompute entry, the
wrappers' allocations and the partials' reduction included as in
training. Also, per mode and shape: the load entry's largest difference
from the recompute entry on each output (rays_o, rays_d, inv_s, the
weight grads; relative to the output's largest magnitude: the same
function, apart from rounding), the save entry's out against the
recompute entry's, and whether two identical save calls (out and both
stashes) and two identical load calls are bitwise equal.

    python -m color_neus_torch.tools.load_time     # on the card only

Prints one JSON object (and the card's name and power limit). Only the
port's wrappers and march_ablate.inputs are called, so this file and
march_ablate.py copied into an earlier checkout of the port time that
checkout's kernels, for a before / after in one call.
"""

from __future__ import annotations

import os

import torch

from color_neus_torch import pin_precision
from color_neus_torch.ops.kernels import point_pipeline as PP
from color_neus_torch.ops.kernels import ray_march as RM
from color_neus_torch.tools import march_ablate as MA
from color_neus_torch.tools import parse_device, print_report
from color_neus_torch.tools._timing import cuda_ms


def _flat(out) -> list:
    """(name, tensor) of a backward's outputs."""
    return [("rays_o", out[0]), ("rays_d", out[1]), ("inv_s", out[2]), ("weights", out[3])]


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def run(modes, shapes, reps: int, device) -> dict:
    if device.type != "cuda":
        raise RuntimeError("load_time times the CUDA kernels: it needs a card")
    pin_precision()
    res = {"reps": reps}
    for mode in modes:
        for n_rays, n_samples in shapes:
            pw, ro, rd, z, inv_s, gbar = MA.inputs(n_rays, device, mode=mode,
                                                   n_samples=n_samples)
            sd = 2.0 / pw.rcfg.n_samples
            out_s, stash, act = RM.launch_ray_march_save(pw, ro, rd, z, inv_s, sd)
            out_r, stash_r = RM.launch_ray_march(pw, ro, rd, z, inv_s, sd)
            again = RM.launch_ray_march_save(pw, ro, rd, z, inv_s, sd)
            save_same = all(torch.equal(x, y) for x, y in zip((out_s, stash, act), again))
            del again

            def load():
                return RM.launch_ray_march_bwd_load(pw, ro, rd, z, inv_s, sd, stash, act, gbar)

            def recompute():
                return RM.launch_ray_march_bwd(pw, ro, rd, z, inv_s, sd, stash_r, gbar)

            a, b, ref = load(), load(), recompute()
            torch.cuda.synchronize()
            rec = {
                "save_ms": cuda_ms(lambda: RM.launch_ray_march_save(pw, ro, rd, z, inv_s, sd),
                                   reps=reps, warmup=1),
                "fwd_ms": cuda_ms(lambda: RM.launch_ray_march(pw, ro, rd, z, inv_s, sd),
                                  reps=reps, warmup=1),
                "load_ms": cuda_ms(load, reps=reps, warmup=1),
                "recompute_ms": cuda_ms(recompute, reps=reps, warmup=1),
                "load_vs_recompute": {k: _rel(x, y) for (k, x), (_, y)
                                      in zip(_flat(a), _flat(ref))},
                "save_vs_recompute_out": _rel(out_s, out_r),
                "save_bitwise_repeatable": save_same,
                "load_bitwise_repeatable": all(torch.equal(x, y) for (_, x), (_, y)
                                               in zip(_flat(a), _flat(b))),
                "finite": all(bool(torch.isfinite(x).all()) for _, x in _flat(a))
                and bool(torch.isfinite(out_s).all()),
                "stash_bytes_per_point": act.numel() // (n_rays * n_samples) + RM.STASH * 4,
            }
            res[f"{mode} {n_rays}x{n_samples}"] = rec
            del out_s, out_r, stash, act, stash_r, a, b, ref
            torch.cuda.empty_cache()
    return res


def main(argv=None) -> dict:
    device = parse_device(argv, "the march's save and load entries timed beside the recompute pair")
    modes = os.environ.get("LT_MODES", ",".join(PP.MODES)).split(",")
    shapes = [tuple(int(v) for v in s.split("x"))
              for s in os.environ.get("LT_SHAPES", "1024x128,1024x512").split(",")]
    return print_report(run(modes, shapes, int(os.environ.get("LT_REPS", 5)), device), device,
                        indent=1)


if __name__ == "__main__":
    main()
