"""Interleaved A/B of two bench-step arms in one process: the port of
tools/bench_ab.py.

The card's clock and power state drift between processes by more than
the few percent a lever is worth, so both arms are built once (each its
own state, weights and captured bundle), then timed A, B, A, B, ... after
one untimed call each, and the tool reports each arm's median rays/s and
the paired per-round ratio B / A (the drift-immune statistic) with its
interquartile range.

    AB_KEY=march_acts AB_A=save AB_B=recompute python -m color_neus_torch.tools.bench_ab
    AB_KEY=bwd_prec AB_A=f32stash AB_B=bf16 python -m color_neus_torch.tools.bench_ab
    ... --device cpu                                  # the plain twins on the host

AB_KEY is a build_bench keyword: sweep_act | bwd_prec | march_acts |
ray_chunk | fused_march | fused_core (JAX's march_tile and thin_dots are
TPU keys the port does not read). AB_ROUNDS (default 8) alternation
rounds, BENCH_N_RAYS (2048) and BENCH_K_STEPS (40) the shape and the
steps a call. Prints one JSON line with JAX's keys and the card's name
and power limit.
"""

from __future__ import annotations

import os
import time

import numpy as np

from color_neus_torch.tools import parse_device, print_report
from color_neus_torch.tools.bench_step import build_bench, call

KEYS = ("sweep_act", "bwd_prec", "march_acts", "ray_chunk", "fused_march", "fused_core")


def _cast(v: str):
    return int(v) if v.lstrip("-").isdigit() else v


def run(key: str, a_val: str, b_val: str, rounds: int, n_rays: int, k_steps: int,
        device) -> dict:
    """JAX's report of the interleaved A/B (tools/bench_ab.py:39-78)."""
    if key not in KEYS:
        raise ValueError(f"AB_KEY={key!r} not in {KEYS}")
    arms = {}
    for name, val in (("A", a_val), ("B", b_val)):
        step_fn, args, _flops = build_bench(n_rays, k_steps, device=device,
                                            **{key: _cast(val)})
        call(step_fn, args)          # the warm-up bundle and the capture
        arms[name] = (step_fn, args)

    def _one(name):
        t0 = time.perf_counter()
        call(*arms[name])
        return time.perf_counter() - t0

    _one("A"), _one("B")  # one warm round each, untimed
    ta, tb = [], []
    for _ in range(rounds):
        ta.append(_one("A"))
        tb.append(_one("B"))
    ra = n_rays * k_steps / np.asarray(ta)
    rb = n_rays * k_steps / np.asarray(tb)
    ratio = rb / ra  # paired: each B against the A of its round
    return {
        "key": key, "A": a_val, "B": b_val, "rounds": rounds,
        "n_rays": n_rays, "k_steps": k_steps,
        "A_rays_per_s_median": round(float(np.median(ra)), 1),
        "B_rays_per_s_median": round(float(np.median(rb)), 1),
        "B_over_A_median": round(float(np.median(ratio)), 4),
        "B_over_A_iqr": [round(float(np.percentile(ratio, 25)), 4),
                         round(float(np.percentile(ratio, 75)), 4)],
        "A_ms_per_step": [t * 1e3 / k_steps for t in ta],
        "B_ms_per_step": [t * 1e3 / k_steps for t in tb],
    }


def main(argv=None) -> dict:
    device = parse_device(argv, "interleaved A/B of two bench-step arms")
    return print_report(run(os.environ.get("AB_KEY", "sweep_act"),
                            os.environ.get("AB_A", "softplus"), os.environ.get("AB_B", "relu"),
                            int(os.environ.get("AB_ROUNDS", 8)),
                            int(os.environ.get("BENCH_N_RAYS", 2048)),
                            int(os.environ.get("BENCH_K_STEPS", 40)), device), device)


if __name__ == "__main__":
    main()
