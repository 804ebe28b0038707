"""Kernel-level trace of the bench step: the port of tools/trace_profile.py.

Builds the bench step (tools/bench_step.py: PROF_N_RAYS rays, default
2048, x 512 samples, fused_march on, PROF_MARCH_ACTS save, TRACE_K_STEPS
steps a bundle, default 10), runs one call (the warm-up bundle and the
capture), then traces TRACE_BUNDLES replays of the captured bundle
(default 2) under torch.profiler, as the main path runs them, and reads
the trace's Chrome-format JSON (TRACE_DIR/trace.json) for:

  * total device ms per step (the kernels' summed durations);
  * the top kernels by device ms per step, with calls per step, grouped
    by kernel_name (the trace's demangled names less their parameters);
  * busy ms per step (the union of the kernel intervals), the span and
    the idle share (1 - busy / span);
  * the longest idle gaps between kernels, each with the innermost
    host-side event running at its start (a launch, a sync, an op).

    python -m color_neus_torch.tools.trace_profile            # on the card
    PARSE_ONLY=1 TRACE_DIR=... N_STEPS=20 python -m color_neus_torch.tools.trace_profile
    PROF_N_RAYS=8 python -m color_neus_torch.tools.trace_profile --device cpu

PARSE_ONLY re-reads a saved trace (N_STEPS: the steps it holds). On the
CPU there is no card: the top-level host ops stand in for the kernels.
TRACE_DIR defaults to bench_trace in the temporary directory. JAX's tool
traced PROF_MARCH_ACTS recompute by default; the port traces the bench
step's arm, save. Prints one JSON object with JAX's keys and these.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from collections import defaultdict

from color_neus_torch.tools import parse_device, print_report
from color_neus_torch.tools._timing import (
    DEVICE_CATS, device_events, kernel_name, read_trace, trace_events, union_us)
from color_neus_torch.tools.bench_step import build_bench, call


def run_and_trace(trace_dir: str, n_rays: int, march_acts: str, bundles: int, k_steps: int,
                  device) -> int:
    """Trace `bundles` calls of the bench step of k_steps steps (after one
    untimed call) to trace_dir/trace.json; returns the steps traced."""
    step_fn, args, _ = build_bench(n_rays, k_steps, march_acts=march_acts, device=device)
    call(step_fn, args)
    os.makedirs(trace_dir, exist_ok=True)
    trace_events(lambda: [call(step_fn, args) for _ in range(bundles)],
                 cuda=device.type == "cuda", path=os.path.join(trace_dir, "trace.json"))
    return bundles * k_steps


def op_name(name: str) -> str:
    """kernel_name of a mangled name; a demangled one less its parameter
    list; at most 110 characters."""
    if name.startswith("_Z"):
        return kernel_name(name)
    return re.sub(r"\([^()]*\)$", "", name)[:110]


def _outermost(events):
    """The events not inside another of the same thread (host ops)."""
    out, ends = [], {}
    for e in sorted(events, key=lambda e: (float(e["ts"]), -float(e["dur"]))):
        key = (e.get("pid"), e.get("tid"))
        s, t = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if s >= ends.get(key, -1.0):
            out.append((s, t, e.get("name", "")))
            ends[key] = t
    return out


def parse(events, n_steps: int, top: int = 40, n_gaps: int = 10) -> dict:
    """The report of a trace's complete events over n_steps steps."""
    dev = device_events(events)
    host = [e for e in events if e.get("cat") not in DEVICE_CATS and "dur" in e]
    if not dev:   # a host-only trace: its top-level ops stand in for the kernels
        dev = _outermost([e for e in host if e.get("cat") == "cpu_op"])
    if not dev:
        raise SystemExit("the trace holds no kernel and no host op")
    agg, count = defaultdict(float), defaultdict(int)
    for s, t, name in dev:
        agg[op_name(name)] += t - s
        count[op_name(name)] += 1
    busy = union_us([(s, t) for s, t, _ in dev])
    span = max(t for _, t, _ in dev) - min(s for s, _, _ in dev)
    gaps, end, last = [], None, ""
    for s, t, name in sorted(dev):
        if end is not None and s > end:
            gaps.append((s - end, end, last, name))
        if end is None or t > end:
            end, last = t, name
    out_gaps = []
    for gap, at, before, after in sorted(gaps, reverse=True)[:n_gaps]:
        running = [(float(e["dur"]), e.get("name", "")) for e in host
                   if float(e["ts"]) <= at < float(e["ts"]) + float(e["dur"])]
        out_gaps.append({"gap_ms": round(gap / 1e3, 4), "after": op_name(before),
                         "before": op_name(after),
                         "host_op": min(running)[1] if running else None})
    per_step = {k: v / n_steps / 1e3 for k, v in agg.items()}
    return {
        "total_device_ms_per_step": round(sum(agg.values()) / n_steps / 1e3, 4),
        "top_ops_ms_per_step": [
            {"name": k, "ms": round(v, 4), "calls": count[k] / n_steps,
             "hlo": next(n for _, _, n in dev if op_name(n) == k)[:160]}
            for k, v in sorted(per_step.items(), key=lambda kv: -kv[1])[:top]],
        "busy_ms_per_step": round(busy / n_steps / 1e3, 4),
        "span_ms_per_step": round(span / n_steps / 1e3, 4),
        "idle_share": round(1 - busy / span, 4) if span > 0 else 0.0,
        "idle_gaps": out_gaps,
        "n_steps": n_steps,
    }


def main(argv=None) -> dict:
    trace_dir = os.environ.get("TRACE_DIR", os.path.join(tempfile.gettempdir(), "bench_trace"))
    path = os.path.join(trace_dir, "trace.json")
    if os.environ.get("PARSE_ONLY"):
        rep = parse(read_trace(path), int(os.environ.get("N_STEPS", 20)))
        print(json.dumps(rep, indent=1), flush=True)
        return rep
    device = parse_device(argv, "kernel-level trace of the bench step")
    n = run_and_trace(trace_dir, int(os.environ.get("PROF_N_RAYS", 2048)),
                      os.environ.get("PROF_MARCH_ACTS", "save"),
                      int(os.environ.get("TRACE_BUNDLES", 2)),
                      int(os.environ.get("TRACE_K_STEPS", 10)), device)
    return print_report(parse(read_trace(path), n), device, indent=1)


if __name__ == "__main__":
    main()
