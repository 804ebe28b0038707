"""Timing and tracing helpers shared by chip_smoke.py and the port's tools.

card_line reads the card's name and power limit from nvidia-smi;
kernel_name shortens a mangled kernel name to its `..._kernel`
identifier; cuda_ms times a callable with CUDA events over back-to-back
calls, median_ms call by call (the host clock on the CPU); trace_events /
profiled run a callable under torch.profiler and return its trace's
events; union_us is the busy time of a set of intervals; profile_steps
prints a few training steps' time by kernel, busy time and idle share.
torch is imported inside the functions.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import tempfile
import time

# the trace's categories of work on the card
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` of
    the first card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def kernel_name(mangled: str) -> str:
    """The `..._kernel` identifier inside a mangled name (or
    `..._kernel_bf16s` / `_f32s`: a MARCH_BWD_PRECISION mode's, SUFFIX in
    ops/kernels/point_pipeline.py): the shortest one whose length prefix
    (a suffix of some digit run) matches it. The
    shortest: the unnamed namespace's name carries a hash of the source's
    path, whose digits can prefix a longer run that also ends in
    `_kernel` (`..._cu_bc59753821chain_deferred_kernel`)."""
    found = []
    for m in re.finditer(r"(?=(\d+))", mangled):
        start = m.start() + len(m.group(1))
        ident = mangled[start:start + int(m.group(1))]
        if ident.endswith(("_kernel", "_kernel_bf16s", "_kernel_f32s")):
            found.append(ident)
    return min(found, key=len) if found else mangled[:64]


def cuda_ms(fn, reps=20, warmup=3) -> float:
    """ms per call of fn(), CUDA events around `reps` back-to-back calls
    after `warmup` untimed ones."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def median_ms(fn, device, iters=10, warmup=2) -> float:
    """Median ms of one call of fn() over `iters` calls after `warmup`:
    on the card each call between two CUDA events and a synchronize (a
    call's launches and the gaps between them), on the host the wall
    clock."""
    import torch
    cuda = torch.device(device).type == "cuda"
    for _ in range(warmup):
        fn()
    if cuda:
        torch.cuda.synchronize()
    ts = []
    for _ in range(iters):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            ts.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def union_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, cur = 0.0, None
    for s, e in sorted(intervals):
        if cur is None or s > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    return total + (cur[1] - cur[0] if cur else 0.0)


def trace_events(fn, cuda: bool = True, path: str | None = None):
    """(host ms of fn() under torch.profiler, the Chrome trace's complete
    ("X") events). cuda: trace the card too (and synchronise inside the
    window). path: keep the trace there, else in a temporary directory."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        fn()
        if cuda:
            torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        out = path or os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(out)
        events = read_trace(out)
    return wall_ms, events


def read_trace(path: str) -> list:
    """The complete ("X") events of a torch.profiler Chrome trace."""
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X"]


def device_events(events):
    """(start us, end us, name) of the events that ran on the card."""
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", ""))
            for e in events if e.get("cat") in DEVICE_CATS]


def profiled(fn):
    """(host ms of fn() under torch.profiler, the trace's device events as
    (start us, end us, name))."""
    wall_ms, events = trace_events(fn)
    return wall_ms, device_events(events)


def profile_steps(loop, n_steps=3, top=12, tag="5"):
    """Device time by kernel, busy time and idle share over a few
    steady-state steps (uncaptured: fewer than a bundle), all read from one
    torch.profiler trace (chip_smoke.py phase 5, and phases 7 and 8 for
    their loops)."""
    wall_ms, dev = profiled(lambda: loop.run(loop.state.step + n_steps))
    if not dev:
        print(f"[{tag}] the profiler trace holds no device events: time by kernel not measured")
        return
    busy = union_us([(s, e) for s, e, _ in dev]) / 1e3
    span = (max(e for _, e, _ in dev) - min(s for s, _, _ in dev)) / 1e3
    print(f"[{tag}] profiled window: {wall_ms / n_steps:.2f} ms/step host clock (profiler on) | "
          f"device span {span / n_steps:.2f} ms/step | busy {busy / n_steps:.2f} ms/step | "
          f"idle share {1 - busy / span:.4f} of the span", flush=True)
    by_name = {}
    for s, e, name in dev:
        t, c = by_name.get(name, (0.0, 0))
        by_name[name] = (t + (e - s) / 1e3, c + 1)
    total = sum(t for t, _ in by_name.values())
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"[{tag}]   {t / total * 100:5.1f}%  {t / n_steps:8.3f} ms/step  "
              f"{c // n_steps:4d}x  {name[:90]}")
    sweep = sorted((e - s) / 1e3 for s, e, name in dev if "sdf_rays_" in name)
    print(f"[{tag}] sweep kernel launches in the trace (ms each, sorted): "
          f"{' '.join(f'{x:.4f}' for x in sweep)}", flush=True)
