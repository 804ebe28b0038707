"""One torch.profiler trace over a traced window, and its reduction: device
time by kernel name, the busy time (the union of the device's intervals),
the breakdown's longest device operations and idle gaps.

The arithmetic is the port's tools/_timing.py's (kernel_name, union_us,
the trace's device categories), copied so that the yardstick does not
move with the program. The idle gaps are named by the innermost host
operation or span that was running across each gap's middle.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")


KERNEL_IDENT = re.compile(r"([A-Za-z_][A-Za-z0-9_]*_kernel(?:_bf16s|_f32s)?)(?![A-Za-z0-9_])")


def kernel_name(name: str) -> str:
    """The `..._kernel` identifier of a device operation's name (or a
    `_kernel_bf16s` / `_kernel_f32s` one), demangled as the profiler
    writes it (`(anonymous namespace)::ray_march_load_bwd_kernel(...)`,
    `void at::native::elementwise_kernel<...>`: the first such identifier)
    or mangled (`_Z...`: the shortest one whose length prefix matches);
    else the name's first 64 characters."""
    if not name.startswith("_Z"):
        m = KERNEL_IDENT.search(name)
        return m.group(1) if m else name[:64]
    mangled = name
    found = []
    for m in re.finditer(r"(?=(\d+))", mangled):
        start = m.start() + len(m.group(1))
        ident = mangled[start:start + int(m.group(1))]
        if ident.endswith(("_kernel", "_kernel_bf16s", "_kernel_f32s")):
            found.append(ident)
    return min(found, key=len) if found else mangled[:64]


def union_s(intervals) -> float:
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


def merged(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def traced(fn, cuda: bool = True):
    """(host seconds of fn() under torch.profiler, ended by a synchronize;
    the trace's complete events). The trace goes through a file in
    TMPDIR, deleted at once. cuda False traces the host alone (tests)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        window = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return window, [e for e in events if e.get("ph") == "X" and "dur" in e]


class Summary:
    """The reduction of a trace: `device` as (start s, end s, kernel name),
    busy_s, the per-name device seconds, and the host events."""

    def __init__(self, events: list, window_s: float):
        self.window_s = window_s
        self.device = [(float(e["ts"]) * 1e-6, (float(e["ts"]) + float(e["dur"])) * 1e-6,
                        kernel_name(e.get("name", "")))
                       for e in events if e.get("cat") in DEVICE_CATS]
        self.host = [(float(e["ts"]) * 1e-6, (float(e["ts"]) + float(e["dur"])) * 1e-6,
                      e.get("name", "")) for e in events if e.get("cat") in HOST_CATS]
        self.busy_s = union_s([(s, e) for s, e, _ in self.device])
        self.by_name: dict = {}
        for s, e, n in self.device:
            self.by_name[n] = self.by_name.get(n, 0.0) + (e - s)

    def seconds_of(self, match) -> float:
        """Device seconds of every operation whose name `match` accepts."""
        return sum(t for n, t in self.by_name.items() if match(n))

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, t] for n, t in ops], "idle_gaps": self.idle_gaps(top)}

    def idle_gaps(self, top: int = 10) -> list:
        """The idle gaps between the device's busy intervals, summed by
        the innermost host event running across each gap's middle."""
        busy = merged([(s, e) for s, e, _ in self.device])
        host = sorted(self.host)
        starts = [h[0] for h in host]
        by: dict = {}
        for (_, e0), (s1, _) in zip(busy, busy[1:]):
            mid = 0.5 * (e0 + s1)
            i = bisect.bisect_right(starts, mid)
            cover = [h for h in host[max(0, i - 4000):i] if h[1] >= mid]
            name = min(cover, key=lambda h: h[1] - h[0])[2] if cover else "host (no event)"
            by[name] = by.get(name, 0.0) + (s1 - e0)
        return [[n, t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]
