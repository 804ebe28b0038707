"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Each run is a new process: it makes the cell's inputs from the seed,
builds and warms the program (set-up), measures for --seconds (or, with
--trace 1, traces a short window for the per-layer metrics), checks what
the timed path produced against the plain reference, and prints one JSON
object as the last line of standard output: correct, attempted, failed,
metrics, device, (breakdown,) and last `compared`, each number that
decided `correct` beside its limit. The same numbers close standard
error. Without a CUDA card, or with fewer than the cell asks for, it
exits 2 and prints no result; so it does if a module of JAX or of the
JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "color_neus_tpu")


class NoResult(RuntimeError):
    """A run that must end without a result line."""


def process_start() -> float:
    """The process's start on the perf_counter clock (its age read from
    /proc, so the interpreter's own start counts as set-up)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")
        return _T0 - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return _T0


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted({name for name in modules if name.split(".", 1)[0] in FORBIDDEN})


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def _clean(x):
    """A number for the line: non-finite values as strings."""
    return x if isinstance(x, (int, float)) and math.isfinite(x) else str(x)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, device=None,
             require_card: bool = True, root: str | None = None,
             workloads_dir: str | None = None) -> dict:
    """The result of one run as a dict (the line's keys). device: the
    card unless given (tests pass "cpu" with require_card False)."""
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(HERE, "_cache", "triton"))
    from benchmark import compare, spec, trace as tr
    import torch
    bench = spec.load(root or spec.ROOT)
    cell = spec.Cell(bench, workload, root or spec.ROOT, workloads_dir)
    if require_card:
        if not torch.cuda.is_available():
            raise NoResult("no CUDA device: torch.cuda.is_available() is false")
        if torch.cuda.device_count() < cell.chips:
            raise NoResult(f"{workload} needs {cell.chips} cards, "
                           f"{torch.cuda.device_count()} present")
        print(f"card: {card_line()}", file=sys.stderr, flush=True)
    device = torch.device(device or "cuda")
    kind = cell.traffic["kind"]
    if kind == "train":
        from benchmark.drivers import train as driver
    elif kind == "extract":
        from benchmark.drivers import extract as driver
    else:
        raise NoResult(f"{workload}: no driver of traffic kind {kind!r}")
    out = driver.run(cell, seed, seconds, trace, device, process_start(),
                     trace_fn=lambda fn: tr.traced(fn, cuda=device.type == "cuda"))
    peak = None
    if device.type == "cuda":
        with open(os.path.join(HERE, "peaks.json")) as f:
            peak = json.load(f).get(torch.cuda.get_device_name(0))
    result = {"correct": None, "attempted": out["attempted"], "failed": out["failed"]}
    if trace:
        summary = tr.Summary(out["events"], out["window_s"])
        ctx = driver.per_layer_context(out, summary, peak)
        metrics = {}
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"])(ctx)
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = driver.end_to_end(out)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if math.isfinite(values[m["name"]])}
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
                   "count": cell.chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    if trace:
        device_info.update(busy_s=summary.busy_s, window_s=out["window_s"])
    correct, compared = compare.judge(out["numbers"], cell.traffic["limits"])
    result.update(correct=correct, metrics=metrics, device=device_info)
    if trace:
        result["breakdown"] = summary.breakdown()
    result["compared"] = {k: {"value": _clean(v["value"]), "limit": v["limit"]}
                          for k, v in compared.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    except NoResult as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    loaded = forbidden_modules()
    if loaded:
        print(f"no result: JAX or the JAX package is loaded: {', '.join(loaded)}",
              file=sys.stderr)
        return 2
    print(f"correct: {result['correct']}", file=sys.stderr)
    for k, v in result["compared"].items():
        print(f"compared {k}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
