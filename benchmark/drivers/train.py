"""The training traffic: the port's captured training bundles
(color_neus_torch.models.trainer.MultiStep, LOG_INTERVAL steps a replay,
each bundle's losses read back to the host as TrainLoop.run's log step
does) on a scene and first weights made from the seed.

A traffic file of this kind holds:
  kind           "train"
  n_rays, n_samples, n_importance, up_sample_steps
                 the step's sizes (the configuration's MODEL.N_RAYS and
                 RENDERER values where left out)
  start_step     the step count the state starts at (the schedule's
                 learning rate and mask share read it; the work does not)
  scene          views, height, width, focal: benchmark.scene.make_scene
  trace_bundles  bundles under the profiler in a --trace 1 run
  limits         {number: limit} of benchmark.compare.training

Set-up builds the state, the scene and the bundle object and makes its
first two calls: the warm-up bundle (k real steps, uncaptured, then the
capture of k steps into the graph) and the first replay of that graph,
the window's own call. It keeps the 2k steps' losses, the first gradient
as the optimizer got it, and the parameters after the replay, and hands
the same object to the window. Once the window has closed and the peak
memory is read, the program is freed and the reference follows the same
2k steps from the same inputs (benchmark.reference.train), so the
parameters and the last k losses compared are the captured graph's.
"""

from __future__ import annotations

import copy
import gc
import time

import numpy as np
import torch

from benchmark import compare, scene as S
from benchmark.counts import march, sweep
from benchmark.reference.train import ReferenceTrainer


def sizes_of(cfg: dict, traffic: dict) -> dict:
    m, r = cfg["MODEL"], cfg["MODEL"]["RENDERER"]
    return {"n_rays": traffic.get("n_rays", m["N_RAYS"]),
            "n_samples": traffic.get("n_samples", r["N_SAMPLES"]),
            "n_importance": traffic.get("n_importance", r["N_IMPORTANCE"]),
            "up_sample_steps": traffic.get("up_sample_steps", r["UP_SAMPLE_STEPS"]),
            "batch_size": cfg["TRAIN"]["BATCH_SIZE"]}


def program_cfg(cfg: dict, sizes: dict) -> dict:
    """The configuration as the program reads it, at the traffic's sizes."""
    out = copy.deepcopy({k: cfg[k] for k in ("DATASET", "DATA_PRESET", "MODEL", "TRAIN")})
    out["MODEL"]["N_RAYS"] = sizes["n_rays"]
    r = out["MODEL"]["RENDERER"]
    r["N_SAMPLES"], r["N_IMPORTANCE"] = sizes["n_samples"], sizes["n_importance"]
    r["UP_SAMPLE_STEPS"] = sizes["up_sample_steps"]
    return out


def bundle_k(cfg: dict, sizes: dict) -> int:
    """The steps of one bundle, as the program's loop sets them."""
    from color_neus_torch.runtime import bundle_steps
    return bundle_steps(program_cfg(cfg, sizes)["TRAIN"])


class Program:
    """The port's training state, scene and bundle object, from the
    benchmark's inputs."""

    def __init__(self, cfg: dict, sizes: dict, sc: dict, leaves: dict, start_step: int,
                 seed: int, device):
        from color_neus_torch import pin_precision
        from color_neus_torch.models import trainer as TR
        pin_precision()
        pcfg = program_cfg(cfg, sizes)
        n_views = sc["images"].shape[0]
        tcfg = TR.trainer_config_from_cfg(pcfg, sc["H"], sc["W"], n_views)
        self.state = TR.init_state(tcfg, torch.Generator(device=device).manual_seed(0), device,
                                   init_focal_np=np.asarray(sc["focal"]))
        named = dict(self.state.params.named_parameters())
        if set(named) != set(leaves) or any(named[k].shape != leaves[k].shape for k in named):
            raise RuntimeError("the program's parameters are not the benchmark's leaves: "
                               f"{sorted(set(named) ^ set(leaves))}")
        with torch.no_grad():
            for k, p in named.items():
                p.copy_(leaves[k])
        self.state.set_step(start_step)
        self.scene = TR.make_scene(np.zeros(3), 1.0, sc["c2w"].cpu().numpy(), device)
        self.images, self.masks = sc["images"], sc["masks"]
        self.k = bundle_k(cfg, sizes)
        self.multi = TR.make_train_multi_step(tcfg, n_views, sizes["batch_size"], self.k)
        self.gen = torch.Generator(device=device).manual_seed(seed)

    def _call(self):
        return self.multi(self.state, self.scene, self.images, self.masks, self.gen)

    def setup_calls(self) -> dict:
        """The first call (the warm-up bundle, then the capture) and the
        first replay: the 2k steps' losses, the first gradient from the
        optimizer's state after one step, and the parameters after the
        replay."""
        opt = self.state.optimizer
        named = list(self.state.params.named_parameters())
        rec = {}

        def hook(optimizer, args, kwargs):
            if "grad" not in rec:
                b1 = optimizer.param_groups[0]["betas"][0]
                rec["grad"] = {k: optimizer.state[p]["exp_avg"].detach().clone() / (1 - b1)
                               for k, p in named if "exp_avg" in optimizer.state.get(p, {})}

        handle = opt.register_step_post_hook(hook)
        try:
            _, _, warm = self._call()
        finally:
            handle.remove()
        _, _, replay = self._call()
        return {"losses": [float(x) for x in torch.cat([warm, replay]).cpu()],
                "grad": rec.get("grad", {}),
                "params": {k: p.detach().clone() for k, p in named}}

    def bundle(self) -> bool:
        """One bundle; reads its losses back; True when all are finite."""
        _, _, losses = self._call()
        return bool(torch.isfinite(losses.cpu()).all())

    def free(self) -> None:
        del self.multi, self.state
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def inputs(cell, seed: int, device) -> tuple:
    """(sizes, renderer config, scene, first weights, start step) of a
    training cell from the seed: what a run hands the program and the
    reference alike."""
    sizes = sizes_of(cell.config, cell.traffic)
    r = program_cfg(cell.config, sizes)["MODEL"]["RENDERER"]
    sc = S.make_scene(cell.traffic["scene"], seed, device)
    leaves = S.make_leaves(r, sc["H"], sc["W"], sc["focal"], sc["images"].shape[0], seed,
                           device)
    return sizes, r, sc, leaves, int(cell.traffic.get("start_step", 0))


def run(cell, seed: int, seconds: float, trace: bool, device, clock_start: float,
        trace_fn=None) -> dict:
    """One run of a training cell. Returns {setup_s, metrics (end to end
    or, traced, the per-layer context), attempted, failed, numbers,
    memory_peak_bytes, ...}. clock_start: the process's start on the
    perf_counter clock."""
    cfg = cell.config
    sizes, r, sc, leaves, start = inputs(cell, seed, device)
    prog = Program(cfg, sizes, sc, leaves, start, S.step_seed(seed), device)
    first = prog.setup_calls()
    _sync(device)
    out = {"setup_s": time.perf_counter() - clock_start, "k": prog.k}
    nonfinite = 0
    if trace:
        n_b = int(cell.traffic.get("trace_bundles", 10))
        flags = []
        window_s, events = trace_fn(lambda: flags.extend(prog.bundle() for _ in range(n_b)))
        nonfinite = flags.count(False)
        out.update(attempted=n_b, window_s=window_s, events=events, steps=n_b * prog.k)
    else:
        bundles = 0
        t0 = time.perf_counter()
        while True:
            nonfinite += not prog.bundle()
            bundles += 1
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(device)
        elapsed = time.perf_counter() - t0
        out.update(attempted=bundles, window_s=elapsed, steps=bundles * prog.k,
                   rays_per_s=bundles * prog.k * sizes["n_rays"] / elapsed)
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                if torch.device(device).type == "cuda" else 0)
    out["failed"] = nonfinite
    prog.free()
    ref = reference_steps(cfg, leaves, sc, sizes, start, seed, 2 * out["k"])
    out["numbers"] = compare.training(first, ref, leaves, nonfinite)
    out["counts"] = step_counts(r, sizes)
    return out


def reference_steps(cfg, leaves, sc, sizes, start, seed, n_check, quant=None) -> dict:
    """The reference's first n_check steps: {losses, grad, params after them}."""
    ref = ReferenceTrainer(cfg, leaves, sc, sizes, start, S.step_seed(seed), quant=quant)
    losses = [ref.step() for _ in range(n_check)]
    return {"losses": losses, "grad": ref.first_grad,
            "params": {k: v.detach() for k, v in ref.leaves.items()}}


def step_counts(r: dict, sizes: dict) -> dict:
    """The benchmark's operations and bytes of one step, by kernel family."""
    pts = sizes["n_samples"] + sizes["n_importance"]
    args = (r, sizes["n_rays"], sizes["n_samples"], sizes["n_importance"],
            sizes["up_sample_steps"])
    return {"march": {"flops": march.flops(r, sizes["n_rays"], pts),
                      "bytes": march.bytes_moved(r, sizes["n_rays"], pts)},
            "sweep": {"flops": sweep.flops(*args), "bytes": sweep.bytes_moved(*args)}}


def per_layer_context(out: dict, summary, peak) -> dict:
    """What the per-layer readers of a training cell read."""
    return {"kind": "train", "summary": summary, "steps": out["steps"],
            "window_s": out["window_s"], "counts": out["counts"], "peak": peak}


def end_to_end(out: dict) -> dict:
    """The end-to-end metrics of an untraced run, by name."""
    return {"train_rays_per_s": out["rays_per_s"],
            "train_peak_gib": out["memory_peak_bytes"] / 2 ** 30,
            "setup_s": out["setup_s"]}
