"""Worker of tests/test_torch_parallel.py (not a test file): one rank of a
data-parallel group of the port on the CPU.

    RANK=<r> WORLD_SIZE=<w> MASTER_ADDR=127.0.0.1 MASTER_PORT=<port> \
        python tests/_torch_mp_worker.py <dir>

It imports torch and color_neus_torch only (it checks at the end that
neither jax nor color_neus_tpu was imported): the port's distributed
path needs no JAX. It joins the gloo group through parallel.init, as
`train --distributed --device cpu` does, and runs three phases, writing
rank_<r>.json and steps_<r>.npz into <dir>:

  1. the collectives: gather_rays' forward and backward (the gradient of
     this rank's rows only, not the sum over ranks) and allreduce_grads
     with a leaf that has no gradient on rank 1;
  2. one data-parallel train step of each case in CASES on the pixels and
     parameters the test wrote to <dir>/inputs_<case>.npz (port_step: the
     loss, every leaf's clipped gradient and the updated parameters);
  3. TrainLoop on a tiny synthetic scene in bundles of 3 steps, recording
     into <dir>/exp: 6 steps straight; 3 steps, stop, resume from the
     checkpoint, 3 more; a digest of the parameters after every bundle;
     and a run in which rank 1 alone receives SIGTERM after its second
     bundle.

The test imports this module for CASES, port_cfg and port_step, so its
one-process reference runs the same code.
"""

from __future__ import annotations

import hashlib
import json
import os
import signal
import sys

import numpy as np
import torch

H = W = 16
N_CAMS = 4
N_RAYS = 32
STEP = 5           # warm-up 10: lr_t = lr * 5 / 10
SEED = 7           # the perturbed case's generator

# the parametrised cases: the renderer switches, learnt cameras and the
# sample perturbation (the JAX comparison runs at perturb 0 only: JAX folds
# the device index into its key, the port shares the global draw)
CASES = {
    "auto": dict(fused_core="auto", fused_march="auto", learn_cams=False, perturb=0.0),
    "core-on": dict(fused_core="on", fused_march="auto", learn_cams=False, perturb=0.0),
    "march-on": dict(fused_core="auto", fused_march="on", learn_cams=False, perturb=0.0),
    "cams": dict(fused_core="auto", fused_march="auto", learn_cams=True, perturb=0.0),
    "perturb": dict(fused_core="auto", fused_march="on", learn_cams=False, perturb=1.0),
}


def renderer_config(mod, fused_sdf, fused_core="auto", fused_march="auto", perturb=0.0):
    """Colour-NeuS at small widths from a configs module (the port's or
    the JAX package's)."""
    return mod.RendererConfig(
        kind="color_neus", n_samples=16, n_importance=8, up_sample_steps=2, perturb=perturb,
        fused_sdf=fused_sdf, sweep_dtype="float32", fused_core=fused_core,
        fused_march=fused_march,
        sdf=mod.SDFConfig(d_hidden=64, n_layers=4, skip_in=(2,), multires=4),
        color=mod.ColorConfig(mode="no_view_dir", d_in=6, d_feature=256, d_hidden=64,
                              n_layers=2, multires_view=0),
        relight=mod.RelightConfig(d_hidden=32, n_layers=4, y_in_layer=3))


def trainer_kwargs(case: str) -> dict:
    """TrainerConfig's arguments but the camera and the renderer: the mask
    and relight terms on (lambda_mask 0.1, lambda_relight 1.0)."""
    return dict(n_rays=N_RAYS, include_mask=True, mask_rate=(0.5, 0.8), iterations=100,
                warm_up=10, lr=5e-4, lambda_mask=0.1, lambda_relight=1.0)


def camera_kwargs(case: str) -> dict:
    learn = CASES[case]["learn_cams"]
    return dict(H=H, W=W, n_cams=N_CAMS, pose_mode="3d" if learn else "6d", focal_order=2,
                learn_focal=learn, learn_r=learn, learn_t=learn)


def port_cfg(case: str, mesh=None):
    from color_neus_torch.models import configs
    from color_neus_torch.models import trainer as TR
    from color_neus_torch.models.camera import CameraConfig
    from color_neus_torch.parallel import with_mesh
    c = CASES[case]
    cfg = TR.TrainerConfig(**trainer_kwargs(case), camera=CameraConfig(**camera_kwargs(case)),
                           renderer=renderer_config(configs, "auto", c["fused_core"],
                                                    c["fused_march"], c["perturb"]))
    return with_mesh(cfg, mesh)


def load_inputs(path: str) -> dict:
    """inputs_<case>.npz: the parameter tree under params/<a>/<b>/..., the
    scene and the injected pixels."""
    out, tree = {}, {}
    with np.load(path) as f:
        for k in f.files:
            if k.startswith("params/"):
                node = tree
                *head, leaf = k.split("/")[1:]
                for h in head:
                    node = node.setdefault(h, {})
                node[leaf] = f[k]
            else:
                out[k] = f[k]
    out["params"] = tree
    return out


def port_step(case: str, inputs: dict, mesh=None) -> dict:
    """One train step of the port at step STEP on the injected pixels:
    {"loss", "grads": {leaf: clipped gradient, zeros where none},
    "params": {leaf: updated value}} as numpy."""
    from color_neus_torch.models import trainer as TR
    from color_neus_torch.weights import state_from_numpy
    cfg = port_cfg(case, mesh)
    params = state_from_numpy(inputs["params"])
    state = TR.TrainState(params, TR.make_optimizer(cfg, params), step=STEP)
    scene = TR.make_scene(np.zeros(3), 1.0, inputs["poses"], "cpu")
    g = torch.Generator().manual_seed(SEED)
    t = {k: torch.from_numpy(inputs[k]) for k in ("images", "img_ids", "cam_sel", "py", "px",
                                                   "sel_mask")}
    aux = TR.train_step_pixels(state, scene, cfg, t["images"], t["img_ids"], t["cam_sel"],
                               t["py"], t["px"], t["sel_mask"], generator=g)
    named = dict(params.named_parameters())
    return {"loss": float(aux["loss"]), "lr": float(aux["lr"]),
            "grads": {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy().copy()
                      for n, p in named.items()},
            "params": {n: p.detach().numpy().copy() for n, p in named.items()}}


def _digest(params) -> str:
    h = hashlib.sha256()
    for name, p in params.named_parameters():
        h.update(name.encode())
        h.update(p.detach().numpy().tobytes())
    return h.hexdigest()


def collectives(mesh) -> dict:
    """Phase 1."""
    from color_neus_torch.parallel import allreduce_grads, gather_rays
    r, w = mesh.rank, mesh.world
    x = torch.arange(6, dtype=torch.float32).reshape(3, 2) + 10 * r
    x.requires_grad_(True)
    y = gather_rays(x, mesh)
    want_y = torch.cat([torch.arange(6, dtype=torch.float32).reshape(3, 2) + 10 * q
                        for q in range(w)])
    c = torch.linspace(-1.0, 2.0, 6 * w).reshape(3 * w, 2)
    (y * c).sum().backward()
    # a leaf with a gradient on rank 0 only
    m = torch.nn.ParameterDict({"a": torch.nn.Parameter(torch.ones(3)),
                                "b": torch.nn.Parameter(torch.ones(2))})
    (m["a"] * (r + 1.0)).sum().backward()
    if r == 0:
        (m["b"] * 3.0).sum().backward()
    allreduce_grads(m)
    return {"gather_forward": bool(torch.equal(y, want_y)),
            "gather_grad": x.grad.tolist(), "gather_grad_want": c[3 * r:3 * (r + 1)].tolist(),
            "allreduce_a": m["a"].grad.tolist(), "allreduce_b": m["b"].grad.tolist()}


def loop_cfg(iterations: int) -> dict:
    """A tiny Color-NeuS run on the synthetic scene: bundles of 3 steps
    (LOG, SAVE and VIZ_IMAGE intervals 3), a validation image at step 3,
    perturb 1, 64 rays (32 a rank)."""
    return {
        "DATASET": {"TYPE": "Synthetic", "N_IMGS": 4, "H": 12, "W": 12},
        "DATA_PRESET": {"INCLUDE_MASK": True},
        "MODEL": {
            "N_RAYS": 64, "EVAL_RAY_SIZE": 72, "MASK_RATE": [0.5, 0.8],
            "RENDERER": {
                "TYPE": "Color_NeuS", "N_SAMPLES": 8, "N_IMPORTANCE": 4,
                "UP_SAMPLE_STEPS": 2, "PERTURB": 1.0,
                "SDF": {"D_HIDDEN": 32, "N_LAYERS": 2, "SKIP_IN": [], "MULTIRES": 2},
                "COLOR": {"MODE": "no_view_dir", "D_IN": 6, "D_HIDDEN": 32, "N_LAYERS": 1,
                          "MULTIRES_VIEW": 0},
                "RELIGHT": {"D_HIDDEN": 16, "N_LAYERS": 4, "Y_IN_LAYER": 3}},
            "LOSS": {"LAMBDA_MASK": 0.1, "LAMBDA_RELIGHT": 1.0},
        },
        "TRAIN": {"BATCH_SIZE": 2, "ITERATIONS": iterations, "LOG_INTERVAL": 3,
                  "SAVE_INTERVAL": 3, "VIZ_IMAGE_INTERVAL": 3, "VIZ_MESH_INTERVAL": 999,
                  "MANUAL_SEED": 1, "OPTIMIZE": {"WARM_UP": 2}},
    }


def training_loops(mesh, outdir: str) -> dict:
    """Phase 3 (in outdir, which holds exp/)."""
    from color_neus_torch.runtime import TrainLoop
    from color_neus_torch.utils.config import config_from_dict

    def loop(iterations=6, **kw):
        return TrainLoop(config_from_dict(loop_cfg(iterations)), device="cpu", mesh=mesh,
                         require_clean_git=False, **kw)

    def watch(lp, digests, signal_after=None):
        bundle = lp.training_bundle

        def wrapped():
            out = bundle()
            digests.append(_digest(lp.state.params))
            if signal_after is not None and len(digests) == signal_after:
                os.kill(os.getpid(), signal.SIGTERM)
            return out
        lp.training_bundle = wrapped

    def hexes(losses):
        return [float(v).hex() for v in losses]

    straight, d_straight = loop(exp_id="straight"), []
    watch(straight, d_straight)
    l_straight = straight.run()
    head, d_head = loop(exp_id="resume"), []
    watch(head, d_head)
    l_head = head.run(stop_after=3)
    tail, d_tail = loop(resume=head.exp_path), []
    resumed_at = tail.state.step
    watch(tail, d_tail)
    l_tail = tail.run()
    same = all(torch.equal(a, b) for a, b in zip(straight.state.params.parameters(),
                                                  tail.state.params.parameters()))
    opt_same = all(torch.equal(torch.as_tensor(x), torch.as_tensor(y))
                   for p, q in zip(straight.state.params.parameters(),
                                   tail.state.params.parameters())
                   for x, y in zip(straight.state.optimizer.state.get(p, {}).values(),
                                   tail.state.optimizer.state.get(q, {}).values()))
    # SIGTERM to rank 1 alone, after its second bundle
    term, d_term = loop(iterations=300, exp_id="sigterm"), []
    watch(term, d_term, signal_after=2 if mesh.rank == 1 else None)
    l_term = term.run()
    return {"straight": hexes(l_straight), "head": hexes(l_head), "tail": hexes(l_tail),
            "resumed_at": resumed_at, "final_params_equal": same, "final_optim_equal": opt_same,
            "generator_equal": bool(torch.equal(straight.generator.get_state(),
                                                tail.generator.get_state())),
            "digests": {"straight": d_straight, "head": d_head, "tail": d_tail,
                        "sigterm": d_term},
            "exp_paths": {"straight": straight.exp_path, "resume": head.exp_path,
                          "tail": tail.exp_path, "sigterm": term.exp_path},
            "recorder": [lp.recorder is not None for lp in (straight, head, tail, term)],
            "sigterm_step": term.state.step, "sigterm_losses": hexes(l_term)}


def main():
    outdir = sys.argv[1]
    torch.set_num_threads(1)
    from color_neus_torch import parallel, pin_precision
    pin_precision()
    dev = parallel.init(backend="gloo", device="cpu")
    mesh = parallel.make_mesh()
    rec = {"device": str(dev), "rank": parallel.rank(), "world": parallel.world(),
           "backend": mesh.backend, "capturable": mesh.capturable}
    rec["collectives"] = collectives(mesh)
    steps = {}
    for case in CASES:
        out = port_step(case, load_inputs(os.path.join(outdir, f"inputs_{case}.npz")), mesh)
        steps[f"{case}/loss"] = np.asarray(out["loss"])
        steps[f"{case}/lr"] = np.asarray(out["lr"])
        for kind in ("grads", "params"):
            for name, v in out[kind].items():
                steps[f"{case}/{kind}/{name}"] = v
    np.savez(os.path.join(outdir, f"steps_{mesh.rank}.npz"), **steps)
    os.chdir(outdir)
    rec["loops"] = training_loops(mesh, outdir)
    rec["imports_jax"] = sorted(m for m in ("jax", "color_neus_tpu") if m in sys.modules)
    with open(os.path.join(outdir, f"rank_{mesh.rank}.json"), "w") as f:
        json.dump(rec, f)
    parallel.shutdown()


if __name__ == "__main__":
    main()
