"""Training entry point of the port.

    python -m color_neus_torch.train --cfg config/Color_NeuS_synthetic.yml \
        --iterations 60 [--exp_id default] [--device cpu]
    python -m color_neus_torch.train --resume exp/default_<timestamp>
    torchrun --nproc_per_node=N -m color_neus_torch.train --distributed \
        --cfg config/Color_NeuS_synthetic.yml

Runs on the CUDA card unless --device cpu is given (-g <id> picks
cuda:<id>); without a card and without that flag it stops with an
error. --distributed joins the process group torchrun describes in the
environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT):
one rank a card on cuda:LOCAL_RANK over NCCL, or processes on the CPU
over gloo with --device cpu; the ray batch is sharded over the ranks
(runtime.TrainLoop's mesh), and N_RAYS must be a multiple of their
number. The YAML schema is the
reference's (config/*.yml, shared with the JAX package); a real scene is
read from DATASET.DATA_ROOT (--data_root, -obj for DATASET.OBJ_ID). The
run records into exp/<exp_id>_<timestamp>/: dump_cfg.yaml,
checkpoints/state.npz at SAVE_INTERVAL, at the end and on SIGTERM /
SIGINT, with an immutable copy every --snapshot saves, and the per-step
scalars in tensorboard/scalars.jsonl. --resume <exp dir> reloads the
config from its dump_cfg.yaml and continues from its checkpoint, the
generator's state included; python -m color_neus_torch.evaluate --reload
reads the checkpoint.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser("color_neus_torch trainer")
    p.add_argument("--cfg", type=str, default=None, help="config yaml path")
    p.add_argument("--exp_id", type=str, default="default")
    p.add_argument("-obj", "--obj_id", type=str, default=None)
    p.add_argument("--resume", type=str, default=None, help="exp dir to resume")
    p.add_argument("--reload", type=str, default=None, help="checkpoint to start from")
    p.add_argument("-b", "--batch_size", type=int, default=None)
    p.add_argument("-g", "--gpu_id", type=int, default=None,
                   help="run on cuda:<id> (one process)")
    p.add_argument("--distributed", action="store_true",
                   help="data-parallel over the ranks torchrun starts (NCCL on the "
                        "cards, gloo with --device cpu)")
    p.add_argument("--snapshot", type=int, default=50,
                   help="keep an immutable copy of the checkpoint every this many saves")
    p.add_argument("--iterations", type=int, default=None,
                   help="override TRAIN.ITERATIONS")
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--profile", type=str, default=None,
                   help="write a torch.profiler trace of two steps to this dir")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' for the plain path)")
    p.add_argument("--allow_dirty", action="store_true",
                   help="skip the clean-git-tree check for named exp_ids")
    arg = p.parse_args(argv)
    if arg.cfg is None and arg.resume is None:
        p.error("--cfg is required (or --resume <exp dir>)")
    if arg.gpu_id is not None and (arg.distributed or arg.device is not None):
        p.error("-g picks the card of a one-process run: not with --distributed (each rank "
                "takes cuda:LOCAL_RANK) or --device")
    return arg


def main(argv=None):
    arg = parse_args(argv)
    from color_neus_torch.runtime import TrainLoop
    from color_neus_torch.utils.config import get_config
    from color_neus_torch.utils.recorder import Recorder

    cfg = get_config(Recorder.find_resume_cfg(arg.resume) if arg.resume else arg.cfg, arg)
    device = arg.device if arg.gpu_id is None else f"cuda:{arg.gpu_id}"
    mesh = None
    if arg.distributed:
        from color_neus_torch import parallel
        device = parallel.init(device=arg.device)
        mesh = parallel.make_mesh()
    try:
        TrainLoop(cfg, device=device, exp_id=arg.exp_id, resume=arg.resume,
                  snapshot=arg.snapshot, require_clean_git=not arg.allow_dirty, mesh=mesh
                  ).run(profile_dir=arg.profile)
    finally:
        if mesh is not None:
            parallel.shutdown()


if __name__ == "__main__":
    main()
