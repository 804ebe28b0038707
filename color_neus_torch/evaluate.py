"""Evaluation entry point of the port: mesh extraction from a checkpoint.

    python -m color_neus_torch.evaluate --cfg config/Color_NeuS_synthetic.yml \
        --reload exp/default_<timestamp>/checkpoints/state.npz -rr 512 [--device cpu]

The counterpart of evaluation.py, with the same flags. Writes
<step>_mesh.ply and <step>_color.ply (vertex colours) in world space into
exp/<exp_id>_<timestamp>/meshes/. Runs on the CUDA card unless
--device cpu is given.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser("color_neus_torch evaluation")
    p.add_argument("--cfg", type=str, required=True)
    p.add_argument("-obj", "--obj_id", type=str, default=None)
    p.add_argument("--reload", type=str, required=True, help="checkpoint npz")
    p.add_argument("-rr", "--recon_res", type=int, default=512)
    p.add_argument("-g", "--gpu_id", type=str, default=None)
    p.add_argument("-b", "--batch_size", type=int, default=None)
    p.add_argument("--exp_id", type=str, default=None)
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' for the plain path)")
    return p.parse_args(argv)


def main(argv=None):
    arg = parse_args(argv)
    from color_neus_torch.runtime import TrainLoop
    from color_neus_torch.utils.config import get_config
    from color_neus_torch.utils.logger import logger

    cfg = get_config(arg.cfg, arg)   # --reload -> MODEL.PRETRAINED
    exp_id = arg.exp_id or f"eval_{cfg['MODEL']['RENDERER']['TYPE']}_{arg.obj_id}"
    loop = TrainLoop(cfg, device=arg.device, exp_id=exp_id)
    out = loop.testing_step(loop.state.step, recon_res=arg.recon_res)
    if out is not None:
        logger.info("meshes written to %s", loop.recorder.mesh_dir)


if __name__ == "__main__":
    main()
