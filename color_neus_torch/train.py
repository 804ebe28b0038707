"""Training entry point of the port.

    python -m color_neus_torch.train --cfg config/Color_NeuS_synthetic.yml \
        --iterations 60 [--exp_id default] [--device cpu]

Runs on the CUDA card unless --device cpu is given; without a card and
without that flag it stops with an error. The YAML schema is the
reference's (config/*.yml, shared with the JAX package). The run records
into exp/<exp_id>_<timestamp>/ (checkpoints/state.npz at SAVE_INTERVAL and
at the end; python -m color_neus_torch.evaluate --reload reads it).
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser("color_neus_torch trainer")
    p.add_argument("--cfg", type=str, required=True, help="config yaml path")
    p.add_argument("--exp_id", type=str, default="default")
    p.add_argument("-obj", "--obj_id", type=str, default=None)
    p.add_argument("--reload", type=str, default=None, help="checkpoint to start from")
    p.add_argument("-b", "--batch_size", type=int, default=None)
    p.add_argument("--iterations", type=int, default=None,
                   help="override TRAIN.ITERATIONS")
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' for the plain path)")
    p.add_argument("--allow_dirty", action="store_true",
                   help="skip the clean-git-tree check for named exp_ids")
    return p.parse_args(argv)


def main(argv=None):
    arg = parse_args(argv)
    from color_neus_torch.runtime import TrainLoop
    from color_neus_torch.utils.config import get_config

    cfg = get_config(arg.cfg, arg)
    TrainLoop(cfg, device=arg.device, exp_id=arg.exp_id,
              require_clean_git=not arg.allow_dirty).run()


if __name__ == "__main__":
    main()
