"""Training entry point of the port.

    python -m color_neus_torch.train --cfg config/Color_NeuS_synthetic.yml \
        --iterations 60 [--device cpu]

Runs on the CUDA card unless --device cpu is given; without a card and
without that flag it stops with an error. The YAML schema is the
reference's (config/*.yml, shared with the JAX package).
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser("color_neus_torch trainer")
    p.add_argument("--cfg", type=str, required=True, help="config yaml path")
    p.add_argument("-obj", "--obj_id", type=str, default=None)
    p.add_argument("-b", "--batch_size", type=int, default=None)
    p.add_argument("--iterations", type=int, default=None,
                   help="override TRAIN.ITERATIONS")
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' for the plain path)")
    return p.parse_args(argv)


def main(argv=None):
    arg = parse_args(argv)
    from color_neus_torch.runtime import TrainLoop
    from color_neus_torch.utils.config import get_config

    cfg = get_config(arg.cfg, arg)
    TrainLoop(cfg, device=arg.device).run()


if __name__ == "__main__":
    main()
