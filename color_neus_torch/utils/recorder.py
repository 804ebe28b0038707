"""Experiment recorder: port of color_neus_tpu/utils/recorder.py.

Same layout as the reference Recorder (lib/utils/recorder.py:27-178):
  exp/{exp_id}_{timestamp}/
    dump_cfg.json  log/  checkpoints/  viz_image/  meshes/
The config is dumped as JSON (the port runs without PyYAML). Checkpoints
(utils/checkpoint.py) hold the train state and the generator state.
Scalars go to the logger (no tensorboard).
"""

from __future__ import annotations

import json
import os
import subprocess
import time

from color_neus_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from color_neus_torch.utils.logger import set_log_file


class Recorder:
    def __init__(self, exp_id: str, cfg, root: str = "./exp", resume_path: str | None = None,
                 require_clean_git: bool = True, timestamp: str | None = None):
        self.exp_id = exp_id
        # the reference enforces a clean tree for named exps (recorder.py:39);
        # 'default' and eval runs are exempt, require_clean_git=False opts out
        if (require_clean_git and exp_id not in ("default", "eval")
                and not exp_id.startswith("eval_") and _git_dirty()):
            raise RuntimeError(f"git tree dirty; commit before running named exp "
                               f"'{exp_id}' (or pass --allow_dirty)")
        if resume_path is not None:
            self.exp_path = resume_path
        else:
            timestamp = timestamp or time.strftime("%Y_%m%d_%H%M_%S")
            self.exp_path = os.path.join(root, f"{exp_id}_{timestamp}")
        for sub in ("log", "checkpoints", "viz_image", "meshes"):
            os.makedirs(os.path.join(self.exp_path, sub), exist_ok=True)
        self.log_path = os.path.join(self.exp_path, "log")
        self.ckpt_dir = os.path.join(self.exp_path, "checkpoints")
        self.viz_image_dir = os.path.join(self.exp_path, "viz_image")
        self.mesh_dir = os.path.join(self.exp_path, "meshes")
        set_log_file(os.path.join(self.log_path, "train.log"))
        if resume_path is None and cfg is not None:
            self.dump_cfg(cfg)

    def dump_cfg(self, cfg):
        d = cfg.to_dict() if hasattr(cfg, "to_dict") else dict(cfg)
        with open(os.path.join(self.exp_path, "dump_cfg.json"), "w") as f:
            json.dump(d, f, indent=2, sort_keys=True)

    def ckpt_path(self) -> str:
        return os.path.join(self.ckpt_dir, "state.npz")

    def record_checkpoint(self, state, generator) -> str:
        path = self.ckpt_path()
        save_checkpoint(path, state, generator)
        return path

    def resume_checkpoint(self, state, generator) -> None:
        load_checkpoint(self.ckpt_path(), state, generator)

    def record_loss(self, loss_metric, step_idx: int, comment: str = ""):
        with open(os.path.join(self.log_path, f"{comment}losses.txt"), "a") as f:
            f.write(f"step {step_idx}: {loss_metric}\n")

    def record_metric(self, metrics: list, step_idx: int, comment: str = ""):
        with open(os.path.join(self.log_path, f"{comment}metrics.txt"), "a") as f:
            f.write(f"step {step_idx}: " + " | ".join(str(m) for m in metrics) + "\n")


def _git_dirty() -> bool:
    try:
        out = subprocess.run(["git", "status", "--porcelain"], capture_output=True, text=True,
                             timeout=10)
    except (OSError, subprocess.SubprocessError):
        return False
    return out.returncode == 0 and bool(out.stdout.strip())
