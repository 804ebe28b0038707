"""Experiment recorder: port of color_neus_tpu/utils/recorder.py.

Same layout as the reference Recorder (lib/utils/recorder.py:27-178):
  exp/{exp_id}_{timestamp}/
    dump_cfg.yaml  log/  checkpoints/  viz_image/  meshes/  tensorboard/
Checkpoints (utils/checkpoint.py) hold the train state and the generator
state, with an immutable copy every `snapshot` saves. A resumed run
reloads its config from dump_cfg.yaml (find_resume_cfg; PyYAML is
imported only there and in dump_cfg). ScalarWriter logs the per-step
scalars to tensorboard/scalars.jsonl, and to tensorboardX where it is
importable.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import time

import numpy as np

from color_neus_torch.parallel.mesh import is_rank0
from color_neus_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from color_neus_torch.utils.logger import set_log_file


class Recorder:
    def __init__(self, exp_id: str, cfg, root: str = "./exp", resume_path: str | None = None,
                 snapshot: int = 50, require_clean_git: bool = True,
                 timestamp: str | None = None):
        self.exp_id = exp_id
        self.snapshot = snapshot
        self._n_saves = 0
        require_clean_tree(exp_id, require_clean_git)
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
        import yaml
        d = cfg.to_dict() if hasattr(cfg, "to_dict") else dict(cfg)
        with open(os.path.join(self.exp_path, "dump_cfg.yaml"), "w") as f:
            yaml.safe_dump(d, f)

    @staticmethod
    def find_resume_cfg(resume_path: str) -> str:
        return os.path.join(resume_path, "dump_cfg.yaml")

    @staticmethod
    def checkpoint_file(exp_path: str) -> str:
        """The checkpoint of the experiment directory `exp_path`."""
        return os.path.join(exp_path, "checkpoints", "state.npz")

    def ckpt_path(self) -> str:
        return self.checkpoint_file(self.exp_path)

    def record_checkpoint(self, state, generator) -> str:
        """Save the train state and the generator; every `snapshot` saves
        also an immutable copy checkpoints/state_<step>.npz."""
        path = self.ckpt_path()
        save_checkpoint(path, state, generator)
        self._n_saves += 1
        if self.snapshot > 0 and self._n_saves % self.snapshot == 0:
            shutil.copy2(path, os.path.join(self.ckpt_dir, f"state_{state.step:08d}.npz"))
        return path

    def resume_checkpoint(self, state, generator) -> None:
        load_checkpoint(self.ckpt_path(), state, generator)

    def record_loss(self, loss_metric, step_idx: int, comment: str = ""):
        with open(os.path.join(self.log_path, f"{comment}losses.txt"), "a") as f:
            f.write(f"step {step_idx}: {loss_metric}\n")

    def record_metric(self, metrics: list, step_idx: int, comment: str = ""):
        with open(os.path.join(self.log_path, f"{comment}metrics.txt"), "a") as f:
            f.write(f"step {step_idx}: " + " | ".join(str(m) for m in metrics) + "\n")


def require_clean_tree(exp_id: str, require_clean_git: bool = True) -> None:
    """The reference's clean-tree rule for named experiments
    (recorder.py:39): raises when the git tree is dirty, except for the
    'default' and eval runs or with require_clean_git False."""
    if (require_clean_git and exp_id not in ("default", "eval")
            and not exp_id.startswith("eval_") and _git_dirty()):
        raise RuntimeError(f"git tree dirty; commit before running named exp "
                           f"'{exp_id}' (or pass --allow_dirty)")


def _git_dirty() -> bool:
    try:
        out = subprocess.run(["git", "status", "--porcelain"], capture_output=True, text=True,
                             timeout=10)
    except (OSError, subprocess.SubprocessError):
        return False
    return out.returncode == 0 and bool(out.stdout.strip())


class ScalarWriter:
    """Scalar sink: scalars.jsonl always, tensorboardX too where it is
    importable (then also the image sink); rank 0 only. Lines reach the
    file at each flush; close ends tensorboardX's writer, which reopens on
    the next scalar."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "scalars.jsonl")
        self._lines: list = []
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            self._tb = None
        else:
            self._tb = SummaryWriter(log_dir)

    @property
    def has_image_sink(self) -> bool:
        return self._tb is not None

    def add_scalar(self, tag: str, value: float, step: int):
        if not is_rank0():
            return
        self._lines.append(json.dumps({"tag": tag, "value": float(value), "step": int(step)})
                           + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def add_image(self, tag: str, img_hwc, step: int):
        if self._tb is not None and is_rank0():
            self._tb.add_image(tag, np.asarray(img_hwc), step, dataformats="HWC")

    def flush(self):
        if self._lines:
            with open(self.path, "a") as f:
                f.writelines(self._lines)
            self._lines = []
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        self.flush()
        if self._tb is not None:
            self._tb.close()
