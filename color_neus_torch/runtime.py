"""Training loop: port of the training part of color_neus_tpu/runtime.py.

Builds the dataset, moves the whole image and mask stacks to the device
once, initialises the state from TRAIN.MANUAL_SEED, and runs full-data
steps (image batch and pixels drawn on the device), logging loss, psnr
and lr every LOG_INTERVAL steps. Checkpoints, validation images and
meshes come with later slices of the port.
"""

from __future__ import annotations

import time

import torch

from color_neus_torch import pin_precision, resolve_device
from color_neus_torch.data.base import create_dataset
from color_neus_torch.models import trainer as TR
from color_neus_torch.utils.logger import logger


class TrainLoop:
    def __init__(self, cfg, device=None):
        pin_precision()
        self.cfg = cfg
        self.device = resolve_device(device)
        seed = cfg["TRAIN"].get("MANUAL_SEED", 1)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

        self.dataset = create_dataset(cfg["DATASET"], cfg.get("DATA_PRESET", {}))
        init = self.dataset.init_data()
        self.H, self.W, self.n_imgs = init["H"], init["W"], init["n_imgs"]

        self.tcfg = TR.trainer_config_from_cfg(cfg, self.H, self.W, self.n_imgs)
        self.state = TR.init_state(self.tcfg, self.generator, self.device,
                                   init_focal_np=init["focal"])
        self.scene = TR.make_scene(init["origin"], init["radius"], init["poses"], self.device)

        all_data = self.dataset.load_all()
        self.images = torch.as_tensor(all_data["images"], device=self.device)
        self.masks = (torch.as_tensor(all_data["masks"], device=self.device)
                      if all_data["masks"] is not None else None)
        self.batch_size = cfg["TRAIN"]["BATCH_SIZE"]

    def training_step(self) -> dict:
        return TR.full_data_step(self.state, self.scene, self.tcfg, self.images, self.masks,
                                 self.batch_size, self.generator)

    def run(self, iterations: int | None = None) -> torch.Tensor:
        """Train to `iterations` (default TRAIN.ITERATIONS) steps in total;
        returns the loss of every step run here, on the host."""
        t = self.cfg["TRAIN"]
        iterations = t["ITERATIONS"] if iterations is None else iterations
        log_int = max(t.get("LOG_INTERVAL", 10), 1)
        start = self.state.step
        logger.info("training on %s: steps %d..%d", self.device, start, iterations)
        losses = []
        t0 = time.perf_counter()
        while self.state.step < iterations:
            aux = self.training_step()
            losses.append(aux["loss"])
            step = self.state.step
            if step % log_int == 0 or step >= iterations:
                dt = time.perf_counter() - t0
                logger.info("step %d | loss %.5f | psnr %.2f | lr %.3g | %.0f rays/s",
                            step, float(aux["loss"]), float(aux["psnr"]), aux["lr"],
                            (step - start) * self.tcfg.n_rays / max(dt, 1e-9))
        logger.info("training done.")
        return torch.stack(losses).cpu() if losses else torch.zeros(0)
