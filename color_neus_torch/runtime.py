"""Train / eval loop: port of color_neus_tpu/runtime.py.

Builds the dataset, moves the whole image and mask stacks to the device
once, initialises the state from TRAIN.MANUAL_SEED (or loads
MODEL.PRETRAINED, the --reload checkpoint), and runs full-data steps
(image batch and pixels drawn on the device), logging loss, psnr and lr
every LOG_INTERVAL steps.

Given an experiment id (as the CLIs give it), the loop also records: a
checkpoint every SAVE_INTERVAL steps and at the end, a validation image
every VIZ_IMAGE_INTERVAL steps and a mesh every VIZ_MESH_INTERVAL steps
(runtime.py:199-206). Without one it writes nothing.
"""

from __future__ import annotations

import os
import struct
import time
import zlib

import numpy as np
import torch

from color_neus_torch import pin_precision, resolve_device
from color_neus_torch.data.base import create_dataset
from color_neus_torch.models import trainer as TR
from color_neus_torch.ops import mesh as mesh_ops
from color_neus_torch.utils.checkpoint import load_checkpoint
from color_neus_torch.utils.logger import logger
from color_neus_torch.utils.metrics import PSNR, SSIM, LossMetric
from color_neus_torch.utils.recorder import Recorder


def depth_colormap(depth: np.ndarray) -> np.ndarray:
    """HOT-style colormap for depth viz (viztools.py:158-162 capability)."""
    d = depth - depth.min()
    d = d / max(float(d.max()), 1e-8)
    r = np.clip(3 * d, 0, 1)
    g = np.clip(3 * d - 1, 0, 1)
    b = np.clip(3 * d - 2, 0, 1)
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


def write_png(path: str, img: np.ndarray) -> None:
    """An 8-bit RGB [H, W, 3] image as PNG (zlib only, no image library)."""
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + np.ascontiguousarray(img[y], np.uint8).tobytes() for y in range(h))

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


class TrainLoop:
    def __init__(self, cfg, device=None, exp_id: str | None = None,
                 require_clean_git: bool = True):
        pin_precision()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.seed = cfg["TRAIN"].get("MANUAL_SEED", 1)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)

        self.dataset = create_dataset(cfg["DATASET"], cfg.get("DATA_PRESET", {}))
        init = self.dataset.init_data()
        self.H, self.W, self.n_imgs = init["H"], init["W"], init["n_imgs"]
        self.scale_mats = init["scale_mats_np"]
        self.bbox_min, self.bbox_max = init["object_bbox_min"], init["object_bbox_max"]

        self.tcfg = TR.trainer_config_from_cfg(cfg, self.H, self.W, self.n_imgs)
        self.state = TR.init_state(self.tcfg, self.generator, self.device,
                                   init_focal_np=init["focal"])
        self.scene = TR.make_scene(init["origin"], init["radius"], init["poses"], self.device)

        all_data = self.dataset.load_all()
        self.images = torch.as_tensor(all_data["images"], device=self.device)
        self.masks = (torch.as_tensor(all_data["masks"], device=self.device)
                      if all_data["masks"] is not None else None)
        self.batch_size = cfg["TRAIN"]["BATCH_SIZE"]

        self.recorder = (Recorder(exp_id, cfg, require_clean_git=require_clean_git)
                         if exp_id is not None else None)
        self.loss_metric = LossMetric()
        self.psnr_metric = PSNR()
        self.ssim_metric = SSIM()
        self.last_mesh_stats: dict = {}

        pretrained = cfg["MODEL"].get("PRETRAINED")
        if pretrained:
            load_checkpoint(pretrained, self.state)
            logger.info("loaded pretrained state (step %d) from %s", self.state.step, pretrained)

    def training_step(self) -> dict:
        return TR.full_data_step(self.state, self.scene, self.tcfg, self.images, self.masks,
                                 self.batch_size, self.generator)

    def run(self, iterations: int | None = None) -> torch.Tensor:
        """Train to `iterations` (default TRAIN.ITERATIONS) steps in total;
        returns the loss of every step run here, on the host."""
        t = self.cfg["TRAIN"]
        iterations = t["ITERATIONS"] if iterations is None else iterations
        log_int = max(t.get("LOG_INTERVAL", 10), 1)
        save_int = t.get("SAVE_INTERVAL", 10000)
        viz_img_int = t.get("VIZ_IMAGE_INTERVAL", 10000)
        viz_mesh_int = t.get("VIZ_MESH_INTERVAL", 10000)
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
                if self.recorder is not None:
                    self.loss_metric.feed(aux)
            if self.recorder is None:
                continue
            if step % save_int == 0 or step >= iterations:
                self.recorder.record_checkpoint(self.state, self.generator)
                self.on_train_finished(step)
            if step % viz_img_int == 0 and step < iterations:
                self.validation_step(step)
            if step % viz_mesh_int == 0 and step < iterations:
                self.validate_mesh(step, resolution=512)
        logger.info("training done.")
        return torch.stack(losses).cpu() if losses else torch.zeros(0)

    # ------------------------------------------------------------------
    # Trainer lifecycle (the reference's model_abstraction.py:4-37 names)
    # ------------------------------------------------------------------
    def on_train_finished(self, step: int) -> None:
        self.recorder.record_loss(self.loss_metric, step, comment="train-")
        self.loss_metric.reset()

    def validation_step(self, step: int) -> None:
        self.validate_image(step)

    def on_val_finished(self, step: int) -> None:
        if self.recorder is not None:
            self.recorder.record_metric([self.psnr_metric, self.ssim_metric], step,
                                        comment="val-")
        logger.info("val @%d: %s %s", step, self.psnr_metric, self.ssim_metric)
        self.psnr_metric.reset()
        self.ssim_metric.reset()

    def testing_step(self, step: int, recon_res: int = 512):
        """Mesh extraction entry (NeuS_Trainer.testing_step:321-322)."""
        return self.validate_mesh(step, resolution=recon_res)

    # ------------------------------------------------------------------
    def validate_image(self, step: int):
        """Render one view picked by a generator seeded from the seed and
        the step, dump the [GT | render | depth] strip and feed PSNR / SSIM
        (NeuS_Trainer.validate_image 216-277). Returns (cam_id, rgb, depth)."""
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed * 1_000_003 + 0xA11D + step)
        cam_id = int(torch.randint(0, self.n_imgs, (1,), generator=g, device=self.device))
        rgb, depth = TR.render_image(self.state.params, self.scene, self.tcfg, cam_id,
                                     self.H, self.W, g)
        gt = self.images[cam_id].cpu().numpy()
        if self.recorder is not None:
            strip = np.hstack([(gt * 255).astype(np.uint8),
                               (np.clip(rgb, 0, 1) * 255).astype(np.uint8),
                               depth_colormap(depth)])
            write_png(os.path.join(self.recorder.viz_image_dir, f"img_{step}.png"), strip)
        self.psnr_metric.feed(rgb, gt)
        self.ssim_metric.feed(rgb, gt)
        self.on_val_finished(step)
        return cam_id, rgb, depth

    def validate_mesh(self, step: int, resolution: int = 64, threshold: float = 0.0,
                      world_space: bool = True):
        """Extract the mesh and its vertex colours; write *_mesh.ply and
        *_color.ply when recording (NeuS_Trainer.validate_mesh 279-307).
        The extraction's timings land in self.last_mesh_stats."""
        params = self.state.params["renderer"]
        stats = {}
        t0 = time.perf_counter()
        verts, tris = mesh_ops.extract_geometry(params, self.tcfg.renderer, self.bbox_min,
                                                self.bbox_max, resolution, threshold,
                                                stats=stats)
        logger.info("mesh @%d: %d verts, %d tris", step, len(verts), len(tris))
        stats.update(n_verts=len(verts), n_tris=len(tris))
        self.last_mesh_stats = stats
        if len(verts) == 0:
            stats["total_s"] = time.perf_counter() - t0
            return None
        t1 = time.perf_counter()
        colors = mesh_ops.extract_vertex_colors(params, self.tcfg.renderer, verts)
        stats["colors_s"] = time.perf_counter() - t1
        verts_out = verts
        if world_space:
            verts_out = verts * self.scale_mats[0][0, 0] + self.scale_mats[0][:3, 3][None]
        if self.recorder is not None:
            mesh_ops.write_ply(os.path.join(self.recorder.mesh_dir, f"{step:08d}_mesh.ply"),
                               verts_out, tris)
            mesh_ops.write_ply(os.path.join(self.recorder.mesh_dir, f"{step:08d}_color.ply"),
                               verts_out, tris, colors)
        stats["total_s"] = time.perf_counter() - t0
        return verts_out, tris, colors
