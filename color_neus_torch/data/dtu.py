"""DTU dataset: port of color_neus_tpu/data/dtu.py (reference
lib/datasets/dtu.py): cameras_sphere.npz with world and scale projection
matrices, image/ and mask/ PNGs, images multiplied by their mask."""

from __future__ import annotations

import os

import numpy as np

from color_neus_torch.data.base import BaseDataset, list_image_dir, sphere_npz_cameras
from color_neus_torch.data.image_io import imread_mask, imread_rgb
from color_neus_torch.utils.logger import logger
from color_neus_torch.utils.misc import CONST
from color_neus_torch.utils.registry import DATASET

@DATASET.register_module("DTU")
class DTU(BaseDataset):
    name = "DTU"

    def scene_dir(self, cfg: dict) -> str:
        return os.path.join(cfg["DATA_ROOT"], "DTU", f"dtu_scan{cfg['OBJ_ID']}")

    def __init__(self, cfg: dict):
        preset = cfg.get("DATA_PRESET", {})
        self.fx_only = preset.get("FX_ONLY", False)
        self.include_mask = preset.get("INCLUDE_MASK", True)
        self.opengl = preset.get("OPENGL_SYS", False)

        data_path = self.scene_dir(cfg)
        self.image_paths = list_image_dir(os.path.join(data_path, "image"))
        self.mask_paths = list_image_dir(os.path.join(data_path, "mask"))
        self.n_imgs = len(self.image_paths)

        intr, poses, scale_mats, bb_min, bb_max = sphere_npz_cameras(
            os.path.join(data_path, "cameras_sphere.npz"), self.n_imgs)
        if self.opengl:
            poses = CONST.PYRENDER_EXTRINSIC[None] @ poses
        self.poses = poses
        self.scale_mats = scale_mats
        self.object_bbox_min = bb_min
        self.object_bbox_max = bb_max
        if self.fx_only:
            self.focal = np.array([intr[0][0, 0]], np.float32)
        else:
            self.focal = np.array([intr[0][0, 0], intr[0][1, 1]], np.float32)
        self.origin = np.zeros(3, np.float32)
        self.radius = 1.0
        logger.info("%s: %s, %d images, include_mask=%s", self.name,
                    os.path.basename(data_path), self.n_imgs, self.include_mask)

    def get_image(self, idx: int):
        img = imread_rgb(self.image_paths[idx])
        mask = imread_mask(self.mask_paths[idx])
        img = img * mask[..., None]  # masks are applied to images (dtu.py:113)
        return img, mask
