"""OmniObject3D dataset: port of color_neus_tpu/data/omniobject3d.py
(reference lib/datasets/omniobject3d.py): Blender transforms.json, the
focal from camera_angle_x, the pose's y / z columns flipped."""

from __future__ import annotations

import json
import os

import numpy as np

from color_neus_torch.data.base import BaseDataset
from color_neus_torch.data.image_io import imread_rgba, imread_unchanged
from color_neus_torch.utils.logger import logger
from color_neus_torch.utils.misc import CONST
from color_neus_torch.utils.registry import DATASET


@DATASET.register_module("OmniObject3D")
class OmniObject3D(BaseDataset):
    name = "OmniObject3D"

    def __init__(self, cfg: dict):
        preset = cfg.get("DATA_PRESET", {})
        self.fx_only = preset.get("FX_ONLY", False)
        self.include_mask = preset.get("INCLUDE_MASK", True)
        self.opengl = preset.get("OPENGL_SYS", False)

        obj_info = cfg["OBJ_ID"]           # e.g. doll_002 -> class doll, id 002
        data_path = os.path.join(cfg["DATA_ROOT"], "OmniObject3D/blender_renders",
                                 obj_info[:-4], obj_info, "render")
        with open(os.path.join(data_path, "transforms.json")) as f:
            meta = json.load(f)

        self.image_paths, poses = [], []
        for frame in meta["frames"]:
            self.image_paths.append(os.path.join(
                data_path, "images", frame["file_path"].split("/")[-1] + ".png"))
            pose = np.array(frame["transform_matrix"], np.float32)
            pose[:, 1:3] *= -1  # Blender (OpenGL) -> the z-forward camera convention
            if self.opengl:
                pose = CONST.PYRENDER_EXTRINSIC @ pose
            poses.append(pose)
        self.poses = np.stack(poses)
        self.n_imgs = len(self.image_paths)

        W = imread_unchanged(self.image_paths[0]).shape[1]
        focal = 0.5 * W / np.tan(0.5 * float(meta["camera_angle_x"]))
        self.focal = (np.array([focal], np.float32) if self.fx_only
                      else np.array([focal, focal], np.float32))

        self.origin = np.zeros(3, np.float32)
        self.radius = 1.0
        self.scale_mats = np.tile(np.eye(4, dtype=np.float32), (self.n_imgs, 1, 1))
        self.object_bbox_min = np.array([-1.01, -1.01, -1.01], np.float32)
        self.object_bbox_max = np.array([1.01, 1.01, 1.01], np.float32)
        logger.info("OmniObject3D: %s, %d images, include_mask=%s",
                    obj_info, self.n_imgs, self.include_mask)

    def get_image(self, idx: int):
        img, alpha = imread_rgba(self.image_paths[idx])
        return img, alpha if self.include_mask else None
