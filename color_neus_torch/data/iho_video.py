"""IHO-Video dataset: port of color_neus_tpu/data/iho_video.py (reference
lib/datasets/iho_video.py): a COLMAP reconstruction; the scene's origin
and radius from the SfM points; RGBA images whose alpha is the mask."""

from __future__ import annotations

import os

import numpy as np

from color_neus_torch.data import colmap
from color_neus_torch.data.base import BaseDataset
from color_neus_torch.data.image_io import imread_rgba
from color_neus_torch.ops.transforms import load_K_Rt_from_P
from color_neus_torch.utils.logger import logger
from color_neus_torch.utils.misc import CONST
from color_neus_torch.utils.registry import DATASET


@DATASET.register_module("IHO_VIDEO")
class IHOVideo(BaseDataset):
    name = "IHO_VIDEO"

    def __init__(self, cfg: dict):
        preset = cfg.get("DATA_PRESET", {})
        self.fx_only = preset.get("FX_ONLY", False)
        self.include_mask = preset.get("INCLUDE_MASK", False)
        self.opengl = preset.get("OPENGL_SYS", False)
        radius_ratio = cfg.get("RADIUS_RATIO", 1.5)
        # the reference's radius formula bug for bug (iho_video.py:39, the
        # square of the SUM of signed deltas; SURVEY §3.6) unless False
        legacy_radius = cfg.get("LEGACY_RADIUS", True)

        data_path = os.path.join(cfg["DATA_ROOT"], "IHO_video", cfg["OBJ_ID"])
        img_dir = os.path.join(data_path, "obj")
        camdata = colmap.read_cameras_binary(os.path.join(data_path, "colmap/cameras.bin"))
        pts3d = colmap.read_points3d_binary(os.path.join(data_path, "colmap/points3D.bin"))
        imdata = colmap.read_images_binary(os.path.join(data_path, "colmap/images.bin"))

        xyz = np.stack([p.xyz for p in pts3d.values()])
        origin = xyz.mean(0)
        if legacy_radius:
            r = np.percentile(np.sqrt(np.sum(xyz - origin, axis=1) ** 2), 99.9)
        else:
            r = np.percentile(np.linalg.norm(xyz - origin, axis=1), 99.9)
        self.origin = origin.astype(np.float32)
        self.radius = float(r * radius_ratio)

        cam = camdata[1]
        K = np.array([[cam.params[0], 0, cam.params[2]],
                      [0, cam.params[1], cam.params[3]],
                      [0, 0, 1]])
        if self.fx_only:
            self.focal = np.array([(K[0, 0] + K[1, 1]) / 2], np.float32)
        else:
            self.focal = np.array([K[0, 0], K[1, 1]], np.float32)

        poses, self.image_paths = [], []
        for _, im in sorted(imdata.items()):
            Rt = np.concatenate([im.qvec2rotmat(), im.tvec.reshape(3, 1)], axis=1)  # w2c
            _, pose = load_K_Rt_from_P(K @ Rt)
            if self.opengl:
                pose = CONST.PYRENDER_EXTRINSIC @ pose
            poses.append(pose)
            self.image_paths.append(os.path.join(img_dir, im.name))
        self.poses = np.stack(poses)
        self.n_imgs = len(self.image_paths)

        self.scale_mats = np.tile(np.eye(4, dtype=np.float32), (self.n_imgs, 1, 1))
        self.object_bbox_min = np.array([-1.01, -1.01, -1.01], np.float32)
        self.object_bbox_max = np.array([1.01, 1.01, 1.01], np.float32)
        logger.info("IHO_VIDEO: %s, %d images, include_mask=%s",
                    cfg["OBJ_ID"], self.n_imgs, self.include_mask)

    def get_image(self, idx: int):
        return imread_rgba(self.image_paths[idx])
