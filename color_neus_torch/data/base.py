"""Dataset protocol shared by all loaders (copy of color_neus_tpu/data/base.py).

Host-side numpy; the train loop moves the full image and mask stacks to
the device once. The on-disk image readers come with the datasets that
need them (DTU, BlendedMVS, ...), in a later slice of the port.
"""

from __future__ import annotations

import numpy as np

from color_neus_torch.utils.logger import logger
from color_neus_torch.utils.registry import DATASET


class BaseDataset:
    """Subclasses set: poses [N,4,4], focal [1|2], origin [3], radius (),
    scale_mats [N,4,4], object_bbox_min/max [3], include_mask; and
    implement get_image(idx) -> (rgb [H,W,3], mask [H,W] or None)."""

    name = "base"

    n_imgs: int
    poses: np.ndarray
    focal: np.ndarray
    origin: np.ndarray
    radius: float
    scale_mats: np.ndarray
    object_bbox_min: np.ndarray
    object_bbox_max: np.ndarray
    include_mask: bool = True

    def __len__(self):
        return self.n_imgs

    def get_image(self, idx: int):
        raise NotImplementedError

    def init_data(self) -> dict:
        img0, _ = self.get_image(0)
        return {
            "poses": np.asarray(self.poses, np.float32),
            "focal": np.asarray(self.focal, np.float32),
            "H": img0.shape[0],
            "W": img0.shape[1],
            "n_imgs": self.n_imgs,
            "origin": np.asarray(self.origin, np.float32),
            "radius": np.float32(self.radius),
            "scale_mats_np": np.asarray(self.scale_mats, np.float32),
            "object_bbox_min": np.asarray(self.object_bbox_min, np.float32),
            "object_bbox_max": np.asarray(self.object_bbox_max, np.float32),
        }

    def load_all(self) -> dict:
        logger.info("%s: loading all %d images ...", self.name, self.n_imgs)
        imgs, masks = [], []
        for i in range(self.n_imgs):
            img, mask = self.get_image(i)
            imgs.append(img)
            if self.include_mask:
                masks.append(mask)
        return {
            "images": np.stack(imgs, axis=0),
            "masks": np.stack(masks, axis=0) if self.include_mask else None,
            "img_ids": np.arange(self.n_imgs, dtype=np.int32),
        }


def create_dataset(dataset_cfg: dict, data_preset: dict) -> BaseDataset:
    """Registry-driven dataset build (lib/datasets/__init__.py:10-14)."""
    from color_neus_torch.data import synthetic  # noqa: F401 (registration)
    cfg = dict(dataset_cfg)
    cfg["DATA_PRESET"] = dict(data_preset or {})
    return DATASET.get(cfg["TYPE"])(cfg)
