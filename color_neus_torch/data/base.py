"""Dataset protocol shared by all loaders (copy of color_neus_tpu/data/base.py).

Host-side numpy; the train loop moves the full image and mask stacks to
the device once. The image files are read by data/image_io.py.
"""

from __future__ import annotations

import os

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
    """Registry-driven dataset build (lib/datasets/__init__.py:10-14) over
    the five families: DTU, BlendedMVS, IHO_VIDEO, OmniObject3D, Synthetic."""
    import color_neus_torch.data  # noqa: F401 (registers the five families)
    cfg = dict(dataset_cfg)
    cfg["DATA_PRESET"] = dict(data_preset or {})
    return DATASET.get(cfg["TYPE"])(cfg)


def sphere_npz_cameras(camera_path: str, n_imgs: int):
    """The cameras_sphere.npz of DTU and BlendedMVS (dtu.py:59-91):
    P = world_mat @ scale_mat, decomposed to K and the unit-sphere c2w;
    the bbox mapped through inv(scale_mat_0) @ object_scale_mat. Returns
    (intrinsics [N,4,4], poses [N,4,4], scale_mats [N,4,4], bbox min, max)."""
    from color_neus_torch.ops.transforms import load_K_Rt_from_P

    cam = np.load(camera_path)
    world_mats = [cam[f"world_mat_{i}"].astype(np.float32) for i in range(n_imgs)]
    scale_mats = [cam[f"scale_mat_{i}"].astype(np.float32) for i in range(n_imgs)]
    intrinsics, poses = [], []
    for world_mat, scale_mat in zip(world_mats, scale_mats):
        K, pose = load_K_Rt_from_P((world_mat @ scale_mat)[:3, :4])
        intrinsics.append(K)
        poses.append(pose)
    object_scale_mat = cam["scale_mat_0"]
    bb_min = np.array([-1.01, -1.01, -1.01, 1.0])
    bb_max = np.array([1.01, 1.01, 1.01, 1.0])
    bb_min = np.linalg.inv(scale_mats[0]) @ object_scale_mat @ bb_min[:, None]
    bb_max = np.linalg.inv(scale_mats[0]) @ object_scale_mat @ bb_max[:, None]
    return (np.stack(intrinsics), np.stack(poses), np.stack(scale_mats),
            bb_min[:3, 0], bb_max[:3, 0])


def list_image_dir(d: str):
    return [os.path.join(d, f) for f in sorted(os.listdir(d))]
