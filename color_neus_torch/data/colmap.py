"""COLMAP model files: port of color_neus_tpu/data/colmap.py.

The binary readers (cameras.bin / images.bin / points3D.bin), the binary
writers and the text readers, from the public COLMAP format
specification (colmap/src/base/reconstruction.cc Write*Binary); the
capability of the reference's lib/utils/read_cameras.py. Host numpy and
struct only.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np


CAMERA_MODEL_NUM_PARAMS = {
    0: 3,   # SIMPLE_PINHOLE
    1: 4,   # PINHOLE
    2: 4,   # SIMPLE_RADIAL
    3: 5,   # RADIAL
    4: 8,   # OPENCV
    5: 8,   # OPENCV_FISHEYE
    6: 12,  # FULL_OPENCV
    7: 5,   # FOV
    8: 4,   # SIMPLE_RADIAL_FISHEYE
    9: 5,   # RADIAL_FISHEYE
    10: 12,  # THIN_PRISM_FISHEYE
}

CAMERA_MODEL_NAMES = {
    0: "SIMPLE_PINHOLE", 1: "PINHOLE", 2: "SIMPLE_RADIAL", 3: "RADIAL",
    4: "OPENCV", 5: "OPENCV_FISHEYE", 6: "FULL_OPENCV", 7: "FOV",
    8: "SIMPLE_RADIAL_FISHEYE", 9: "RADIAL_FISHEYE", 10: "THIN_PRISM_FISHEYE",
}


@dataclass
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray  # (w, x, y, z)
    tvec: np.ndarray
    camera_id: int
    name: str

    def qvec2rotmat(self) -> np.ndarray:
        w, x, y, z = self.qvec
        return np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ])


@dataclass
class Point3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float


def _read(fid, fmt: str):
    size = struct.calcsize("<" + fmt)  # "<" also disables native alignment
    return struct.unpack("<" + fmt, fid.read(size))


def read_cameras_binary(path: str) -> dict:
    cameras = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(f, "iiQQ")
            num_params = CAMERA_MODEL_NUM_PARAMS[model_id]
            params = np.array(_read(f, "d" * num_params))
            cameras[cam_id] = Camera(cam_id, CAMERA_MODEL_NAMES[model_id],
                                     int(width), int(height), params)
    return cameras


def read_images_binary(path: str) -> dict:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        for _ in range(n):
            vals = _read(f, "idddddddi")
            image_id = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            camera_id = vals[8]
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            (num_pts,) = _read(f, "Q")
            f.seek(24 * num_pts, 1)  # skip (x, y, point3D_id) tracks
            images[image_id] = ColmapImage(image_id, qvec, tvec, camera_id,
                                           name.decode("utf-8"))
    return images


def read_points3d_binary(path: str) -> dict:
    points = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        for _ in range(n):
            pid, x, y, z, r, g, b, err = _read(f, "QdddBBBd")
            (track_len,) = _read(f, "Q")
            f.seek(8 * track_len, 1)  # skip (image_id, point2D_idx) pairs
            points[pid] = Point3D(pid, np.array([x, y, z]),
                                  np.array([r, g, b], np.uint8), err)
    return points


# ---------------------------------------------------------------------------
# Writers (for tests and tooling)
# ---------------------------------------------------------------------------

def write_cameras_binary(cameras: dict, path: str):
    model_ids = {v: k for k, v in CAMERA_MODEL_NAMES.items()}
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            mid = model_ids[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, mid, cam.width, cam.height))
            f.write(struct.pack("<" + "d" * len(cam.params), *cam.params))


def write_images_binary(images: dict, path: str):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<idddddddi", im.id, *im.qvec, *im.tvec, im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", 0))


def write_points3d_binary(points: dict, path: str):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for p in points.values():
            f.write(struct.pack("<QdddBBBd", p.id, *p.xyz, *[int(v) for v in p.rgb], p.error))
            f.write(struct.pack("<Q", 0))


# ---------------------------------------------------------------------------
# Text-format readers (COLMAP's alternative on-disk format)
# ---------------------------------------------------------------------------

def read_cameras_text(path: str) -> dict:
    cameras = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam_id = int(parts[0])
            cameras[cam_id] = Camera(cam_id, parts[1], int(parts[2]), int(parts[3]),
                                     np.array([float(p) for p in parts[4:]]))
    return cameras


def read_images_text(path: str) -> dict:
    images = {}
    with open(path) as f:
        lines = [l.strip() for l in f if l.strip() and not l.strip().startswith("#")]
    # two lines per image: header, then 2D points (ignored)
    for header in lines[0::2]:
        p = header.split()
        images[int(p[0])] = ColmapImage(
            int(p[0]), np.array([float(x) for x in p[1:5]]),
            np.array([float(x) for x in p[5:8]]), int(p[8]), p[9])
    return images


def read_points3d_text(path: str) -> dict:
    points = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            p = line.split()
            points[int(p[0])] = Point3D(
                int(p[0]), np.array([float(x) for x in p[1:4]]),
                np.array([int(x) for x in p[4:7]], np.uint8), float(p[7]))
    return points
