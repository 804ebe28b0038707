"""The port's real-format dataset readers against the JAX package's, on
the CPU.

Each family (DTU, BlendedMVS, IHO_VIDEO with COLMAP, OmniObject3D) is
written to disk twice: random images written by cv2 (as
tests/test_datasets_on_disk.py does) and the blob scene written by the
port's tools/dataset_replica.py. The port's reader and the JAX one read
the same files; their init_data() (poses, focal, origin, radius, scale
mats, bbox) and load_all() (images, masks) must be equal bitwise, with
the port reading its images through cv2 or through its own PNG decoder
(the card's host has no cv2). Also: the PNG decoder against cv2 on
cv2-written files (bitwise) and on every filter type, the COLMAP readers
and writers across the packages, load_K_Rt_from_P on random projections
(atol 1e-5), the replica's torch render against data/synthetic.py's numpy
one, and a few TrainLoop steps on every replica."""

import os

import cv2
import numpy as np
import pytest
import torch

import color_neus_tpu.data  # noqa: F401 (registers the JAX readers)
from color_neus_tpu.data import colmap as jcolmap
from color_neus_tpu.data.base import create_dataset as jax_create_dataset
from color_neus_tpu.data.synthetic import _render_blob
from color_neus_tpu.ops.transforms import load_K_Rt_from_P as jax_load_K_Rt_from_P
from color_neus_tpu.ops.transforms import rotmat_to_quat as jax_rotmat_to_quat

from color_neus_torch import pin_precision
from color_neus_torch.data import colmap, image_io
from color_neus_torch.data.base import create_dataset
from color_neus_torch.ops.transforms import load_K_Rt_from_P, rotmat_to_quat
from color_neus_torch.runtime import TrainLoop
from color_neus_torch.tools import dataset_replica as DR
from color_neus_torch.utils.config import config_from_dict

torch.set_num_threads(1)
pin_precision()

H, W, N = 16, 16, 3
OBJ = {"DTU": "7", "BlendedMVS": "bear", "IHO_VIDEO": "bear", "OmniObject3D": "doll_002"}
PRESETS = {"default": {}, "fx_only-opengl": {"FX_ONLY": True, "OPENGL_SYS": True}}


def cv2_writer(path, img):
    """The replica's image writer through cv2 (which wants BGR(A))."""
    if img.ndim == 3:
        img = np.concatenate([img[:, :, 2::-1], img[:, :, 3:]], axis=2)
    assert cv2.imwrite(path, img)


def _random_scene(rng):
    """Random images with a square mask, the cameras of the blob scene."""
    rgb = (rng.rand(N, H, W, 3) * 255).astype(np.uint8)
    mask = np.zeros((N, H, W), np.uint8)
    mask[:, 4:12, 3:13] = 255
    pts = rng.randn(60, 3) * 0.3
    return DR.camera_poses(N), rgb, mask, pts


def _write(fmt, root, source):
    """One replica of `fmt` under root; returns what was written."""
    if source == "replica":
        return DR.write_replica(root, fmt, N, H, W, OBJ[fmt], "cpu")
    poses, rgb, mask, pts = _random_scene(np.random.RandomState(0))
    focal = (20.0, 21.0)
    if fmt in ("DTU", "BlendedMVS"):
        DR.write_dtu(root, OBJ[fmt], poses, rgb, mask, focal, family=fmt, writer=cv2_writer)
    elif fmt == "IHO_VIDEO":
        DR.write_iho(root, OBJ[fmt], poses, rgb, mask, focal, pts, writer=cv2_writer)
    else:
        DR.write_omniobject3d(root, OBJ[fmt], poses, rgb, mask, focal, writer=cv2_writer)
    return {"poses": poses, "focal": np.asarray(focal, np.float32), "rgb": rgb, "mask": mask}


def _ds_cfg(fmt, root, **extra):
    return {"TYPE": fmt, "DATA_ROOT": root, "OBJ_ID": OBJ[fmt], **extra}


def _assert_same(port, ref):
    pi, ji = port.init_data(), ref.init_data()
    assert pi.keys() == ji.keys()
    for k in ji:
        np.testing.assert_array_equal(pi[k], ji[k], err_msg=k)
        assert np.asarray(pi[k]).dtype == np.asarray(ji[k]).dtype, k
    pl, jl = port.load_all(), ref.load_all()
    assert pl.keys() == jl.keys()
    for k in jl:
        if jl[k] is None:
            assert pl[k] is None, k
        else:
            np.testing.assert_array_equal(pl[k], jl[k], err_msg=k)
            assert pl[k].dtype == jl[k].dtype, k
    return pi, pl


@pytest.mark.parametrize("preset", list(PRESETS))
@pytest.mark.parametrize("decoder", ["cv2", "own"])
@pytest.mark.parametrize("source", ["cv2", "replica"])
@pytest.mark.parametrize("fmt", DR.FORMATS)
def test_reader_matches_jax(fmt, source, decoder, preset, tmp_path, monkeypatch):
    root = str(tmp_path)
    written = _write(fmt, root, source)
    if decoder == "own":
        monkeypatch.setattr(image_io, "_cv2", lambda: None)
    include_mask = fmt != "OmniObject3D" or preset == "default"
    dp = {"INCLUDE_MASK": include_mask, **PRESETS[preset]}
    init, loaded = _assert_same(create_dataset(_ds_cfg(fmt, root), dp),
                                jax_create_dataset(_ds_cfg(fmt, root), dp))
    # and both read back what was written
    poses = written["poses"]
    if preset != "default":
        poses = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)[None] @ poses
    if fmt != "IHO_VIDEO":   # IHO's poses stay in the COLMAP frame; origin/radius scale
        np.testing.assert_allclose(init["poses"], poses, atol=1e-4)
    focal = written["focal"]
    want_focal = (focal if preset == "default" else
                  focal[:1] if fmt != "IHO_VIDEO" else focal.mean(keepdims=True))
    if fmt == "OmniObject3D":
        want_focal = np.full_like(want_focal, focal[0])
    np.testing.assert_allclose(init["focal"], want_focal, rtol=1e-5)
    rgb = written["rgb"].astype(np.float32) / 255.0
    mask = written["mask"].astype(np.float32) / 255.0
    if fmt in ("DTU", "BlendedMVS"):
        rgb = rgb * mask[..., None]
    np.testing.assert_array_equal(loaded["images"], rgb)
    if include_mask:
        np.testing.assert_array_equal(loaded["masks"], mask)


@pytest.mark.parametrize("legacy", [True, False])
def test_iho_radius_matches_jax(legacy, tmp_path):
    root = str(tmp_path)
    _write("IHO_VIDEO", root, "cv2")
    cfg = _ds_cfg("IHO_VIDEO", root, LEGACY_RADIUS=legacy, RADIUS_RATIO=1.3)
    port = create_dataset(cfg, {"INCLUDE_MASK": True})
    ref = jax_create_dataset(cfg, {"INCLUDE_MASK": True})
    assert port.radius == ref.radius and np.array_equal(port.origin, ref.origin)
    _assert_same(port, ref)
    other = create_dataset(_ds_cfg("IHO_VIDEO", root, LEGACY_RADIUS=not legacy,
                                   RADIUS_RATIO=1.3), {"INCLUDE_MASK": True})
    assert other.radius != port.radius


def test_dtu_world_frame_round_trip(tmp_path):
    """The replica's cameras_sphere.npz holds DTU's world frame: scale mats
    that map the unit sphere onto the object, a bbox that maps back to it."""
    r = DR.write_replica(str(tmp_path), "DTU", N, H, W, "5", "cpu")
    ds = create_dataset(_ds_cfg("DTU", str(tmp_path)) | {"OBJ_ID": "5"}, {})
    init = ds.init_data()
    S = init["scale_mats_np"][0]
    np.testing.assert_allclose(S[:3, :3], DR.DTU_SCALE * np.eye(3), rtol=1e-6)
    np.testing.assert_allclose(S[:3, 3], DR.DTU_CENTRE, rtol=1e-6)
    np.testing.assert_allclose(init["object_bbox_min"], [-1.01] * 3, atol=1e-5)
    np.testing.assert_allclose(init["object_bbox_max"], [1.01] * 3, atol=1e-5)
    np.testing.assert_allclose(init["poses"], r["poses"], atol=1e-4)
    np.testing.assert_allclose(init["focal"], r["focal"], rtol=1e-5)


@pytest.mark.parametrize("shape", [(37, 53), (37, 53, 3), (37, 53, 4)],
                         ids=["grey", "rgb", "rgba"])
def test_png_decoder_matches_cv2(shape, tmp_path):
    rng = np.random.RandomState(1)
    img = (rng.rand(*shape) * 255).astype(np.uint8)
    img[:, :20] = 7    # a flat part, so libpng's filter choice varies
    path = str(tmp_path / "x.png")
    assert cv2.imwrite(path, img)
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    mine = image_io.read_png(path)
    assert mine.dtype == np.uint8
    if len(shape) == 3:    # the file holds RGB(A), cv2 gives BGR(A)
        mine = np.concatenate([mine[:, :, 2::-1], mine[:, :, 3:]], axis=2)
    np.testing.assert_array_equal(mine, ref)
    np.testing.assert_array_equal(mine, img)


@pytest.mark.parametrize("filter_type", range(5))
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_every_filter_type(filter_type, channels, tmp_path):
    """write_png with each PNG filter; the decoder and cv2 read it back."""
    rng = np.random.RandomState(filter_type * 7 + channels)
    img = (rng.rand(23, 31, channels) * 255).astype(np.uint8)
    img = img[..., 0] if channels == 1 else img
    path = str(tmp_path / "f.png")
    image_io.write_png(path, img, filter_type)
    np.testing.assert_array_equal(image_io.read_png(path), img)
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if channels > 1:
        ref = np.concatenate([ref[:, :, 2::-1], ref[:, :, 3:]], axis=2)
    np.testing.assert_array_equal(ref, img)


def test_mask_and_rgb_readers_without_cv2(tmp_path, monkeypatch):
    """The readers' own path equals their cv2 path: a colour mask goes
    through libpng's rgb-to-grey, a grey image becomes RGB."""
    rng = np.random.RandomState(3)
    files = {}
    for name, shape in (("grey", (20, 24)), ("rgb", (20, 24, 3)), ("rgba", (20, 24, 4))):
        files[name] = str(tmp_path / f"{name}.png")
        assert cv2.imwrite(files[name], (rng.rand(*shape) * 255).astype(np.uint8))
    with_cv2 = {n: (image_io.imread_mask(p), image_io.imread_rgba(p)) for n, p in files.items()}
    monkeypatch.setattr(image_io, "_cv2", lambda: None)
    for n, p in files.items():
        mask, (rgb, alpha) = image_io.imread_mask(p), image_io.imread_rgba(p)
        np.testing.assert_array_equal(mask, with_cv2[n][0], err_msg=n)
        np.testing.assert_array_equal(rgb, with_cv2[n][1][0], err_msg=n)
        assert (alpha is None) == (with_cv2[n][1][1] is None)
        if alpha is not None:
            np.testing.assert_array_equal(alpha, with_cv2[n][1][1])
        np.testing.assert_array_equal(image_io.imread_rgb(p), rgb)
    # the JAX package's reader on the colour files
    from color_neus_tpu.data.base import imread_mask as jax_imread_mask
    from color_neus_tpu.data.base import imread_rgb as jax_imread_rgb
    for n in ("rgb", "rgba"):
        np.testing.assert_array_equal(image_io.imread_mask(files[n]), jax_imread_mask(files[n]))
        np.testing.assert_array_equal(image_io.imread_rgb(files[n]), jax_imread_rgb(files[n]))


def test_png_decoder_refuses_other_files(tmp_path, monkeypatch):
    monkeypatch.setattr(image_io, "_cv2", lambda: None)
    deep = str(tmp_path / "deep.png")
    assert cv2.imwrite(deep, (np.arange(64, dtype=np.uint16) * 1000).reshape(8, 8))
    jpg = str(tmp_path / "x.jpg")
    assert cv2.imwrite(jpg, np.zeros((8, 8, 3), np.uint8))
    for path, what in ((deep, "bit depth 16"), (jpg, "not a PNG")):
        with pytest.raises(ValueError, match=what) as e:
            image_io.imread_rgb(path)
        assert path in str(e.value) and "cv2" in str(e.value)
    with pytest.raises(FileNotFoundError):
        image_io.imread_mask(str(tmp_path / "missing.png"))


def _rotation(rng):
    q, _ = np.linalg.qr(rng.randn(3, 3))
    return q * np.sign(np.linalg.det(q))


def test_colmap_round_trip_across_packages(tmp_path):
    rng = np.random.RandomState(4)
    cams = {1: colmap.Camera(1, "PINHOLE", 64, 48, np.array([50.0, 51.0, 32.0, 24.0])),
            2: colmap.Camera(2, "SIMPLE_RADIAL", 64, 48, np.array([50.0, 32.0, 24.0, 0.01]))}
    ims = {i: colmap.ColmapImage(i, rotmat_to_quat(_rotation(rng)), rng.randn(3), 1,
                                 f"img_{i}.png") for i in (1, 2, 5)}
    pts = {j: colmap.Point3D(j, rng.randn(3), rng.randint(0, 255, 3).astype(np.uint8),
                             float(rng.rand())) for j in range(1, 30)}
    for writer, reader in ((colmap, jcolmap), (jcolmap, colmap)):
        d = tmp_path / writer.__name__.split(".")[0]
        d.mkdir()
        writer.write_cameras_binary(cams, str(d / "cameras.bin"))
        writer.write_images_binary(ims, str(d / "images.bin"))
        writer.write_points3d_binary(pts, str(d / "points3D.bin"))
        for name, want in (("cameras", cams), ("images", ims), ("points3d", pts)):
            got = getattr(reader, f"read_{name}_binary")(str(d / f"{name.replace('3d', '3D')}.bin"))
            assert sorted(got) == sorted(want)
            for k in want:
                for field, v in vars(want[k]).items():
                    np.testing.assert_array_equal(getattr(got[k], field), v, err_msg=field)
    for k, im in ims.items():
        np.testing.assert_array_equal(im.qvec2rotmat(), jcolmap.ColmapImage(
            *vars(im).values()).qvec2rotmat())
    # the text format, read by both packages
    (tmp_path / "cameras.txt").write_text(
        "# Camera list\n1 PINHOLE 64 48 50.0 51.0 32.0 24.0\n")
    (tmp_path / "images.txt").write_text(
        "# Image list\n1 0.9 0.1 0.2 0.3 1.0 2.0 3.0 1 a.png\n10.0 20.0 -1\n"
        "2 1.0 0.0 0.0 0.0 0.5 0.5 0.5 1 b.png\n\n")
    (tmp_path / "points3D.txt").write_text("# pts\n1 0.1 0.2 0.3 10 20 30 0.5 1 0\n"
                                           "7 1.5 2.5 3.5 1 2 3 0.25\n")
    for name in ("cameras", "images", "points3D"):
        path = str(tmp_path / f"{name}.txt")
        got = getattr(colmap, f"read_{name.lower()}_text")(path)
        want = getattr(jcolmap, f"read_{name.lower()}_text")(path)
        assert sorted(got) == sorted(want) and len(got) == 2 - (name == "cameras")
        for k in want:
            for field, v in vars(want[k]).items():
                np.testing.assert_array_equal(getattr(got[k], field), v, err_msg=field)


def test_load_K_Rt_from_P_matches_jax():
    rng = np.random.RandomState(5)
    for _ in range(20):
        Rq = _rotation(rng)
        K = np.array([[rng.uniform(20, 3000), rng.uniform(-2, 2), rng.uniform(10, 900)],
                      [0, rng.uniform(20, 3000), rng.uniform(10, 700)], [0, 0, 1]])
        c = rng.randn(3) * 3
        P = rng.uniform(0.5, 300) * K @ np.concatenate([Rq.T, -Rq.T @ c[:, None]], axis=1)
        intr, pose = load_K_Rt_from_P(P)
        jintr, jpose = jax_load_K_Rt_from_P(P)
        np.testing.assert_allclose(intr, jintr, atol=1e-5, rtol=0)
        np.testing.assert_allclose(pose, jpose, atol=1e-5, rtol=0)
        np.testing.assert_allclose(intr[:3, :3], K, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(pose[:3, :3], Rq, atol=1e-5)
        np.testing.assert_allclose(pose[:3, 3], c, atol=1e-5)
        np.testing.assert_allclose(rotmat_to_quat(Rq), jax_rotmat_to_quat(Rq), atol=1e-12)


def test_replica_render_matches_synthetic():
    """The replica's torch render of the blob is data/synthetic.py's."""
    poses = DR.camera_poses(3)
    focal = np.array([1.2 * 24, 1.1 * 24], np.float32)
    for c2w in poses:
        rgb8, mask8, pts = DR.render_blob(c2w, focal, 20, 24, "cpu")
        rgb, mask = _render_blob(c2w, focal, 20, 24)
        agree = mask8 == (mask * 255).astype(np.uint8)
        assert agree.mean() >= 0.99 and mask.sum() > 20
        np.testing.assert_allclose(rgb8[agree].astype(np.float32),
                                   np.clip(rgb[agree], 0, 1) * 255, atol=1.01)
        assert pts.shape == (int((mask8 > 0).sum()), 3)


TRAIN_CFG = {
    "MODEL": {"N_RAYS": 32, "RENDERER": {
        "TYPE": "Color_NeuS", "N_SAMPLES": 8, "N_IMPORTANCE": 8, "UP_SAMPLE_STEPS": 2,
        "SDF": {"D_HIDDEN": 32, "N_LAYERS": 2, "SKIP_IN": [], "MULTIRES": 2},
        "COLOR": {"MODE": "no_view_dir", "D_IN": 6, "D_HIDDEN": 32, "N_LAYERS": 1,
                  "MULTIRES_VIEW": 0},
        "RELIGHT": {"D_HIDDEN": 16}},
        "LOSS": {"LAMBDA_MASK": 0.1}},
    "TRAIN": {"BATCH_SIZE": 2, "ITERATIONS": 2, "LOG_INTERVAL": 1, "SAVE_INTERVAL": 2,
              "OPTIMIZE": {"WARM_UP": 1}, "GRAD_CLIP": {"NORM": 1.0}},
}


@pytest.mark.parametrize("fmt", DR.FORMATS)
def test_train_loop_on_replica(fmt, tmp_path, monkeypatch):
    """A few TrainLoop steps on each replica, read without cv2; with the
    IHO config's learnt focal and poses on its replica."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(image_io, "_cv2", lambda: None)
    DR.write_replica(str(tmp_path / "data"), fmt, N, H, W, OBJ[fmt], "cpu")
    learn = fmt == "IHO_VIDEO"
    cfg = config_from_dict({**TRAIN_CFG, "DATASET": _ds_cfg(fmt, str(tmp_path / "data")),
                            "DATA_PRESET": {"INCLUDE_MASK": True},
                            "MODEL": {**TRAIN_CFG["MODEL"], "LEARN_FOCAL": learn,
                                      "LEARN_R": learn, "LEARN_T": learn}})
    loop = TrainLoop(cfg, device="cpu", exp_id="default")
    before = {k: p.detach().clone() for k, p in loop.state.params.named_parameters()}
    losses = loop.run()
    assert loop.state.step == 2 and torch.isfinite(losses).all()
    assert os.path.isfile(loop.recorder.ckpt_path())
    moved = {k for k, p in loop.state.params.named_parameters()
             if not torch.equal(p.detach(), before[k])}
    assert ({"focal.fx", "focal.fy", "pose.r", "pose.t"} <= moved) == learn
    with open(os.path.join(loop.recorder.exp_path, "dump_cfg.yaml")) as f:
        assert fmt in f.read()
