"""Image files of the datasets: PNG reading and writing.

imread_rgb / imread_mask / imread_rgba have the semantics of the JAX
package's readers (color_neus_tpu/data/base.py:20-34, iho_video.py,
omniobject3d.py): RGB float32 in 0..1, a mask from a grey image or from
the alpha channel. cv2 reads the files where it is importable, as in the
JAX package; otherwise the port's own PNG decoder (numpy + zlib) does:
8-bit grey, RGB and RGBA, not interlaced, all five filter types. Every
dataset family ships PNG. Any other file raises a ValueError naming it
and what would read it.

write_png writes 8-bit grey, RGB or RGBA, every row with one filter
(0, None, unless asked).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}          # PNG colour type -> channels
_COLOUR_TYPE = {v: k for k, v in _CHANNELS.items()}
_OTHER_READER = "cv2 (OpenCV) reads it; the port's own decoder reads only 8-bit grey, " \
                "RGB and RGBA PNG, not interlaced"


def _cv2():
    """cv2 if importable, else None (the card's host has none)."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


# ---------------------------------------------------------------------------
# The port's PNG decoder
# ---------------------------------------------------------------------------

def _unfilter_average(line: np.ndarray, prior: np.ndarray, bpp: int) -> None:
    cur, up = bytearray(line.tobytes()), prior.tobytes()
    for i in range(bpp):
        cur[i] = (cur[i] + (up[i] >> 1)) & 255
    for i in range(bpp, len(cur)):
        cur[i] = (cur[i] + ((cur[i - bpp] + up[i]) >> 1)) & 255
    line[:] = np.frombuffer(bytes(cur), np.uint8)


def _unfilter_paeth(line: np.ndarray, prior: np.ndarray, bpp: int) -> None:
    cur, up = bytearray(line.tobytes()), prior.tobytes()
    for i in range(bpp):
        cur[i] = (cur[i] + up[i]) & 255        # a = c = 0: the predictor is b
    for i in range(bpp, len(cur)):
        a, b, c = cur[i - bpp], up[i], up[i - bpp]
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        cur[i] = (cur[i] + (a if pa <= pb and pa <= pc else b if pb <= pc else c)) & 255
    line[:] = np.frombuffer(bytes(cur), np.uint8)


def read_png(path: str) -> np.ndarray:
    """The pixels of an 8-bit grey / RGB / RGBA PNG as uint8 [H, W] or
    [H, W, C], channels in the file's (RGB) order."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file; {_OTHER_READER}")
    header, idat, pos = None, [], 8
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", data[pos + 8:pos + 21])
        elif tag == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + n])
        elif tag == b"IEND":
            break
        pos += 12 + n
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"{path}: PNG of bit depth {depth}, colour type {ctype}, interlace "
                         f"{interlace}; {_OTHER_READER}")
    bpp = _CHANNELS[ctype]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: {raw.size} bytes of pixel data, want {h * (stride + 1)}")
    rows = raw.reshape(h, stride + 1)
    filters = rows[:, 0]
    if int(filters.max(initial=0)) > 4:
        raise ValueError(f"{path}: PNG filter type {int(filters.max())} (0-4 exist)")
    out = rows[:, 1:].copy()
    zeros = np.zeros(stride, np.uint8)
    # rows in order; a row of filter 0 is already its pixels
    for y in np.flatnonzero(filters):
        f, line = filters[y], out[y]
        up = out[y - 1] if y > 0 else zeros
        if f == 1:      # Sub: a running sum along the row, per channel, mod 256
            line[:] = np.cumsum(line.reshape(w, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif f == 2:    # Up
            line += up
        elif f == 3:
            _unfilter_average(line, up, bpp)
        elif f == 4:
            _unfilter_paeth(line, up, bpp)
    return out.reshape(h, w) if bpp == 1 else out.reshape(h, w, bpp)


def _filter_rows(x: np.ndarray, bpp: int, filter_type: int) -> np.ndarray:
    """PNG filter `filter_type` applied to every row of x (uint8 [H, W*bpp])."""
    x = x.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    if filter_type == 4:
        c = np.zeros_like(x)
        c[1:, bpp:] = x[:-1, :-bpp]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    else:
        pred = (0, a, b, (a + b) >> 1)[filter_type]
    return ((x - pred) & 255).astype(np.uint8)


def write_png(path: str, img: np.ndarray, filter_type: int = 0) -> None:
    """An 8-bit grey [H, W] or RGB / RGBA [H, W, 3 | 4] image as PNG,
    every row with the PNG filter `filter_type` (0-4; zlib only, no image
    library)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, w * c)
    if filter_type:
        rows = _filter_rows(rows, c, filter_type)
    raw = np.concatenate([np.full((h, 1), filter_type, np.uint8), rows], axis=1)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(_SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, _COLOUR_TYPE[c], 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw.tobytes())) + chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# The readers the datasets call
# ---------------------------------------------------------------------------

def imread_unchanged(path: str) -> np.ndarray:
    """uint8 [H, W] or [H, W, 3 | 4] in RGB(A) order: cv2.imread's
    IMREAD_UNCHANGED with the colour channels put in RGB order."""
    cv2 = _cv2()
    if cv2 is None:
        return read_png(path)
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(path)
    if img.ndim == 3:
        img = np.concatenate([img[:, :, 2::-1], img[:, :, 3:]], axis=2)
    return img


def _rgb(img: np.ndarray) -> np.ndarray:
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    return img[:, :, :3].astype(np.float32) / 255.0


def imread_rgb(path: str) -> np.ndarray:
    """[H, W, 3] float32 in 0..1 (the reference's to_tensor + normalize
    round trip, dtu.py:104-107, is the identity); alpha is dropped."""
    return _rgb(imread_unchanged(path))


def imread_rgba(path: str):
    """(rgb [H, W, 3], alpha [H, W] or None), float32 in 0..1: the IHO and
    OmniObject3D images, whose alpha channel is the mask."""
    img = imread_unchanged(path)
    alpha = (img[:, :, 3].astype(np.float32) / 255.0
             if img.ndim == 3 and img.shape[2] == 4 else None)
    return _rgb(img), alpha


def imread_mask(path: str) -> np.ndarray:
    """[H, W] float32 in 0..1 from a mask image, read as cv2's
    IMREAD_GRAYSCALE reads it: a colour file through libpng's rgb-to-grey
    (0.299 / 0.587 fixed point, alpha ignored)."""
    cv2 = _cv2()
    if cv2 is not None:
        m = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if m is None:
            raise FileNotFoundError(path)
        return m.astype(np.float32) / 255.0
    m = read_png(path)
    if m.ndim == 3:
        r, g, b = (m[:, :, i].astype(np.int32) for i in range(3))
        m = ((9797 * r + 19234 * g + 3737 * b) >> 15).astype(np.uint8)
    return m.astype(np.float32) / 255.0
