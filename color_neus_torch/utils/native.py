"""Native (C++) marching tetrahedra: the port's copy of the loader in
color_neus_tpu/utils/native.py.

Builds the repo's csrc/marching_tet.cpp (read in place) with g++ at first
use into color_neus_torch/_build/ (git-ignored), keyed by a hash of the
source and the flags, and binds it through ctypes. A failed build or a
non-zero return raises: unlike the JAX package there is no quiet fallback
to numpy (ops/marching_cubes.py keeps the numpy marcher as the plain twin,
chosen only by backend='numpy').
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), "csrc", "marching_tet.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _build() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"libmarchingtet_{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    r = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True,
                       timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE} (rc {r.returncode}):\n{r.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent loader never sees half a file
    return out


def load() -> ctypes.CDLL:
    """The loaded marching-tetrahedra library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            lib.mt_extract.restype = ctypes.c_int
            lib.mt_extract.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_float,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
                ctypes.POINTER(ctypes.c_int64),
            ]
            _lib = lib
        return _lib


def marching_tet_native(u: np.ndarray, level: float = 0.0, origin=(0, 0, 0)):
    """Native isosurface extraction; returns (verts [V,3] f64, tris [T,3]).
    `origin` offsets the lattice BEFORE interpolation (exact sub-block
    marching — see mt_extract)."""
    lib = load()
    u = np.ascontiguousarray(u, np.float32)
    vp = ctypes.POINTER(ctypes.c_float)()
    tp = ctypes.POINTER(ctypes.c_int64)()
    nv = ctypes.c_int64()
    nt = ctypes.c_int64()
    rc = lib.mt_extract(u.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                        u.shape[0], u.shape[1], u.shape[2], ctypes.c_float(level),
                        int(origin[0]), int(origin[1]), int(origin[2]),
                        ctypes.byref(vp), ctypes.byref(nv), ctypes.byref(tp), ctypes.byref(nt))
    if rc != 0:
        raise RuntimeError(f"marching_tet: mt_extract returned {rc}")
    try:
        verts = np.ctypeslib.as_array(vp, shape=(nv.value, 3)).copy() \
            if nv.value else np.zeros((0, 3), np.float32)
        tris = np.ctypeslib.as_array(tp, shape=(nt.value, 3)).copy() \
            if nt.value else np.zeros((0, 3), np.int64)
    finally:
        lib.mt_free(vp)
        lib.mt_free(tp)
    return verts.astype(np.float64), tris
