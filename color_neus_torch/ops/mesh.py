"""Mesh extraction: port of color_neus_tpu/ops/mesh.py.

SDF grid on the device -> marching tetrahedra on the host -> per-vertex
colour on the device -> PLY. The grid's points are gathered on the device
from the JAX code's np.linspace axes (the same lattice, bitwise) and
evaluated in fixed-size chunks through the grid-SDF kernel
(ops/kernels/sdf_mlp.py: the CUDA kernel for CUDA weights, its plain twin
on the CPU) at RendererConfig.extract_precision. Vertex colours go through
the point-pipeline kernel (ops/kernels/point_pipeline.py) unless
fused_core='off'.

Two behaviours are kept as the JAX code has them, so the two packages
give the same mesh (ROADMAP.md lists them): extract_geometry ignores
`overlap` on the sparse path, and the sparse path's coarse corners are
np.arange(nb + 1) * (h f) + bmin, not the fine np.linspace lattice.
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch

from color_neus_torch.models import fields
from color_neus_torch.models.configs import RendererConfig
from color_neus_torch.ops.kernels.sdf_mlp import make_fused_sdf_fn
from color_neus_torch.ops.marching_cubes import extract_geometry_from_grid, marching_cubes
from color_neus_torch.utils.logger import logger

CHUNK = 1 << 18          # grid points per kernel call (mesh.py:153)
CHUNK_BLOCKS = 512       # sparse blocks per call: 512 * 8^3 = 2^18 points
# a block is active when its coarse min |sdf| <= SAFETY * diag / 2
# (Lipschitz slack of a learned SDF, mesh.py:170)
SAFETY = 2.0


def _device(params) -> torch.device:
    return next(iter(params.parameters())).device


def default_sdf_chunk_fn(params, rcfg: RendererConfig):
    """pts [n, 3] -> -sdf [n] (the reference marches u = -sdf,
    NeuS.py:416), weights resolved once for the whole extraction."""
    fn = make_fused_sdf_fn(params["sdf"], rcfg.sdf, prec=rcfg.extract_precision)
    return lambda p: -fn(p)


def _axes(bound_min, bound_max, res: int, device):
    bmin = np.asarray(bound_min, np.float32)
    bmax = np.asarray(bound_max, np.float32)
    return tuple(torch.as_tensor(np.linspace(bmin[i], bmax[i], res, dtype=np.float32),
                                 device=device) for i in range(3))


def _lattice_points(axes, res: int, start: int, stop: int):
    """The lattice's points [stop - start, 3] from flat (x-major) index
    start, gathered on the device from the axes."""
    flat = torch.arange(start, stop, device=axes[0].device)
    return torch.stack([axes[0][flat // (res * res)], axes[1][(flat // res) % res],
                        axes[2][flat % res]], dim=-1)


def _grid_eval_stream(axes, res: int, sdf_chunk_fn, chunk: int = CHUNK):
    """Yields (flat_offset, np.ndarray) pieces of -sdf in flat (x-major)
    index order, `chunk` points each."""
    n = res ** 3
    for start in range(0, n, chunk):
        p = _lattice_points(axes, res, start, min(start + chunk, n))
        yield start, sdf_chunk_fn(p).cpu().numpy()


def evaluate_sdf_grid(params, rcfg: RendererConfig, bound_min, bound_max,
                      resolution: int, sdf_chunk_fn=None, chunk: int = CHUNK) -> np.ndarray:
    """-sdf on a dense grid [res, res, res] (NeuS.py:416), `chunk` points
    a kernel call."""
    if sdf_chunk_fn is None:
        sdf_chunk_fn = default_sdf_chunk_fn(params, rcfg)
    axes = _axes(bound_min, bound_max, resolution, _device(params))
    out = np.empty(resolution ** 3, np.float32)
    with torch.no_grad():
        for j, piece in _grid_eval_stream(axes, resolution, sdf_chunk_fn, chunk):
            out[j:j + piece.size] = piece
    return out.reshape(resolution, resolution, resolution)


def evaluate_sdf_grid_sparse(params, rcfg: RendererConfig, bound_min, bound_max,
                             resolution: int, factor: int | None = None, sdf_chunk_fn=None,
                             return_active: bool = False, level: float = 0.0,
                             stats: dict | None = None):
    """Coarse-to-fine -sdf grid: only fine voxels near the surface are
    evaluated (mesh.py:167-377, with its soundness argument).

    A block of factor^3 voxels is ACTIVE when its coarse min-|sdf| <=
    SAFETY * diag/2 or its corner signs disagree; inactive blocks are
    filled with their base-corner coarse value (sign-constant, so marching
    emits nothing there), active blocks carry the exact fine values. Seam
    self-healing then activates any block whose face disagrees in sign
    with its neighbour, to a fixed point.

    Returns u [res,res,res] (optionally (u, active [nb,nb,nb] bool)).
    Falls back to the dense grid when factor doesn't divide res. `stats`,
    when given, receives coarse_s, fine_s, active_fraction, heal_rounds."""
    res = resolution
    if factor is None:
        factor = 8 if res >= 128 else 4
    if sdf_chunk_fn is None:
        sdf_chunk_fn = default_sdf_chunk_fn(params, rcfg)
    if res % factor or res < 4 * factor:
        u = evaluate_sdf_grid(params, rcfg, bound_min, bound_max, res,
                              sdf_chunk_fn=sdf_chunk_fn)
        if return_active:
            nb = max(res // factor, 1)
            return u, np.ones((nb, nb, nb), bool)
        return u

    dev = _device(params)
    bmin = np.asarray(bound_min, np.float32)
    bmax = np.asarray(bound_max, np.float32)
    h = (bmax - bmin) / (res - 1.0)
    nb = res // factor
    f = factor

    # coarse corners at fine-grid stride f (the top corner lands one
    # voxel beyond bmax — the SDF is defined there, distances still hold)
    t0 = time.perf_counter()
    ax = [np.arange(nb + 1, dtype=np.float32) * (h[i] * f) + bmin[i] for i in range(3)]
    cg = torch.as_tensor(np.stack(np.meshgrid(*ax, indexing="ij"), -1).reshape(-1, 3),
                         device=dev)
    with torch.no_grad():
        cvals = np.concatenate([sdf_chunk_fn(cg[i:i + CHUNK]).cpu().numpy()
                                for i in range(0, cg.shape[0], CHUNK)])
    c = cvals.reshape(nb + 1, nb + 1, nb + 1)
    coarse_s = time.perf_counter() - t0

    cs = [c[dx:dx + nb, dy:dy + nb, dz:dz + nb]
          for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]
    min_abs = np.minimum.reduce([np.abs(x - level) for x in cs])
    sign_change = ((np.minimum.reduce(cs) < level) & (np.maximum.reduce(cs) > level))
    diag = float(np.linalg.norm(h * f))
    active = (min_abs <= SAFETY * diag / 2.0) | sign_change

    # base-corner fill (sign-constant within every inactive block)
    u = np.repeat(np.repeat(np.repeat(c[:nb, :nb, :nb], f, 0), f, 1), f, 2)
    u = np.ascontiguousarray(u, np.float32)
    axes = _axes(bmin, bmax, res, dev)
    offs = torch.as_tensor(np.stack(np.meshgrid(np.arange(f), np.arange(f), np.arange(f),
                                                indexing="ij"), -1).reshape(-1, 3), device=dev)
    uv = u.reshape(nb, f, nb, f, nb, f)
    fine_s = [0.0]

    def _eval_ids(ids):
        t1 = time.perf_counter()
        for i in range(0, len(ids), CHUNK_BLOCKS):
            bid = ids[i:i + CHUNK_BLOCKS]
            b = torch.as_tensor(bid, device=dev)
            base = torch.stack([b // (nb * nb), (b // nb) % nb, b % nb], -1) * f
            idx = base[:, None, :] + offs[None]
            p = torch.stack([axes[0][idx[..., 0]], axes[1][idx[..., 1]],
                             axes[2][idx[..., 2]]], -1).reshape(-1, 3)
            with torch.no_grad():
                vals = sdf_chunk_fn(p).cpu().numpy().reshape(len(bid), f, f, f)
            for j, blk in enumerate(bid):
                uv[blk // (nb * nb), :, (blk // nb) % nb, :, blk % nb, :] = vals[j]
        fine_s[0] += time.perf_counter() - t1

    _eval_ids(np.flatnonzero(active.ravel()).astype(np.int64))

    # seam self-healing: activate any inactive block whose face disagrees
    # in sign with its neighbour, evaluate exactly, iterate to a fixed point
    u3 = u.reshape(res, res, res)

    def _collapse(d):
        # [nb-1, res, res] seam-plane flags -> [nb-1, nb, nb] block flags
        return d.reshape(nb - 1, nb, f, nb, f).any(axis=(2, 4))

    rounds = 0
    while True:
        new = np.zeros_like(active)
        s = u3 > level
        for axis in range(3):
            sw = np.moveaxis(s, axis, 0)
            lo = sw[f - 1::f][:nb - 1]      # planes k*f-1, k=1..nb-1
            hi = sw[f::f]                   # planes k*f
            # any cross-seam voxel PAIR within a cube can be a marching
            # tet edge — check all 9 in-plane offsets, not just the
            # face-adjacent one, and flag the blocks of BOTH endpoints
            diff_lo = np.zeros_like(lo)
            diff_hi = np.zeros_like(lo)
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    hs = np.roll(hi, (dy, dz), axis=(1, 2))
                    d = lo != hs
                    if dy == 1:
                        d[:, 0, :] = False
                    elif dy == -1:
                        d[:, -1, :] = False
                    if dz == 1:
                        d[:, :, 0] = False
                    elif dz == -1:
                        d[:, :, -1] = False
                    diff_lo |= d
                    # the same flags at the hi-plane voxel's position
                    dh = np.roll(d, (-dy, -dz), axis=(1, 2))
                    if dy == -1:
                        dh[:, 0, :] = False
                    elif dy == 1:
                        dh[:, -1, :] = False
                    if dz == -1:
                        dh[:, :, 0] = False
                    elif dz == 1:
                        dh[:, :, -1] = False
                    diff_hi |= dh
            if not diff_lo.any() and not diff_hi.any():
                continue
            dbl = _collapse(diff_lo)
            dbh = _collapse(diff_hi)
            aw = np.moveaxis(active, axis, 0)
            nw = np.moveaxis(new, axis, 0)
            nw[:nb - 1] |= dbl & ~aw[:nb - 1]
            nw[1:] |= dbh & ~aw[1:]
        if not new.any():
            break
        rounds += 1
        active |= new
        _eval_ids(np.flatnonzero(new.ravel()).astype(np.int64))

    frac = float(active.mean())
    logger.info("sparse grid res %d: %d of %d blocks active (%.4f) after %d healing rounds",
                res, int(active.sum()), active.size, frac, rounds)
    if stats is not None:
        stats.update(coarse_s=coarse_s, fine_s=fine_s[0], active_fraction=frac,
                     heal_rounds=rounds)
    if return_active:
        return u, active
    return u


def _weld_block_meshes(results, res: int, bound_min, bound_max):
    """Concatenate per-block/slab meshes and merge bitwise-equal boundary
    vertices (shared planes are interpolated from the same grid values)."""
    if not results:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64))
    verts = np.concatenate([v for v, _t in results], axis=0)
    off = 0
    tris = []
    for v, t in results:
        tris.append(t + off)
        off += len(v)
    tris = np.concatenate(tris, axis=0)
    vv = np.ascontiguousarray(verts)
    view = vv.view([("x", vv.dtype), ("y", vv.dtype), ("z", vv.dtype)])[:, 0]
    _uniq, first, inv = np.unique(view, return_index=True, return_inverse=True)
    verts = vv[first]
    tris = inv.reshape(-1)[tris]
    bmin = np.asarray(bound_min, np.float64)
    bmax = np.asarray(bound_max, np.float64)
    verts = verts / (res - 1.0) * (bmax - bmin)[None, :] + bmin[None, :]
    return verts.astype(np.float32), tris


def extract_geometry_sparse(params, rcfg: RendererConfig, bound_min, bound_max,
                            resolution: int, threshold: float = 0.0,
                            factor: int | None = None, sdf_chunk_fn=None,
                            stats: dict | None = None):
    """Sparse isosurface: the coarse-to-fine grid + marching restricted to
    the ACTIVE blocks, each over its voxel slab [base, base+f] inclusive;
    shared-face vertices weld bitwise (mesh.py:404-445). `stats` also
    receives march_s."""
    res = resolution
    if factor is None:
        factor = 8 if res >= 128 else 4
    if res % factor or res < 4 * factor:
        # misaligned resolution: march the full dense grid
        u = evaluate_sdf_grid(params, rcfg, bound_min, bound_max, res,
                              sdf_chunk_fn=sdf_chunk_fn)
        return extract_geometry_from_grid(u, bound_min, bound_max, threshold)
    u, active = evaluate_sdf_grid_sparse(
        params, rcfg, bound_min, bound_max, res, factor=factor,
        sdf_chunk_fn=sdf_chunk_fn, return_active=True, level=threshold, stats=stats)
    t0 = time.perf_counter()
    nb = active.shape[0]
    f = res // nb
    u3 = u.reshape(res, res, res)
    results = []
    for b in np.flatnonzero(active.ravel()):
        bx, by, bz = b // (nb * nb), (b // nb) % nb, b % nb
        x0, y0, z0 = bx * f, by * f, bz * f
        v, t = marching_cubes(u3[x0:x0 + f + 1, y0:y0 + f + 1, z0:z0 + f + 1], threshold,
                              origin=(x0, y0, z0))
        if len(v):
            results.append((v, t))
    out = _weld_block_meshes(results, res, bound_min, bound_max)
    if stats is not None:
        stats["march_s"] = time.perf_counter() - t0
    return out


def extract_geometry(params, rcfg: RendererConfig, bound_min, bound_max,
                     resolution: int, threshold: float = 0.0, sdf_chunk_fn=None,
                     overlap: bool = True, sparse: bool | None = None,
                     stats: dict | None = None):
    """Grid + isosurface at `threshold` (NeuS.py:410-417 contract).

    sparse=True (or rcfg.extract_sparse when sparse is None) takes the
    coarse-to-fine path (extract_geometry_sparse), and `overlap` is then
    not read (as in the JAX code). Dense with overlap=True marches
    completed x-slabs in a worker thread while the device evaluates the
    next chunks; slab meshes weld exactly (mesh.py:448-533)."""
    if sparse is None:
        sparse = rcfg.extract_sparse
    if sparse:
        return extract_geometry_sparse(params, rcfg, bound_min, bound_max, resolution,
                                       threshold, sdf_chunk_fn=sdf_chunk_fn, stats=stats)
    if not overlap:
        u = evaluate_sdf_grid(params, rcfg, bound_min, bound_max, resolution,
                              sdf_chunk_fn=sdf_chunk_fn)
        return extract_geometry_from_grid(u, bound_min, bound_max, threshold)

    if sdf_chunk_fn is None:
        sdf_chunk_fn = default_sdf_chunk_fn(params, rcfg)
    res = resolution
    n = res ** 3
    plane = res * res
    u = np.empty(n, np.float32)
    jobs: queue.Queue = queue.Queue()
    results, worker_err = [], []

    def _worker():
        while True:
            item = jobs.get()
            if item is None:
                return
            if worker_err:      # drain remaining jobs after a failure
                continue
            x0, x1 = item       # march cubes between planes [x0, x1] inclusive
            try:
                v, t = marching_cubes(u.reshape(res, res, res)[x0:x1 + 1], threshold,
                                      origin=(x0, 0, 0))
            except BaseException as e:  # re-raised on the main thread
                worker_err.append(e)
                continue
            if len(v):
                results.append((v, t))

    th = threading.Thread(target=_worker, daemon=True)
    th.start()
    marched = 0         # first x-plane not yet handed to the worker
    axes = _axes(bound_min, bound_max, res, _device(params))
    try:
        with torch.no_grad():
            for j, piece in _grid_eval_stream(axes, res, sdf_chunk_fn):
                u[j:j + piece.size] = piece
                avail = (j + piece.size) // plane     # planes 0..avail-1 complete
                if avail - marched >= 32 and avail < res:
                    jobs.put((marched, avail - 1))
                    marched = avail - 1               # re-own the boundary plane
        if marched < res - 1:
            jobs.put((marched, res - 1))
    finally:
        jobs.put(None)
        th.join()
    if worker_err:
        raise worker_err[0]
    return _weld_block_meshes(results, res, bound_min, bound_max)


def extract_vertex_colors(params, rcfg: RendererConfig, vertices: np.ndarray,
                          chunk: int = 1 << 15) -> np.ndarray:
    """Per-vertex colours: the reference passes the raw SDF gradient and
    its negation as normals / view dirs (NeuS.py:44-64); for Color-NeuS
    (no_view_dir) this is the view-independent global colour. The point
    pipeline gives it (kernel on CUDA, its plain twin on the CPU; a first
    pass supplies grad for the dirs = -grad of idr mode), or the fields
    path when fused_core='off' (mesh.py:536-587)."""
    from color_neus_torch.models.neus import eval_point_pipeline, resolve_point_pipeline

    n = vertices.shape[0]
    if n == 0:
        return np.zeros((0, 3), np.float32)
    dev = _device(params)
    out = []
    with torch.no_grad():
        pw = resolve_point_pipeline(params, rcfg)
        for i in range(0, n, chunk):
            pts = torch.as_tensor(np.asarray(vertices[i:i + chunk], np.float32), device=dev)
            if pw is None:
                _sdf, feat, grad = fields.sdf_with_grad(params["sdf"], rcfg.sdf, pts)
                gc = fields.color_apply(params["color"], rcfg.color, pts, grad, -grad, feat)
            else:
                dirs = torch.zeros_like(pts)
                if rcfg.color.mode != "no_view_dir":
                    dirs = -eval_point_pipeline(params, rcfg, pts, dirs, weights=pw)[1]
                gc = eval_point_pipeline(params, rcfg, pts, dirs, weights=pw)[2]
            out.append(gc.detach().cpu().numpy())
    return np.concatenate(out).reshape(-1, 3)


# ---------------------------------------------------------------------------
# PLY I/O (binary little-endian, as the JAX package writes it)
# ---------------------------------------------------------------------------

def write_ply(path: str, vertices: np.ndarray, triangles: np.ndarray,
              vertex_colors: np.ndarray | None = None):
    """Binary little-endian PLY with optional uchar vertex colors."""
    v = np.asarray(vertices, np.float32)
    t = np.asarray(triangles, np.int32)
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {len(v)}",
              "property float x", "property float y", "property float z"]
    if vertex_colors is not None:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header += [f"element face {len(t)}",
               "property list uchar int vertex_indices", "end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if vertex_colors is None:
            f.write(v.astype("<f4").tobytes())
        else:
            c = np.clip(np.asarray(vertex_colors) * 255.0, 0, 255).astype(np.uint8)
            rec = np.zeros(len(v), dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
            rec["xyz"] = v
            rec["rgb"] = c
            f.write(rec.tobytes())
        face = np.zeros(len(t), dtype=[("n", "u1"), ("idx", "<i4", 3)])
        face["n"] = 3
        face["idx"] = t
        f.write(face.tobytes())


def read_ply(path: str):
    """Read a PLY written by write_ply (binary LE, optional uchar colors).
    Returns (vertices, triangles, colors|None)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a ply file")
        n_vert = n_face = 0
        props = []
        while True:
            line = f.readline().strip().decode("ascii")
            if line == "end_header":
                break
            parts = line.split()
            if parts[0] == "element" and parts[1] == "vertex":
                n_vert = int(parts[2])
            elif parts[0] == "element" and parts[1] == "face":
                n_face = int(parts[2])
            elif parts[0] == "property" and parts[1] != "list":
                props.append(parts[2])
        if "red" in props:
            rec = np.frombuffer(f.read(n_vert * 15),
                                dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
            verts = rec["xyz"].copy()
            colors = rec["rgb"].astype(np.float32) / 255.0
        else:
            verts = np.frombuffer(f.read(n_vert * 12), dtype="<f4").reshape(-1, 3).copy()
            colors = None
        face = np.frombuffer(f.read(n_face * 13), dtype=[("n", "u1"), ("idx", "<i4", 3)])
        return verts, face["idx"].copy(), colors


def normalize_point_cloud(pts: np.ndarray) -> np.ndarray:
    """Centre and scale to a largest |coordinate| of 1 (mesh_tools.py's
    point-cloud normalisation)."""
    pts = np.asarray(pts, np.float32)
    pts = pts - pts.mean(axis=0)
    return pts / max(np.abs(pts).max(), 1e-12)


def write_glb(path: str, vertices: np.ndarray, triangles: np.ndarray,
              vertex_colors: np.ndarray | None = None):
    """Binary glTF 2.0 (one mesh: POSITION, optional COLOR_0 in [0, 1],
    uint32 indices), the JAX package's layout byte for byte but for the
    generator string (the reference's ply -> glb export, mesh_tools.py)."""
    import json
    import struct

    v = np.asarray(vertices, np.float32)
    t = np.asarray(triangles, np.uint32).reshape(-1)
    buffers = [v.tobytes(), t.tobytes()]
    accessors = [
        {"bufferView": 0, "componentType": 5126, "count": len(v), "type": "VEC3",
         "min": v.min(0).tolist(), "max": v.max(0).tolist()},
        {"bufferView": 1, "componentType": 5125, "count": len(t), "type": "SCALAR"},
    ]
    attributes = {"POSITION": 0}
    if vertex_colors is not None:
        c = np.clip(np.asarray(vertex_colors, np.float32), 0, 1)
        buffers.append(c.tobytes())
        accessors.append({"bufferView": 2, "componentType": 5126, "count": len(c),
                          "type": "VEC3"})
        attributes["COLOR_0"] = 2
    views, offset = [], 0
    for b in buffers:
        views.append({"buffer": 0, "byteOffset": offset, "byteLength": len(b)})
        offset += len(b) + (-len(b)) % 4
    gltf = {
        "asset": {"version": "2.0", "generator": "color_neus_torch"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": attributes, "indices": 1}]}],
        "bufferViews": views,
        "accessors": accessors,
        "buffers": [{"byteLength": offset}],
    }
    js = json.dumps(gltf).encode()
    js += b" " * ((-len(js)) % 4)
    bin_chunk = b"".join(b + b"\x00" * ((-len(b)) % 4) for b in buffers)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, 12 + 8 + len(js) + 8 + len(bin_chunk)))
        f.write(struct.pack("<II", len(js), 0x4E4F534A))        # JSON chunk
        f.write(js)
        f.write(struct.pack("<II", len(bin_chunk), 0x004E4942))  # BIN chunk
        f.write(bin_chunk)


def read_glb(path: str) -> tuple:
    """(the JSON chunk as a dict, the BIN chunk's bytes) of a file written
    by write_glb; raises ValueError on a bad header or chunk length."""
    import json
    import struct

    with open(path, "rb") as f:
        data = f.read()
    magic, version, total = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67 or version != 2 or total != len(data):
        raise ValueError(f"{path}: not a glTF 2.0 binary of its length")
    n_js, kind = struct.unpack_from("<II", data, 12)
    if kind != 0x4E4F534A:
        raise ValueError(f"{path}: the first chunk is not JSON")
    gltf = json.loads(data[20:20 + n_js])
    n_bin, kind = struct.unpack_from("<II", data, 20 + n_js)
    if kind != 0x004E4942 or 28 + n_js + n_bin != len(data):
        raise ValueError(f"{path}: bad BIN chunk")
    return gltf, data[28 + n_js:]
