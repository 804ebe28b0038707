"""Isosurface extraction via marching tetrahedra: the port's copy of
color_neus_tpu/ops/marching_cubes.py.

Two implementations of one function: the native C++ marcher
(csrc/marching_tet.cpp of the repo, built with g++ by utils/native.py;
a failed build raises), which marching_cubes uses by default, and the
vectorized numpy marcher below (backend='numpy'), its plain twin, which
the tests hold against it.

Replaces the reference's PyMCubes C++ dependency (NeuS.py:5,35). Each
grid cube is split into 6 tetrahedra sharing the 0-6 body diagonal; each
tet contributes 0-2 triangles from a 16-case table that is small enough
to derive by hand (no 256-entry MC tables to transcribe). Vertices on
shared edges are deduplicated globally, so the mesh is watertight across
cube and slab boundaries.

Processing is slab-by-slab with an occupied-cube prefilter, so a 512^3
grid never materializes per-tet arrays for empty space.

Convention: matches the reference's usage — the caller passes u = -sdf
and level 0.0, and vertex positions are mapped into
[bound_min, bound_max] by v/(res-1)*(bmax-bmin)+bmin (NeuS.py:39).
"""

from __future__ import annotations

import numpy as np


# Cube corner offsets (x, y, z), standard binary order.
_CORNERS = np.array([
    [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
], dtype=np.int64)

# Six tetrahedra sharing the 0-6 body diagonal (a standard decomposition
# that tiles space consistently between neighboring cubes).
_TETS = np.array([
    [0, 5, 1, 6],
    [0, 1, 2, 6],
    [0, 2, 3, 6],
    [0, 3, 7, 6],
    [0, 7, 4, 6],
    [0, 4, 5, 6],
], dtype=np.int64)

# Tet edges by local corner pair.
_TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int64)

# Case table: for each 4-bit inside-mask, up to 2 triangles of tet-edge
# ids (-1 padded). Complement cases flip the winding.
_TRI_TABLE = -np.ones((16, 2, 3), dtype=np.int64)


def _set_case(mask, tris):
    for t, tri in enumerate(tris):
        _TRI_TABLE[mask, t] = tri
    comp = 15 ^ mask
    for t, tri in enumerate(tris):
        _TRI_TABLE[comp, t] = tri[::-1]


# one corner inside: triangle on its three edges
_set_case(0b0001, [[0, 1, 2]])          # corner 0: edges 01,02,03
_set_case(0b0010, [[0, 4, 3]])          # corner 1: edges 01,13,12
_set_case(0b0100, [[1, 3, 5]])          # corner 2: edges 02,12,23
_set_case(0b1000, [[2, 5, 4]])          # corner 3: edges 03,23,13
# two corners inside: quad split into two triangles (perimeter order)
_set_case(0b0011, [[1, 2, 4], [1, 4, 3]])   # corners 0,1: edges 02,03,13,12
_set_case(0b0101, [[0, 3, 5], [0, 5, 2]])   # corners 0,2: edges 01,12,23,03
_set_case(0b1001, [[0, 4, 5], [0, 5, 1]])   # corners 0,3: edges 01,13,23,02
# (0b0110, 0b1010, 0b1100 are complements of the above)


def _slab_triangles(v0: np.ndarray, v1: np.ndarray, z0: int, res_xy, level: float):
    """Triangles for the cube slab between z-slices z0 and z0+1.

    v0, v1: [RX, RY] values at the two slices. Returns (pa, pb, ta) arrays
    of global point ids per triangle corner: each mesh vertex lies on the
    lattice edge (pa, pb).
    """
    RX, RY = v0.shape
    nx, ny = RX - 1, RY - 1
    vals2 = np.stack([v0, v1], axis=0)  # [2, RX, RY]

    # occupied-cube prefilter
    cmin = np.minimum(v0[:-1, :-1], v0[1:, :-1])
    cmin = np.minimum(cmin, np.minimum(v0[:-1, 1:], v0[1:, 1:]))
    cmin = np.minimum(cmin, np.minimum(v1[:-1, :-1], v1[1:, :-1]))
    cmin = np.minimum(cmin, np.minimum(v1[:-1, 1:], v1[1:, 1:]))
    cmax = np.maximum(v0[:-1, :-1], v0[1:, :-1])
    cmax = np.maximum(cmax, np.maximum(v0[:-1, 1:], v0[1:, 1:]))
    cmax = np.maximum(cmax, np.maximum(v1[:-1, :-1], v1[1:, :-1]))
    cmax = np.maximum(cmax, np.maximum(v1[:-1, 1:], v1[1:, 1:]))
    occ = (cmin <= level) & (cmax > level)
    cx, cy = np.nonzero(occ)
    if cx.size == 0:
        return (np.empty(0, np.int64),) * 2 + (np.empty((0,), np.float64),) * 2

    # corner lattice coords for occupied cubes: [C, 8, 3]
    corners = np.stack([cx, cy, np.full_like(cx, z0)], axis=1)[:, None, :] + \
        _CORNERS[None, :, [0, 1, 2]]
    # global point ids (flat index over the full grid, filled in by caller)
    # here: (x * RY + y) * 2... caller re-bases z; we use full-grid flat id.
    gx, gy, gz = corners[..., 0], corners[..., 1], corners[..., 2]
    corner_vals = vals2[gz - z0, gx, gy]                     # [C, 8]

    # expand to tets: [C, 6, 4]
    tet_vals = corner_vals[:, _TETS]                         # [C, 6, 4]
    tet_ids = np.stack([gx[:, _TETS], gy[:, _TETS], gz[:, _TETS]], axis=-1)  # [C,6,4,3]

    inside = tet_vals > level                                # "inside" = above level
    mask = (inside * np.array([1, 2, 4, 8])[None, None, :]).sum(-1)  # [C, 6]

    tris = _TRI_TABLE[mask]                                  # [C, 6, 2, 3] edge ids
    valid = tris[..., 0] >= 0                                # [C, 6, 2]
    c_i, t_i, k_i = np.nonzero(valid)
    if c_i.size == 0:
        return (np.empty(0, np.int64),) * 2 + (np.empty((0,), np.float64),) * 2

    tri_edges = tris[c_i, t_i, k_i]                          # [T, 3] edge ids in tet
    ends = _TET_EDGES[tri_edges]                             # [T, 3, 2] local corners

    tv = tet_vals[c_i, t_i]                                  # [T, 4]
    tc = tet_ids[c_i, t_i]                                   # [T, 4, 3]

    a = np.take_along_axis(tv, ends[..., 0], axis=1)         # [T, 3]
    b = np.take_along_axis(tv, ends[..., 1], axis=1)
    ca = np.take_along_axis(tc, ends[..., 0][..., None], axis=1)  # [T, 3, 3]
    cb = np.take_along_axis(tc, ends[..., 1][..., None], axis=1)
    return ca.reshape(-1, 3), cb.reshape(-1, 3), a.reshape(-1), b.reshape(-1)


def marching_cubes(u: np.ndarray, level: float = 0.0, backend: str = "auto",
                   origin=(0, 0, 0)):
    """Extract the isosurface of u [RX, RY, RZ] at `level`.

    Returns (vertices [V, 3] in grid-index coordinates, triangles [T, 3]).
    "Inside" is u > level, matching mcubes.marching_cubes(u, 0) on the
    reference's u = -sdf grid (NeuS.py:35).

    backend: 'auto' runs the native C++ extension (csrc/marching_tet.cpp,
    same algorithm; a failed build raises); 'numpy' runs the numpy twin.

    origin: integer lattice offset of u's [0,0,0] corner, applied BEFORE
    interpolation so a sub-block march is bitwise identical to the same
    cubes of a full-grid march (adding the offset to finished float
    vertices rounds differently; the block-welded extraction paths rely
    on exactness to merge shared-face vertices).
    """
    u = np.asarray(u)
    if backend == "auto":
        from color_neus_torch.utils.native import marching_tet_native
        return marching_tet_native(u, level, origin)
    if backend != "numpy":
        raise ValueError(f"marching_cubes backend {backend!r} not in ('auto', 'numpy')")
    RX, RY, RZ = u.shape
    all_ca, all_cb, all_va, all_vb = [], [], [], []
    for z0 in range(RZ - 1):
        ca, cb, va, vb = _slab_triangles(u[:, :, z0], u[:, :, z0 + 1], z0, (RX, RY), level)
        if len(ca):
            all_ca.append(ca)
            all_cb.append(cb)
            all_va.append(va)
            all_vb.append(vb)
    if not all_ca:
        return np.zeros((0, 3), np.float64), np.zeros((0, 3), np.int64)

    ca = np.concatenate(all_ca)   # [N, 3] lattice coords of edge end a
    cb = np.concatenate(all_cb)
    va = np.concatenate(all_va)
    vb = np.concatenate(all_vb)

    # Canonical edge key: order endpoints, flatten to int64.
    fa = (ca[:, 0] * RY + ca[:, 1]) * RZ + ca[:, 2]
    fb = (cb[:, 0] * RY + cb[:, 1]) * RZ + cb[:, 2]
    swap = fa > fb
    lo = np.where(swap, fb, fa)
    hi = np.where(swap, fa, fb)
    keys = lo * (RX * RY * RZ) + hi
    uniq, inv = np.unique(keys, return_inverse=True)

    # One representative occurrence per unique edge (t is identical for
    # every occurrence of an edge, endpoints canonicalized by the key).
    order = np.argsort(inv, kind="stable")
    inv_sorted = inv[order]
    newly = np.ones(inv_sorted.shape[0], bool)
    newly[1:] = inv_sorted[1:] != inv_sorted[:-1]
    first_pos = np.zeros(uniq.shape[0], np.int64)
    first_pos[inv_sorted[newly]] = order[newly]

    org = np.asarray(origin, np.int64)[None, :]
    # canonical edge orientation (lo -> hi): interpolation rounding must
    # not depend on which tet reached the edge first (block-decomposed
    # marches would disagree in the last ulp and fail to weld)
    sw = swap[first_pos]
    ra, rb = ca[first_pos], cb[first_pos]
    pa = (np.where(sw[:, None], rb, ra) + org).astype(np.float64)
    pb = (np.where(sw[:, None], ra, rb) + org).astype(np.float64)
    fva = np.where(sw, vb[first_pos], va[first_pos])
    fvb = np.where(sw, va[first_pos], vb[first_pos])
    denom = fvb - fva
    denom = np.where(np.abs(denom) < 1e-12, 1e-12, denom)
    t = np.clip((level - fva) / denom, 0.0, 1.0)
    vertices = pa + t[:, None] * (pb - pa)

    triangles = inv.reshape(-1, 3)
    # drop degenerate triangles (two corners on the same lattice edge)
    good = (triangles[:, 0] != triangles[:, 1]) & \
           (triangles[:, 1] != triangles[:, 2]) & \
           (triangles[:, 0] != triangles[:, 2])
    return vertices, triangles[good]


def extract_geometry_from_grid(u: np.ndarray, bound_min, bound_max, level: float = 0.0,
                               backend: str = "auto"):
    """marching_cubes + mapping into world bbox (NeuS.py:31-40 contract)."""
    res = u.shape[0]
    verts, tris = marching_cubes(u, level, backend)
    bmin = np.asarray(bound_min, np.float64)
    bmax = np.asarray(bound_max, np.float64)
    verts = verts / (res - 1.0) * (bmax - bmin)[None, :] + bmin[None, :]
    return verts.astype(np.float32), tris
