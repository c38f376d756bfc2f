"""Geometry extraction: density-field point clouds and surface meshes.

Port of ``pienerf_tpu.utils.mesh`` (numpy, the same arithmetic).

Replaces the reference's PyMCubes dependency (reference: nerf/utils.py:
174-229, nerf/trainer.py:331-380) with a self-contained marching-tetrahedra
extractor (6 tets per cube, 16-case table — far smaller than the classic
marching-cubes tables and produces watertight triangle soups).
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np

# split each cube into 6 tetrahedra (corner indices of the unit cube,
# bit order: x<<2 | y<<1 | z)
_TETS = np.array([
    [0, 5, 1, 3],
    [0, 5, 3, 7],
    [0, 5, 7, 4],
    [0, 7, 3, 2],
    [0, 7, 2, 6],
    [0, 7, 6, 4],
])
_CUBE = np.array([[(c >> 2) & 1, (c >> 1) & 1, c & 1] for c in range(8)])

# for each of the 16 sign cases of a tet, the edges (pairs of local verts)
# forming 0, 1, or 2 triangles
_TET_EDGES = {
    0b0001: [(0, 1), (0, 2), (0, 3)],
    0b0010: [(1, 0), (1, 3), (1, 2)],
    0b0100: [(2, 0), (2, 1), (2, 3)],
    0b1000: [(3, 0), (3, 2), (3, 1)],
    0b0011: [(0, 2), (1, 2), (1, 3), (0, 2), (1, 3), (0, 3)],
    0b0101: [(0, 1), (2, 3), (0, 3), (0, 1), (2, 1), (2, 3)],
    0b1001: [(0, 1), (0, 2), (3, 2), (0, 1), (3, 2), (3, 1)],
    0b0110: [(1, 0), (2, 0), (2, 3), (1, 0), (2, 3), (1, 3)],
    0b1010: [(1, 0), (3, 0), (1, 2), (1, 2), (3, 0), (3, 2)],
    0b1100: [(2, 0), (3, 0), (2, 1), (2, 1), (3, 0), (3, 1)],
    0b0111: [(3, 0), (3, 2), (3, 1)],
    0b1011: [(2, 0), (2, 1), (2, 3)],
    0b1101: [(1, 0), (1, 3), (1, 2)],
    0b1110: [(0, 1), (0, 2), (0, 3)],
}


def extract_fields(density_fn: Callable[[np.ndarray], np.ndarray],
                   resolution: int = 128, bound: float = 1.0,
                   chunk: int = 2**18) -> np.ndarray:
    """Chunked density evaluation on a regular grid (nerf/utils.py:174-196)."""
    lin = np.linspace(-bound, bound, resolution, dtype=np.float32)
    gx, gy, gz = np.meshgrid(lin, lin, lin, indexing="ij")
    pts = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], -1)
    out = []
    for s in range(0, pts.shape[0], chunk):
        out.append(np.asarray(density_fn(pts[s:s + chunk])))
    return np.concatenate(out).reshape(resolution, resolution, resolution)


def extract_point_cloud(density_fn, resolution: int = 256, bound: float = 1.0,
                        threshold: float = 10.0) -> np.ndarray:
    """Grid points above the density threshold (nerf/utils.py:341-351)."""
    field = extract_fields(density_fn, resolution, bound)
    lin = np.linspace(-bound, bound, resolution, dtype=np.float32)
    idx = np.argwhere(field > threshold)
    return np.stack([lin[idx[:, 0]], lin[idx[:, 1]], lin[idx[:, 2]]], -1)


def marching_tetrahedra(field: np.ndarray, threshold: float,
                        bound: float = 1.0
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the threshold isosurface. Returns (verts [V,3], tris [T,3])."""
    res = field.shape[0]
    lin = np.linspace(-bound, bound, res)

    # occupied cells only (cells straddling the isosurface)
    inside = field > threshold
    cs = inside[:-1, :-1, :-1]
    straddle = np.zeros_like(cs)
    for dx, dy, dz in _CUBE:
        straddle |= inside[dx:res - 1 + dx, dy:res - 1 + dy, dz:res - 1 + dz] != cs
    cells = np.argwhere(straddle)
    if len(cells) == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)

    verts_out = []
    corner_pos = cells[:, None, :] + _CUBE[None]                # [C, 8, 3]
    corner_val = field[corner_pos[..., 0], corner_pos[..., 1],
                       corner_pos[..., 2]]                      # [C, 8]
    corner_xyz = np.stack(
        [lin[corner_pos[..., i]] for i in range(3)], axis=-1)   # [C, 8, 3]

    for tet in _TETS:
        v = corner_val[:, tet]                                  # [C, 4]
        p = corner_xyz[:, tet]                                  # [C, 4, 3]
        case = ((v > threshold) << np.arange(4)).sum(-1)        # [C]
        for code, edges in _TET_EDGES.items():
            sel = case == code
            if not sel.any():
                continue
            vs, ps = v[sel], p[sel]
            tri_pts = []
            for (a, b) in edges:
                t = (threshold - vs[:, a]) / (vs[:, b] - vs[:, a] + 1e-12)
                tri_pts.append(ps[:, a] + t[:, None] * (ps[:, b] - ps[:, a]))
            tri_pts = np.stack(tri_pts, axis=1)                 # [S, 3k, 3]
            verts_out.append(tri_pts.reshape(-1, 3))

    verts = np.concatenate(verts_out)
    tris = np.arange(len(verts)).reshape(-1, 3)
    return verts, tris


def save_mesh_obj(path: str, verts: np.ndarray, tris: np.ndarray) -> None:
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for t in tris:
            f.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")
