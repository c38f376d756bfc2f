"""Uniform-grid spatial hash over deformed integration points (IPs).

Port of ``pienerf_tpu.ops.spatial_hash``. In place of the reference's
per-frame CSR (nerf/utils.py:355-443) a dense cell table [n_cells,
max_per_cell] of point ids (-1 padded), built with one stable sort. The
grid covers the scene box inflated by 5%, so its shape is fixed.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


class HashGridLayout(NamedTuple):
    """Static layout (hashable)."""
    bbmin: Tuple[float, float, float]
    hgs: float
    resolution: Tuple[int, int, int]
    max_per_cell: int

    @property
    def n_cells(self) -> int:
        r = self.resolution
        return r[0] * r[1] * r[2]


def make_layout(bound: float, hgs: float, max_per_cell: int = 16,
                margin: float = 0.05) -> HashGridLayout:
    lo = -bound * (1.0 + margin)
    size = 2.0 * bound * (1.0 + margin)
    res = int(np.ceil(size / hgs))
    return HashGridLayout(bbmin=(lo, lo, lo), hgs=float(hgs),
                          resolution=(res, res, res),
                          max_per_cell=int(max_per_cell))


def cell_of(layout: HashGridLayout, p: torch.Tensor) -> torch.Tensor:
    """Integer cell coords [..., 3] (int64) of points, clamped into the
    grid."""
    bbmin = torch.tensor(layout.bbmin, dtype=torch.float32, device=p.device)
    g = torch.floor((p - bbmin) / layout.hgs).to(torch.int64)
    res = torch.tensor(layout.resolution, device=p.device)
    return torch.minimum(torch.clamp(g, min=0), res - 1)


def cell_index(layout: HashGridLayout, g: torch.Tensor) -> torch.Tensor:
    """Linear cell id, z-major like the reference (utils.py:419)."""
    r0, r1, _ = layout.resolution
    return g[..., 2] * (r1 * r0) + g[..., 1] * r0 + g[..., 0]


def build_table(layout: HashGridLayout, points: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(table [n_cells, max_per_cell] point ids, -1 padded; counts
    [n_cells]). A cell lists its points in id order (a stable sort by
    cell) and drops those past max_per_cell; counts count them all."""
    n = points.shape[0]
    dev = points.device
    nc, mpc = layout.n_cells, layout.max_per_cell
    cid = cell_index(layout, cell_of(layout, points))
    order = torch.argsort(cid, stable=True)
    cid_sorted = cid[order]
    first = torch.searchsorted(cid_sorted, cid_sorted, side="left")
    rank = torch.arange(n, device=dev) - first
    keep = rank < mpc
    table = torch.full((nc + 1, mpc), -1, dtype=torch.int64, device=dev)
    table[torch.where(keep, cid_sorted, torch.full_like(cid_sorted, nc)),
          torch.where(keep, rank, torch.zeros_like(rank))] = order
    counts = torch.bincount(cid, minlength=nc)
    return table[:nc], counts


def dilated_occupancy(layout: HashGridLayout, counts: torch.Tensor
                      ) -> torch.Tensor:
    """'Is any IP within one cell of here': the 3^3-dilated occupancy
    [n_cells] of the cells."""
    r0, r1, r2 = layout.resolution
    occ = (counts > 0).reshape(1, 1, r2, r1, r0).float()
    out = torch.nn.functional.max_pool3d(occ, 3, stride=1, padding=1)
    return out.reshape(-1) > 0


def gather_neighborhood(layout: HashGridLayout, table: torch.Tensor,
                        g: torch.Tensor) -> torch.Tensor:
    """Candidate point ids [M, 27 * max_per_cell] of the 27-cell
    neighborhoods of cells g [M, 3] (-1: empty slot or outside the grid;
    reference raymarching.cu:986-1119)."""
    res = torch.tensor(layout.resolution, device=g.device)
    offs = torch.tensor([[dx, dy, dz] for dz in (-1, 0, 1)
                         for dy in (-1, 0, 1) for dx in (-1, 0, 1)],
                        device=g.device)                       # [27, 3]
    ng = g[:, None, :] + offs[None]
    in_grid = ((ng >= 0) & (ng < res)).all(dim=-1)
    cid = cell_index(layout, torch.minimum(torch.clamp(ng, min=0), res - 1))
    cand = table[cid]
    cand = torch.where(in_grid[..., None], cand, torch.full_like(cand, -1))
    return cand.reshape(g.shape[0], -1)
