"""Plain reference of torch-ngp's multiresolution hash encoding, the
position encoding of its ``NeRFNetwork(encoding="hashgrid")``
(github.com/ashawkey/torch-ngp), written from its equations in plain
PyTorch. It imports nothing of the program under test and nothing of JAX.

Layout (``gridencoder/grid.py:97-134``): per-level scale
b = 2^(log2(desired_resolution / base_resolution) / (L - 1)); level l has
resolution ceil(base_resolution * b^l) and min(2^log2_hashmap_size,
(resolution + 1)^3) rows rounded up to a multiple of 8, the levels' rows
one after another in one table [rows, C].

Encoding (``gridencoder/src/gridencoder.cu:51-135``): an input in
[-bound, bound] is moved to [0, 1]; outside [0, 1] on any axis it encodes
to zeros. At level l, scale = 2^(l log2 b) * base_resolution - 1 and
resolution = ceil(scale) + 1; pos = x scale + 0.5, its floor the cell's
corner and pos - floor the trilinear weights. A corner's row is the dense
index x + y (res + 1) + z (res + 1)^2 where (res + 1)^3 fits the level's
rows, else the hash x ^ y 2654435761 ^ z 805459861 (32-bit), either
modulo the level's rows. Bit d of a corner's number picks the upper
corner on axis d; its weight is the product of the axes' factors in axis
order, and the 8 weighted rows are summed in one reduction. Out: [L C, N],
level-major.

The field around it is ``render.field``: the bias-free sigma net, the
truncated exp, degree-4 SH of the direction beside the 15 geometry
features, the color net and a sigmoid, as torch-ngp's ``nerf/network.py``
(``num_layers`` 2, ``hidden_dim`` 64, ``num_layers_color`` 3,
``hidden_dim_color`` 64, ``bias=False``).
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

PRIMES = (1, 2654435761, 805459861)
M32 = 0xFFFFFFFF


class Grid(NamedTuple):
    """One hash grid's layout (3-D inputs)."""
    num_levels: int
    level_dim: int              # C, features a row
    base_resolution: int
    log2_hashmap_size: int
    per_level_scale: float
    offsets: Tuple[int, ...]    # [L + 1] first row of each level, then rows

    @property
    def rows(self) -> int:
        return self.offsets[-1]

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim

    def level(self, lvl: int) -> Tuple[float, int, int, int, bool]:
        """(scale, resolution, rows, first row, dense) of level ``lvl``,
        as the encoding kernel works them out."""
        scale = float(np.exp2(lvl * np.log2(self.per_level_scale))
                      * self.base_resolution - 1.0)
        res = int(np.ceil(scale)) + 1
        size = self.offsets[lvl + 1] - self.offsets[lvl]
        return scale, res, size, self.offsets[lvl], (res + 1) ** 3 <= size


def layout(num_levels: int, level_dim: int, base_resolution: int,
           log2_hashmap_size: int, desired_resolution: float) -> Grid:
    """The table's layout (``grid.py:97-134``, align_corners False)."""
    b = float(np.exp2(np.log2(desired_resolution / base_resolution)
                      / (num_levels - 1)))
    offsets, offset = [0], 0
    for lvl in range(num_levels):
        resolution = int(np.ceil(base_resolution * b ** lvl))
        rows = min(2 ** log2_hashmap_size, (resolution + 1) ** 3)
        offset += int(np.ceil(rows / 8) * 8)
        offsets.append(offset)
    return Grid(num_levels, level_dim, base_resolution, log2_hashmap_size, b,
                tuple(offsets))


def unit(comps, bound: float) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The inputs moved to [0, 1] (flat), and which lie inside."""
    x = [(c.reshape(-1) + bound) / (2.0 * bound) for c in comps]
    inside = torch.ones_like(x[0], dtype=torch.bool)
    for xi in x:
        inside = inside & (xi >= 0.0) & (xi <= 1.0)
    return x, inside


def _levels(grid: Grid, dtype, device):
    """Every level's (scale [L, 1] in ``dtype``, res + 1, rows, first row
    [L, 1] int64, dense [L, 1] bool), as ``Grid.level`` gives them."""
    lv = [grid.level(lvl) for lvl in range(grid.num_levels)]

    def col(i, dt, f=lambda v: v):
        return torch.tensor([f(v[i]) for v in lv], dtype=dt,
                            device=device)[:, None]
    return (col(0, dtype), col(1, torch.int64, lambda r: r + 1),
            col(2, torch.int64), col(3, torch.int64), col(4, torch.bool))


def corners(grid: Grid, x: List[torch.Tensor]):
    """Every level's 8 corners of the inputs ``x`` (3 tensors [N] in
    [0, 1]), corner by corner in the kernel's order: yields (rows [L, N]
    int64 into the table, weights [L, N]). All levels at once, each
    element's arithmetic that of its level alone; an input outside [0, 1]
    gets rows in range and its own weights, and the caller drops it."""
    scale, stride, size, first, dense = _levels(grid, x[0].dtype,
                                                x[0].device)
    pos = [xi[None, :] * scale + 0.5 for xi in x]
    cell = [torch.floor(p) for p in pos]
    frac = [p - c for p, c in zip(pos, cell)]
    cell = [c.to(torch.int64) & M32 for c in cell]
    # per axis, the lower and the upper corner's weight factor, its
    # coordinate times the dense stride, and its hash term
    fac = [(1.0 - f, f) for f in frac]
    loc = [(c, (c + 1) & M32) for c in cell]
    lin = [loc[0], tuple(v * stride for v in loc[1]),
           tuple(v * (stride * stride) for v in loc[2])]
    hsh = [loc[0]] + [tuple((v * PRIMES[d]) & M32 for v in loc[d])
                      for d in (1, 2)]
    for corner in range(8):
        b = [(corner >> d) & 1 for d in range(3)]
        w = fac[0][b[0]] * fac[1][b[1]] * fac[2][b[2]]
        idx = torch.where(dense,
                          (lin[0][b[0]] + lin[1][b[1]] + lin[2][b[2]]) & M32,
                          hsh[0][b[0]] ^ hsh[1][b[1]] ^ hsh[2][b[2]])
        yield idx % size + first, w


def encode(table: torch.Tensor, grid: Grid, comps, bound: float
           ) -> torch.Tensor:
    """Positions (3 tensors of one shape, in [-bound, bound]) -> features
    [L C, N] in the table's dtype. Every corner of every level is gathered
    at once and the corners summed in one reduction, so under autograd the
    table's gradient is one deterministic scatter (a sort) a call."""
    x, inside = unit(comps, bound)
    x = [xi.to(table.dtype) for xi in x]
    rows, w = zip(*corners(grid, x))
    feats = (torch.stack(w, 1)[..., None]
             * table[torch.stack(rows, 1)]).sum(1)      # [L, N, C]
    feats = torch.where(inside[None, :, None], feats, torch.zeros_like(feats))
    return feats.permute(0, 2, 1).reshape(grid.output_dim, -1)


def touch(seen: torch.Tensor, grid: Grid, comps, bound: float) -> int:
    """Mark in ``seen`` (bool [rows]) every table row the corners of these
    positions read; a position outside the box reads none. Returns how
    many lie inside."""
    x, inside = unit(comps, bound)
    x = [xi[inside] for xi in x]
    for rows, _ in corners(grid, x):
        seen[rows.reshape(-1)] = True
    return int(x[0].shape[0])


def flops_per_sample(grid: Grid) -> int:
    """The encoding's least operations a position inside the box: per
    level 3 for the (1 - frac) factors, 16 for the 8 corners' weights (two
    products each) and 2 for each of the 8 x C multiply-adds."""
    return grid.num_levels * (3 + 16 + 16 * grid.level_dim)
