"""Cascaded occupancy grid: storage, maintenance, and lookups.

Port of ``pienerf_tpu.ops.grid``. density [cascade, 128^3] f32 in Morton
order (-1 = untrained), as the reference's checkpoints hold it; the
bitfield packs it into 32-bit words (bit i of word w = cell w * 32 + i),
held in an int32 tensor whose bits are the JAX package's uint32 words.

Maintenance follows the reference (nerf/renderer.py:456-547): EMA decay
max(grid * decay, new), a mean-density threshold, full updates for the
first 16 updates, then uniform random cells. Every random draw comes from
an explicit ``torch.Generator``, or is passed in (the tests pass JAX's).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from pienerf_tpu_torch.ops.morton import morton3d, morton3d_invert

GRID_SIZE = 128


class OccupancyGrid(NamedTuple):
    density: torch.Tensor       # [cascade, H^3] f32, Morton order
    bitfield: torch.Tensor      # [cascade * H^3 // 32] int32 (uint32 bits)
    mean_density: torch.Tensor  # f32 scalar
    iter_density: torch.Tensor  # int64 scalar


def init(cascade: int, device=None) -> OccupancyGrid:
    h3 = GRID_SIZE ** 3
    return OccupancyGrid(
        density=torch.zeros((cascade, h3), device=device),
        bitfield=torch.zeros(cascade * h3 // 32, dtype=torch.int32,
                             device=device),
        mean_density=torch.zeros((), device=device),
        iter_density=torch.zeros((), dtype=torch.int64, device=device))


def packbits(density: torch.Tensor, thresh) -> torch.Tensor:
    """density [CAS, H^3] -> bitfield [CAS * H^3 // 32] (reference
    raymarching.cu:271-292, widened to 32-bit words)."""
    bits = (density.reshape(-1, 32) > thresh).to(torch.int64)
    shifts = torch.arange(32, device=density.device)
    words = (bits << shifts).sum(dim=1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32,
                       words).to(torch.int32)


def occupied(bitfield: torch.Tensor, level: torch.Tensor,
             code: torch.Tensor) -> torch.Tensor:
    """Bit test at Morton code(s) for cascade level(s). Shapes broadcast."""
    index = level.to(torch.int64) * GRID_SIZE ** 3 + code.to(torch.int64)
    word = bitfield[index >> 5].to(torch.int64)
    return ((word >> (index & 31)) & 1) > 0


def _uniform(shape, generator: Optional[torch.Generator], device):
    """U(-1, 1) drawn on the generator's device, then moved to ``device``."""
    gdev = generator.device if generator is not None else device
    u = torch.rand(shape, generator=generator, device=gdev)
    return (u * 2.0 - 1.0).to(device)


def _eval_cascade_chunk(density_fn, coords, cas_bound, half_grid, noise):
    """Density at jittered cell centers of one cascade chunk."""
    xyz = 2.0 * coords.float() / (GRID_SIZE - 1) - 1.0
    xyz = xyz * (cas_bound - half_grid) + noise * half_grid
    return density_fn(xyz)


def update(
    grid: OccupancyGrid,
    density_fn: Callable[[torch.Tensor], torch.Tensor],
    bound: float,
    density_thresh: float,
    generator: Optional[torch.Generator] = None,
    decay: float = 0.95,
    chunk: int = 2 ** 18,
    full_threshold: int = 16,
    noise: Optional[torch.Tensor] = None,
    coords: Optional[torch.Tensor] = None,
) -> OccupancyGrid:
    """Refresh the density grid and bitfield (reference renderer.py:
    456-547). ``density_fn``: [M, 3] world positions -> [M] sigma.

    The draws: a full update jitters every cell by ``noise`` [cascade, H^3,
    3] in U(-1, 1) (Morton order); a partial one visits ``coords``
    [cascade, H^3 // 2, 3] random cells jittered by ``noise`` [cascade,
    H^3 // 2, 3]. What is not passed is drawn from ``generator``."""
    cascade = grid.density.shape[0]
    dev = grid.density.device
    h3 = GRID_SIZE ** 3
    full = int(grid.iter_density) < full_threshold
    tmp = -torch.ones_like(grid.density)

    if full:
        xs, ys, zs = morton3d_invert(torch.arange(h3, device=dev))
        coords_all = torch.stack([xs, ys, zs], dim=-1)            # [h3, 3]
        for cas in range(cascade):
            cas_bound = min(2 ** cas, bound)
            half = cas_bound / GRID_SIZE
            for s in range(0, h3, chunk):
                c = coords_all[s:s + chunk]
                nz = (noise[cas, s:s + chunk].to(dev) if noise is not None
                      else _uniform(c.shape, generator, dev))
                tmp[cas, s:s + chunk] = _eval_cascade_chunk(
                    density_fn, c, cas_bound, half, nz)
    else:
        n = h3 // 2
        for cas in range(cascade):
            if coords is not None:
                c = coords[cas].to(dev)
            else:
                gdev = generator.device if generator is not None else dev
                c = torch.randint(0, GRID_SIZE, (n, 3), generator=generator,
                                  device=gdev).to(dev)
            nz = (noise[cas].to(dev) if noise is not None
                  else _uniform(c.shape, generator, dev))
            codes = morton3d(c[:, 0], c[:, 1], c[:, 2]).to(torch.int64)
            cas_bound = min(2 ** cas, bound)
            half = cas_bound / GRID_SIZE
            tmp[cas, codes] = _eval_cascade_chunk(density_fn, c, cas_bound,
                                                  half, nz)

    valid = (grid.density >= 0) & (tmp >= 0)
    density = torch.where(valid, torch.maximum(grid.density * decay, tmp),
                          grid.density)
    mean_density = torch.clamp(density, min=0.0).mean()
    thresh = torch.clamp(mean_density, max=density_thresh)
    return OccupancyGrid(density=density,
                         bitfield=packbits(density, thresh),
                         mean_density=mean_density,
                         iter_density=grid.iter_density + 1)


def mark_untrained(grid: OccupancyGrid, poses: np.ndarray,
                   intrinsics, bound: float) -> OccupancyGrid:
    """Mark cells that no training camera sees as -1 (reference
    renderer.py:391-453). A one-time host (numpy) pass."""
    cascade = grid.density.shape[0]
    h3 = GRID_SIZE ** 3
    fx, fy, cx, cy = intrinsics
    poses = np.asarray(poses, np.float32)
    xs, ys, zs = morton3d_invert(torch.arange(h3))
    coords = torch.stack([xs, ys, zs], -1).numpy()
    world = 2.0 * coords.astype(np.float32) / (GRID_SIZE - 1) - 1.0

    density = grid.density.cpu().numpy().copy()
    for cas in range(cascade):
        cas_bound = min(2 ** cas, bound)
        half = cas_bound / GRID_SIZE
        pts = world * (cas_bound - half)
        count = np.zeros(h3, np.int64)
        for b0 in range(0, poses.shape[0], 16):
            ps = poses[b0:b0 + 16]
            cam = pts[None] - ps[:, None, :3, 3]
            cam = np.einsum("bnj,bjk->bnk", cam, ps[:, :3, :3])
            mask_z = cam[..., 2] > 0
            mask_x = np.abs(cam[..., 0]) < cx / fx * cam[..., 2] + half * 2
            mask_y = np.abs(cam[..., 1]) < cy / fy * cam[..., 2] + half * 2
            count += (mask_z & mask_x & mask_y).sum(0)
        density[cas, count == 0] = -1
    return grid._replace(density=torch.as_tensor(
        density, device=grid.density.device))
