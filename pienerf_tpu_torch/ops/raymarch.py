"""Occupancy-guided ray marching and volume compositing.

Port of ``pienerf_tpu.ops.raymarch``. The reference's march (raymarching.cu:
315-493) advances t on the fixed recurrence t += clamp(t * dt_gamma,
dt_min, dt_max); skipping empty space only avoids occupancy tests, so the
visited t form a closed-form lattice: arithmetic at dt_min, geometric at
ratio 1 + dt_gamma, arithmetic at dt_max. Every lattice point of every ray
is tested at once, the occupied ones rank-compacted into a fixed [N, K]
buffer (a cumsum and one scatter), and compositing is a masked exclusive
scan over the sample axis.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from pienerf_tpu_torch.ops.grid import GRID_SIZE, occupied
from pienerf_tpu_torch.ops.morton import morton3d

SQRT3 = 1.7320508075688772
BIG = 3.4e38                      # miss sentinel (the reference's FLT_MAX)


def near_far_from_aabb(rays_o: torch.Tensor, rays_d: torch.Tensor,
                       aabb: torch.Tensor, min_near: float = 0.2
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slab test (reference raymarching.cu:92-160); aabb = [6] min, max.
    Misses return (BIG, BIG)."""
    inv_d = 1.0 / rays_d
    t0 = (aabb[None, :3] - rays_o) * inv_d
    t1 = (aabb[None, 3:] - rays_o) * inv_d
    near = torch.minimum(t0, t1).amax(dim=-1)
    far = torch.maximum(t0, t1).amin(dim=-1)
    miss = near > far
    near = torch.clamp(near, min=min_near)
    big = torch.full_like(near, BIG)
    return torch.where(miss, big, near), torch.where(miss, big, far)


def sph_from_ray(rays_o: torch.Tensor, rays_d: torch.Tensor, radius: float
                 ) -> torch.Tensor:
    """Far intersection with the background sphere as normalized spherical
    coordinates (theta, phi) / pi in [-1, 1] (raymarching.cu:163-229)."""
    b = (rays_o * rays_d).sum(-1)
    c = (rays_o * rays_o).sum(-1) - radius * radius
    t = -b + torch.sqrt(torch.clamp(b * b - c, min=0.0))
    p = rays_o + t[:, None] * rays_d
    theta = torch.atan2(torch.sqrt(p[:, 0] ** 2 + p[:, 2] ** 2), p[:, 1])
    phi = torch.atan2(p[:, 2], p[:, 0])
    return torch.stack([2.0 * theta / np.pi - 1.0, phi / np.pi], dim=-1)


def t_lattice(t0: torch.Tensor, n_steps: int, dt_gamma: float,
              dt_min: float, dt_max: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed form of the t recurrence: (t [N, S], dt [N, S]) with
    t[:, 0] = t0 and t[:, i+1] = t[:, i] + clamp(t[:, i] * gamma, dt_min,
    dt_max)."""
    i = torch.arange(n_steps, dtype=torch.float32, device=t0.device)[None]
    t0 = t0[:, None]
    if dt_gamma <= 0:
        t = t0 + i * dt_min
        return t, torch.full_like(t, dt_min)

    g = dt_gamma
    ta = dt_min / g
    tb = dt_max / g
    log1pg = float(np.float32(np.log1p(g)))
    n1 = torch.ceil(torch.clamp(ta - t0, min=0.0) / dt_min)
    t1 = t0 + n1 * dt_min
    n2 = torch.ceil(torch.clamp(torch.log(torch.clamp(t1.new_tensor(tb) / t1, min=1.0)),
                                min=0.0) / log1pg)
    t2 = t1 * torch.exp(n2 * log1pg)
    t_arith = t0 + i * dt_min
    t_geom = t1 * torch.exp((i - n1) * log1pg)
    t_tail = t2 + (i - n1 - n2) * dt_max
    t = torch.where(i < n1, t_arith, torch.where(i < n1 + n2, t_geom, t_tail))
    return t, torch.clamp(t * g, dt_min, dt_max)


def _level(mx: torch.Tensor, dt: torch.Tensor, cascade: int) -> torch.Tensor:
    _, e_pos = torch.frexp(mx)
    _, e_dt = torch.frexp(dt * GRID_SIZE * 0.5)
    lvl = torch.clamp(torch.maximum(e_pos, e_dt), min=0)
    return torch.clamp(lvl, max=cascade - 1).to(torch.int32)


def mip_level(x: torch.Tensor, dt: torch.Tensor, cascade: int
              ) -> torch.Tensor:
    """max(mip_from_pos, mip_from_dt) (reference raymarching.cu:42-55)."""
    return _level(x.abs().amax(dim=-1), dt, cascade)


def mip_level_c(x0, x1, x2, dt: torch.Tensor, cascade: int) -> torch.Tensor:
    """Componentwise mip_level."""
    mx = torch.maximum(x0.abs(), torch.maximum(x1.abs(), x2.abs()))
    return _level(mx, dt, cascade)


def occupancy_at_c(bitfield, x0, x1, x2, dt, bound: float, cascade: int
                   ) -> torch.Tensor:
    """Occupancy bit at componentwise world positions (any batch shape)."""
    lvl = mip_level_c(x0, x1, x2, dt, cascade)
    mip_bound = torch.clamp(torch.exp2(lvl.float()), max=bound)
    inv = 1.0 / mip_bound

    def cellc(c):
        return torch.clamp(0.5 * (c * inv + 1.0) * GRID_SIZE, 0,
                           GRID_SIZE - 1).to(torch.int32)

    return occupied(bitfield, lvl, morton3d(cellc(x0), cellc(x1), cellc(x2)))


def march_lattice(rays_o, rays_d, nears, fars, bitfield, bound: float,
                  cascade: int, n_steps: int, dt_gamma: float,
                  max_steps: int, noise: Optional[torch.Tensor] = None):
    """The whole t lattice and its occupancy for every ray at once.
    ``noise`` [N] in [0, 1) jitters the start (perturb). Returns
    (t [N, S], dt [N, S], valid [N, S]); valid needs t < far and the
    containing cell's bit."""
    dt_min = 2.0 * SQRT3 / max_steps
    dt_max = 2.0 * SQRT3 * (1 << (cascade - 1)) / GRID_SIZE
    t0 = nears
    if noise is not None:
        t0 = t0 + torch.clamp(t0 * dt_gamma, dt_min, dt_max) * noise
    t, dt = t_lattice(t0, n_steps, dt_gamma, dt_min, dt_max)
    xc = [torch.clamp(rays_o[:, i, None] + t * rays_d[:, i, None],
                      -bound, bound) for i in range(3)]
    occ = occupancy_at_c(bitfield, xc[0], xc[1], xc[2], dt, bound, cascade)
    return t, dt, occ & (t < fars[:, None])


def compact_samples(valid: torch.Tensor, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """First-k-valid compaction along the sample axis: (idx [N, K] int64
    lattice indices, mask [N, K]). The scatter goes into K + 1 columns and
    drops the last, as JAX's ``mode="drop"`` drops ranks >= K."""
    n, s = valid.shape
    rank = torch.cumsum(valid.to(torch.int64), dim=1) - 1
    take = valid & (rank < k)
    src = torch.arange(s, device=valid.device).expand(n, s)
    idx = torch.zeros((n, k + 1), dtype=torch.int64, device=valid.device)
    idx.scatter_(1, torch.where(take, rank, torch.full_like(rank, k)),
                 torch.where(take, src, torch.zeros_like(src)))
    count = take.sum(dim=1)
    mask = torch.arange(k, device=valid.device)[None] < count[:, None]
    return idx[:, :k], mask


def composite(sigmas, rgbs, dts, ts, mask, T_thresh: float = 1e-2):
    """Transmittance compositing over the sample axis (reference
    raymarching.cu:504-580): alpha = 1 - exp(-sigma dt); a sample counts
    iff every earlier sample left transmittance >= T_thresh. Returns
    (weights_sum [N], depth [N], image [N, 3])."""
    tau = torch.where(mask, sigmas * dts, torch.zeros_like(sigmas))
    cum = torch.cumsum(tau, dim=1)
    T_excl = torch.exp(-(cum - tau))
    alpha = 1.0 - torch.exp(-tau)
    T_post_prev = torch.cat([torch.ones_like(T_excl[:, :1]),
                             torch.exp(-cum[:, :-1])], dim=1)
    include = (T_post_prev >= T_thresh) & mask
    w = torch.where(include, alpha * T_excl, torch.zeros_like(alpha))
    return (w.sum(dim=1), (w * ts).sum(dim=1),
            (w[..., None] * rgbs).sum(dim=1))
