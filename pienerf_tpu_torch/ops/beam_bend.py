"""Tile-beam bending settings, the beam gate, and the per-frame IP pack.

Port of the parts of ``pienerf_tpu.ops.beam_bend`` that the fused frame
runs. The XLA tile path (``select_tile_candidates``, ``bin_candidates``,
``bend_tile_samples``) is not ported yet (ROADMAP.md queue 1 item 9).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pienerf_tpu_torch.ops.bending import _inv3x3

PACK_FAST = 16     # p_def(3) p_ori(3) F^-1(9, row-major) valid(1)


class BeamBendSettings(NamedTuple):
    num_seek_ip: int = 3
    max_iter_num: int = 1
    ip_dx: float = 0.0525
    ips_per_tile: int = 192       # P: beam candidate capacity per tile
    beam_margin: float = 0.0      # 0 = auto: max(0.08, bend reach)
    bend_reach: float = 0.0       # 0 = auto: 2 * ip_dx


def reach_of(settings: BeamBendSettings) -> float:
    """World-space candidate reach of one sample."""
    return (settings.bend_reach if settings.bend_reach > 0.0
            else 2.0 * settings.ip_dx)


def margin_of(settings: BeamBendSettings) -> float:
    """Beam-gate slack: never below the bend reach."""
    return (settings.beam_margin if settings.beam_margin > 0.0
            else max(0.08, reach_of(settings)))


def pack_ip_data_fast(p_def: torch.Tensor, p_ori: torch.Tensor,
                      F: torch.Tensor, dF: torch.Tensor) -> torch.Tensor:
    """[nIP, 16] rows for the single-Newton-step path, where the Newton
    solve is exactly p_rest = p_ori + F^-1 (x - p_def); F is inverted once
    per frame per IP. ``dF`` is unused (its terms vanish at q = 0)."""
    n = p_def.shape[0]
    Finv, ok = _inv3x3(F)
    return torch.cat([
        p_def, p_ori, Finv.reshape(n, 9),
        ok.to(p_def.dtype)[:, None],                 # last slot: validity
    ], dim=1)


def count_in_beam(settings: BeamBendSettings, p_def: torch.Tensor,
                  origin: torch.Tensor, axis: torch.Tensor,
                  tan_half: torch.Tensor, t0: torch.Tensor,
                  t1: torch.Tensor) -> torch.Tensor:
    """Per-tile count of IPs passing the beam gate (the same test as
    ``kernels.tile.prep_candidates``). origin [3], axis [A, 3], tan_half
    [A] or scalar, t0/t1 [A] -> [A] int64."""
    proj = None
    lat2 = None
    for i in range(3):
        rel = p_def[None, :, i] - origin[i]
        c = rel * axis[:, i:i + 1]
        proj = c if proj is None else proj + c
        lat2 = rel * rel if lat2 is None else lat2 + rel * rel
    lat2 = lat2 - proj * proj
    margin = margin_of(settings)
    tan_half = torch.as_tensor(tan_half, dtype=t0.dtype,
                               device=t0.device).expand(t0.shape)
    radius = tan_half[:, None] * torch.clamp(proj, min=0.0) + margin
    ok = ((lat2 <= radius * radius)
          & (proj >= t0[:, None] - margin)
          & (proj <= t1[:, None] + margin))
    return ok.sum(dim=1)
