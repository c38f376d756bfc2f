"""Tile-beam bending: settings, the beam gate, the per-frame IP packs, and
the binned candidate path of ``render_frame``.

Port of ``pienerf_tpu.ops.beam_bend``. The fused frame runs the gate and
``pack_ip_data_fast``; the Newton frame (``interactive.render_frame``, any
``max_iter_num``) runs ``pack_for``, ``select_tile_candidates``,
``bin_candidates`` and ``bend_tile_samples``. The TPU code's one-hot MXU
fetch of a candidate row becomes an indexed gather, and its tuple-of-
components Newton solve runs on stacked ``[3, 3, M]`` tensors.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from pienerf_tpu_torch.ops.bending import _inv3x3

PACK = 48          # p_def(3) p_ori(3) F(9) dF(27) pad(5) valid(1)
PACK_FAST = 16     # p_def(3) p_ori(3) F^-1(9, row-major) valid(1)


class BeamBendSettings(NamedTuple):
    num_seek_ip: int = 3
    max_iter_num: int = 1
    ip_dx: float = 0.0525
    ips_per_tile: int = 192       # P: beam candidate capacity per tile
    bin_capacity: int = 8         # B: IPs per depth bin (render_frame)
    beam_margin: float = 0.0      # 0 = auto: max(0.08, bend reach)
    halo_bins: int = 1            # render_frame: bins each side of a
    #                               sample's own bin in its window (see
    #                               auto_halo); the fused kernel derives a
    #                               per-tile halo from the bend reach
    bend_reach: float = 0.0       # 0 = auto: 2 * ip_dx


def reach_of(settings: BeamBendSettings) -> float:
    """World-space candidate reach of one sample."""
    return (settings.bend_reach if settings.bend_reach > 0.0
            else 2.0 * settings.ip_dx)


def margin_of(settings: BeamBendSettings) -> float:
    """Beam-gate slack: never below the bend reach."""
    return (settings.beam_margin if settings.beam_margin > 0.0
            else max(0.08, reach_of(settings)))


def auto_halo(reach: float, span: float, K: int) -> int:
    """Static halo bins for render_frame: cover ``reach`` world units each
    side of a sample when a bin is span/K wide (pass a lower span estimate
    when unsure: too few halo bins silently misassign nearest IPs)."""
    return max(1, int(math.ceil(reach * K / max(span, 1e-6))))


def pack_ip_data(p_def: torch.Tensor, p_ori: torch.Tensor, F: torch.Tensor,
                 dF: torch.Tensor) -> torch.Tensor:
    """[nIP, 48] rows for the Newton solve: p_def, p_ori, F (row-major
    d*3+c), dF (j*9+d*3+c), zero pad, and a validity flag of 1 last."""
    n = p_def.shape[0]
    return torch.cat([
        p_def, p_ori, F.reshape(n, 9), dF.reshape(n, 27),
        torch.zeros((n, PACK - 43), dtype=p_def.dtype, device=p_def.device),
        torch.ones((n, 1), dtype=p_def.dtype, device=p_def.device),
    ], dim=1)


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


def pack_for(settings: BeamBendSettings, p_def, p_ori, F, dF
             ) -> torch.Tensor:
    """The pack layout of the settings' Newton depth: the 16-wide fast rows
    when ``max_iter_num == 1``, else the 48-wide rows."""
    if settings.max_iter_num == 1:
        return pack_ip_data_fast(p_def, p_ori, F, dF)
    return pack_ip_data(p_def, p_ori, F, dF)


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


def select_tile_candidates(
    settings: BeamBendSettings,
    ip_pack: torch.Tensor,       # [nIP, W] (48 or 16)
    p_def: torch.Tensor,         # [nIP, 3]
    origin: torch.Tensor,        # [C, 3] tile beam origins (camera)
    axis: torch.Tensor,          # [C, 3] central ray directions (unit)
    tan_half: torch.Tensor,      # [C] beam half-width growth per unit depth
    t0: torch.Tensor,            # [C] tile near
    t1: torch.Tensor,            # [C] tile far
) -> Tuple[torch.Tensor, ...]:
    """Per-tile candidate compaction: the first P in-beam IPs in IP-index
    order. Returns (cand_pack [C, P, W], cand_proj [C, P] depth along the
    axis, mask [C, P], dropped [C]: in-beam IPs that did not fit)."""
    P = settings.ips_per_tile
    rel = p_def[None, :, :] - origin[:, None, :]              # [C, nIP, 3]
    proj = torch.einsum("cnd,cd->cn", rel, axis)
    lat2 = (rel * rel).sum(dim=-1) - proj * proj
    margin = margin_of(settings)
    radius = tan_half[:, None] * torch.clamp(proj, min=0.0) + margin
    ok = ((lat2 <= radius * radius)
          & (proj >= t0[:, None] - margin)
          & (proj <= t1[:, None] + margin))                      # [C, nIP]

    # rank-compact up to P candidate ids per tile (overflow to column P)
    rank = torch.cumsum(ok.to(torch.int64), dim=1) - 1
    take = ok & (rank < P)
    C, n = ok.shape
    ids = torch.zeros((C, P + 1), dtype=torch.int64, device=ok.device)
    src = torch.arange(n, device=ok.device).expand(C, n)
    ids.scatter_(1, torch.where(take, rank, P), torch.where(take, src, 0))
    ids = ids[:, :P]
    count = take.sum(dim=1)
    mask = torch.arange(P, device=ok.device)[None, :] < count[:, None]

    cand_pack = ip_pack[ids]                                   # [C, P, W]
    cand_proj = torch.einsum("cpd,cd->cp",
                             cand_pack[..., :3] - origin[:, None, :], axis)
    return cand_pack, cand_proj, mask, ok.sum(dim=1) - count


def bin_candidates(
    settings: BeamBendSettings,
    cand_pack: torch.Tensor,     # [C, P, W]
    cand_proj: torch.Tensor,     # [C, P]
    mask: torch.Tensor,          # [C, P]
    t0: torch.Tensor,            # [C]
    dt_bin: torch.Tensor,        # [C] bin width ((t1 - t0) / K)
    n_bins: int,                 # K + 2 * halo_bins
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter candidates into depth bins of B slots, in candidate order
    within a bin (a stable sort by bin, as ``jnp.argsort``). Returns (bins
    [C, n_bins, B, W], zero rows where empty; dropped [C]: candidates that
    overflowed their bin)."""
    B = settings.bin_capacity
    C, P = cand_proj.shape
    width = cand_pack.shape[-1]
    b = torch.clamp(torch.floor((cand_proj - t0[:, None]) / dt_bin[:, None])
                    .to(torch.int64) + settings.halo_bins, 0, n_bins - 1)
    b = torch.where(mask, b, n_bins)                           # not a slot

    b_sorted, order = torch.sort(b, dim=1, stable=True)
    pos = torch.arange(P, device=b.device).expand(C, P)
    changed = torch.ones_like(b_sorted, dtype=torch.bool)
    changed[:, 1:] = b_sorted[:, 1:] != b_sorted[:, :-1]
    start = torch.cummax(torch.where(changed, pos, 0), dim=1).values
    rank = pos - start                                         # within bin

    live = b_sorted < n_bins
    keep = live & (rank < B)
    slot = torch.where(keep, b_sorted * B + rank, n_bins * B)
    src = torch.gather(cand_pack, 1, order[..., None].expand(C, P, width))
    bins = torch.zeros((C, n_bins * B + 1, width), dtype=cand_pack.dtype,
                       device=cand_pack.device)
    bins.scatter_(1, slot[..., None].expand(C, P, width),
                  torch.where(keep[..., None], src, 0.0))
    dropped = (live & (rank >= B)).sum(dim=1)
    return bins[:, :n_bins * B].reshape(C, n_bins, B, width), dropped


def _inv3x3_c(m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form inverse of stacked 3x3 matrices m [3, 3, ...] (row,
    column first). Row k of the cofactor matrix is the cross product of
    the other two rows; returns (inverse [3, 3, ...], ok [...])."""
    r1 = m.roll(-1, 0)                                         # rows 1 2 0
    r2 = m.roll(-2, 0)                                         # rows 2 0 1
    cof = torch.linalg.cross(r1, r2, dim=1)                    # [3, 3, ...]
    det = (m[0] * cof[0]).sum(dim=0)
    ok = torch.abs(det) > 1e-20
    r = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    return cof.transpose(0, 1) * r, ok


def newton_invert_packed(x: torch.Tensor, sel: torch.Tensor,
                         max_iter: int) -> torch.Tensor:
    """Newton rest-space solve on selected 48-wide candidate rows: x [3,
    ...] samples, sel [48, ...] rows with the pack axis first. Solves
    F q + 1/2 (dF . q) q = x - p_def for q, ``max_iter`` full steps (a
    step with a singular Jacobian keeps q); returns p_ori + q [3, ...]
    (callers apply the ip_dx test)."""
    rest = sel.shape[1:]
    pd, po = sel[0:3], sel[3:6]
    Fm = sel[6:15].reshape((3, 3) + rest)                      # [d, c]
    dFm = sel[15:42].reshape((3, 3, 3) + rest)                 # [j, d, c]
    qt = x - pd
    q = torch.zeros_like(qt)
    for _ in range(max_iter):
        dFq = (dFm * q[:, None, None]).sum(dim=0)              # [d, c]
        J = Fm + dFq
        Jinv, ok = _inv3x3_c(J)
        # residual F q + 1/2 (dF . q) q - qt
        res = ((Fm * q[None]).sum(dim=1) + 0.5 * (dFq * q[None]).sum(dim=1)
               - qt)
        dq = (Jinv * res[None]).sum(dim=1)
        q = torch.where(ok, q - dq, q)
    return po + q


def bend_tile_samples(
    settings: BeamBendSettings,
    bins: torch.Tensor,          # [C, n_bins, B, W] (W = 48 or 16)
    x: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],   # each [C, T2, K]
) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """Bend tile samples: the sample at depth index k sees bins k .. k +
    2 * halo_bins (its own bin and halo_bins each side). num_seek_ip
    nearest rows in window order (ties to the lowest slot), the Newton
    solve (one exact step with the 16-wide F^-1 rows), the per-axis ip_dx
    reject and the 1/dist blend. Returns (mapped positions, 3 x [C, T2,
    K]; found [C, T2, K])."""
    C, n_bins, B, width = bins.shape
    fast = width == PACK_FAST
    h = settings.halo_bins
    K = n_bins - 2 * h
    WB = (2 * h + 1) * B
    # candidate window per depth index: [C, K, WB, W]
    win = torch.cat([bins[:, j:K + j] for j in range(2 * h + 1)], dim=2)
    xs = torch.stack(x, 0)                                     # [3,C,T2,K]
    d2 = None
    for i in range(3):
        pc = win[..., i].transpose(1, 2)                       # [C, WB, K]
        diff = x[i][:, None, :, :] - pc[:, :, None, :]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    empty = (win[..., width - 1] == 0.0).transpose(1, 2)      # [C, WB, K]
    d2 = torch.where(empty[:, :, None, :], float("inf"), d2)  # [C,WB,T2,K]

    kk = torch.arange(K, device=bins.device)
    ci = torch.arange(C, device=bins.device)[:, None, None]
    mapped = torch.zeros_like(xs)
    wsum = torch.zeros_like(x[0])
    for _ in range(settings.num_seek_ip):
        best, j = torch.min(d2, dim=1)                         # first min
        has = torch.isfinite(best)
        sel = win[ci, kk[None, None, :], j]                    # [C,T2,K,W]
        sel = torch.where(has[..., None], sel, 0.0).permute(3, 0, 1, 2)
        if fast:
            # p_rest = p_ori + F^-1 (x - p_def): the exact single step
            q = xs - sel[0:3]
            Fi = sel[6:15].reshape((3, 3) + q.shape[1:])
            p_rest = (sel[3:6] + Fi[:, 0] * q[0] + Fi[:, 1] * q[1]
                      + Fi[:, 2] * q[2])
        else:
            # solve only where a row was selected: elsewhere the row is
            # zeros, its Jacobian singular, q stays 0 and p_rest = 0
            p_rest = torch.zeros_like(xs)
            p_rest[:, has] = newton_invert_packed(
                xs[:, has], sel[:, has], settings.max_iter_num)
        # reject diverged solutions (> ip_dx per axis from the rest IP)
        ok = has & (torch.abs(p_rest - sel[3:6]) <= settings.ip_dx).all(0)
        w = torch.where(ok, 1.0 / torch.clamp(torch.sqrt(best), min=1e-8),
                        0.0)
        mapped = mapped + w * p_rest
        wsum = wsum + w
        d2 = d2.scatter(1, j[:, None], float("inf"))

    found = wsum > 0
    inv = 1.0 / torch.clamp(wsum, min=1e-30)
    out = torch.where(found, mapped * inv, xs)
    return tuple(out), found
