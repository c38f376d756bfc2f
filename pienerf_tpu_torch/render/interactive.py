"""Interactive frame rendering: tile activity, compaction, candidate prep
and the fused tile kernel; plus the exact-bending oracle.

Port of ``pienerf_tpu.render.interactive`` for deformed, non-cut frames.
Cut mode, ``cut_split``, ``render_static_cache``, static frames and the
XLA tile path ``render_frame`` are not ported yet (ROADMAP.md queue 1
items 8-9). Every tensor stays on the device of ``p_def``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from pienerf_tpu_torch.kernels import field as field_kernel
from pienerf_tpu_torch.kernels import tile as tile_kernel
from pienerf_tpu_torch.models.network import NetworkSpec
from pienerf_tpu_torch.ops import beam_bend
from pienerf_tpu_torch.ops.bending import newton_invert


class InteractiveSettings(NamedTuple):
    spec: NetworkSpec
    bend: beam_bend.BeamBendSettings
    tile: int = 16                 # tile side, pixels (the kernel's 16)
    samples: int = 64              # K depth samples per ray
    active_frac: float = 0.5       # static capacity of active tiles
    tile_chunk: int = 32           # slot-count rounding (and oracle chunk)
    min_near: float = 0.05
    density_scale: float = 1.0
    T_thresh: float = 1e-2
    seg_samples: int = 8           # Ks: samples per early-exit segment
    bend_sub: int = 4              # Ksb: samples per bend sub-window
    tighten_sampling: bool = False  # crop each tile's range to its span
    bend_window: int = 64          # Wn candidate rows per sub-window
    gate_tiles: bool = True        # tile active only with >= 1 candidate


def _check_supported(st: InteractiveSettings) -> None:
    if st.tile != 16:
        raise ValueError("the fused tile kernel is specialised to 16x16")


def _tile_rays(tids, settings, H, W, pose, intrinsics):
    """Componentwise rays of tiles tids [C]: o [3], d (3 x [C, T2])."""
    ts = settings.tile
    fx, fy, cx, cy = intrinsics
    tiles_x = W // ts
    ty = tids // tiles_x
    tx = tids % tiles_x
    j = torch.arange(ts * ts, dtype=torch.int64, device=tids.device)
    py = (ty[:, None] * ts + j[None, :] // ts).float() + 0.5
    px = (tx[:, None] * ts + j[None, :] % ts).float() + 0.5
    dx = (px - cx) / fx
    dy = (py - cy) / fy
    dz = torch.ones_like(dx)
    nrm = torch.sqrt(dx * dx + dy * dy + 1.0)
    cam = (dx / nrm, dy / nrm, dz / nrm)
    R = pose[:3, :3]
    d = tuple(R[i, 0] * cam[0] + R[i, 1] * cam[1] + R[i, 2] * cam[2]
              for i in range(3))
    return pose[:3, 3], d


def _near_far(o, d, bbmin, bbmax, min_near):
    """Componentwise slab test; misses -> (BIG, BIG)."""
    BIG = torch.tensor(3.4e38, dtype=torch.float32, device=d[0].device)
    near = None
    far = None
    for i in range(3):
        inv = 1.0 / d[i]
        ta = (bbmin[i] - o[i]) * inv
        tb = (bbmax[i] - o[i]) * inv
        lo = torch.minimum(ta, tb)
        hi = torch.maximum(ta, tb)
        near = lo if near is None else torch.maximum(near, lo)
        far = hi if far is None else torch.minimum(far, hi)
    miss = near > far
    near = torch.clamp(near, min=min_near)
    return torch.where(miss, BIG, near), torch.where(miss, BIG, far)


def _tile_span(near, far, mask):
    """Per-tile [t0, t1] over the rays that hit; (1, 1.001) elsewhere."""
    thit = near < 1e30
    inf = torch.tensor(float("inf"), device=near.device)
    t0 = torch.where(thit, near, inf).amin(dim=1)
    t1 = torch.where(thit, far, -inf).amax(dim=1)
    any_hit = torch.isfinite(t0) & mask
    t0 = torch.where(any_hit, t0, torch.ones_like(t0))
    t1 = torch.where(any_hit, torch.maximum(t1, t0 + 1e-3),
                     torch.full_like(t1, 1.001))
    return t0, t1, any_hit


def _central_axis(d):
    ax = tuple(d[i].mean(dim=1) for i in range(3))
    an = torch.sqrt(ax[0] ** 2 + ax[1] ** 2 + ax[2] ** 2)
    return torch.stack([ax[i] / an for i in range(3)], dim=1)


def _tiles_with_candidates(st, p_def, o, d_all, near_all, far_all,
                           hit_tile, intrinsics):
    """Per-tile ``count_in_beam > 0`` over the whole frame."""
    t0, t1, _ = _tile_span(near_all, far_all, hit_tile)
    axis = _central_axis(d_all)
    tan_half = torch.tensor(st.tile * 0.75 / intrinsics[0],
                            dtype=torch.float32, device=p_def.device)
    n_cand = beam_bend.count_in_beam(st.bend, p_def, o, axis, tan_half,
                                     t0, t1)
    return n_cand > 0


def _compact_tiles(mask, cap, all_tids):
    """Rank-compact a tile mask into ``cap`` slots without a host sync.
    Returns (ids [cap], slot_mask [cap], n, overflow)."""
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    take = mask & (rank < cap)
    ids = torch.zeros((cap + 1,), dtype=torch.int64, device=mask.device)
    ids.scatter_(0, torch.where(take, rank, cap),
                 torch.where(take, all_tids, 0))
    n = take.sum()
    slot = torch.arange(cap, device=mask.device) < n
    return ids[:cap], slot, n, mask.sum() - n


def _frame_bbox(p_def):
    marg = 1e-3
    return p_def.amin(dim=0) - marg, p_def.amax(dim=0) + marg


def _a_cap(st, n_tiles, chunk):
    a_cap = int(n_tiles * st.active_frac)
    return max(chunk, (a_cap // chunk) * chunk)


def tile_kernel_inputs(st, ip_pack, p_def, o, pose, intrinsics, H, W,
                       act_ids, act_mask, bbmin, bbmax):
    """Per-slot ray data and candidate prep for one tile-kernel pass over
    a compacted slot list. Returns (args, kw, dropped_beam): ``args`` =
    (tile_sc, bin_start, params, dirs, cand) and ``kw`` the kernel's
    static sizes, as ``kernels.tile.render_tiles`` takes them."""
    dev = p_def.device
    ts = st.tile
    T2 = ts * ts
    K = st.samples
    a_cap = act_ids.shape[0]

    o_, d = _tile_rays(act_ids, st, H, W, pose, intrinsics)
    near, far = _near_far(o_, d, bbmin, bbmax, st.min_near)
    t0, t1, any_hit = _tile_span(near, far, act_mask)

    dirs = torch.zeros((a_cap, 8, T2), dtype=torch.float32, device=dev)
    for i in range(3):
        dirs[:, i, :] = d[i]

    axis = _central_axis(d)
    origin = o.expand(a_cap, 3)
    tan_half = torch.full((a_cap,), ts * 0.75 / intrinsics[0],
                          dtype=torch.float32, device=dev)
    # the crop margin exceeds the bend reach so tightening stays lossless
    tmarg = (max(3.0 * st.bend.ip_dx,
                 beam_bend.reach_of(st.bend) + st.bend.ip_dx)
             if st.tighten_sampling else 0.0)
    cand, bin_start, n_drop_beam, t0, t1 = tile_kernel.prep_candidates(
        ip_pack, p_def, origin, axis, tan_half, t0, t1,
        n_cand=st.bend.ips_per_tile, n_bins=K + 2,
        beam_margin=beam_bend.margin_of(st.bend), tighten_margin=tmarg)
    dropped_beam = torch.where(act_mask, n_drop_beam, 0).sum()

    tile_sc = torch.zeros((a_cap, 8), dtype=torch.float32, device=dev)
    tile_sc[:, 0] = t0
    tile_sc[:, 1] = t1
    tile_sc[:, 2] = any_hit.float()

    params = torch.zeros((24,), dtype=torch.float32, device=dev)
    params[0:3] = o
    params[3:6] = bbmin
    params[6:9] = bbmax
    params[9] = st.T_thresh
    params[10] = st.density_scale
    params[11] = st.bend.ip_dx
    params[12] = st.min_near
    params[19] = 0.5                       # t_jitter: bin centers
    params[20] = beam_bend.reach_of(st.bend)

    if K % st.seg_samples == 0:
        Ks = st.seg_samples
    else:
        Ks = next(k for k in (16, 8, 4, 2, 1) if K % k == 0)
    Ksb = st.bend_sub if Ks % st.bend_sub == 0 else Ks
    kw = dict(K=K, Ks=Ks, Ksb=Ksb,
              Wn=min(st.bend_window, st.bend.ips_per_tile),
              num_seek=st.bend.num_seek_ip)
    return (tile_sc, bin_start, params, dirs, cand), kw, dropped_beam


def _fused_tile_pass(st, packed_w, ip_pack, p_def, o, pose, intrinsics,
                     H, W, act_ids, act_mask, bbmin, bbmax):
    """Candidate prep and one tile-kernel pass over a compacted slot list.
    Returns (imgs [A, T2, 3], depths, wss, dropped_beam, dropped_window)."""
    args, kw, dropped_beam = tile_kernel_inputs(
        st, ip_pack, p_def, o, pose, intrinsics, H, W, act_ids, act_mask,
        bbmin, bbmax)
    out = tile_kernel.render_tiles(st.spec, packed_w, *args, **kw)
    imgs = out[:, 0:3, :].transpose(1, 2)                         # [A,T2,3]
    dropped_window = torch.where(act_mask, out[:, 5, 0], 0.0).sum()
    return imgs, out[:, 3, :], out[:, 4, :], dropped_beam, dropped_window


def _scatter_frame(n_tiles, T2, bg_color, act_ids, act_mask, imgs, depths,
                   wss):
    dev = imgs.device
    bg = torch.as_tensor(bg_color, dtype=torch.float32,
                         device=dev).expand(3)
    frame = torch.zeros((n_tiles + 1, T2, 3), device=dev) + bg
    fdepth = torch.zeros((n_tiles + 1, T2), device=dev)
    fws = torch.zeros((n_tiles + 1, T2), device=dev)
    imgs = imgs + (1.0 - wss)[..., None] * bg
    safe = torch.where(act_mask, act_ids, n_tiles)
    frame[safe] = imgs
    fdepth[safe] = depths
    fws[safe] = wss
    return frame[:n_tiles], fdepth[:n_tiles], fws[:n_tiles]


def active_tiles(st, p_def, pose, intrinsics, H, W, chunk):
    """Tile activity (bbox hit and candidate gate) and slot compaction.
    Returns (n_tiles, o, bbmin, bbmax, act_ids, act_mask, act_n,
    overflow)."""
    ts = st.tile
    n_tiles = (H // ts) * (W // ts)
    a_cap = _a_cap(st, n_tiles, chunk)
    bbmin, bbmax = _frame_bbox(p_def)
    all_tids = torch.arange(n_tiles, dtype=torch.int64, device=p_def.device)
    o, d_all = _tile_rays(all_tids, st, H, W, pose, intrinsics)
    near_all, far_all = _near_far(o, d_all, bbmin, bbmax, st.min_near)
    hit_tile = (near_all < 1e30).any(dim=1)
    if st.gate_tiles:
        hit_tile = hit_tile & _tiles_with_candidates(
            st, p_def, o, d_all, near_all, far_all, hit_tile, intrinsics)
    act_ids, act_mask, act_n, overflow = _compact_tiles(hit_tile, a_cap,
                                                        all_tids)
    return n_tiles, o, bbmin, bbmax, act_ids, act_mask, act_n, overflow


def render_frame_fused(
    settings: InteractiveSettings,
    packed_w: torch.Tensor,       # [7, 64, 64] kernels.field.pack_weights
    ip_pack: torch.Tensor,        # [nIP, 16] beam_bend.pack_ip_data_fast
    p_def: torch.Tensor,          # [nIP, 3]
    pose: torch.Tensor,           # [4, 4]
    intrinsics: Tuple[float, float, float, float],
    H: int,
    W: int,
    bg_color,
) -> Dict[str, torch.Tensor]:
    """Fused-kernel frame (deformed, non-cut): torch ops do tile activity
    and candidate prep; the tile kernel does bend -> field -> composite.
    Capacity overflow is counted in ``dropped_beam`` / ``dropped_window``
    / ``n_tile_overflow``."""
    st = settings
    _check_supported(st)
    if st.bend.max_iter_num != 1:
        raise NotImplementedError(
            "the fused frame needs max_iter_num == 1; deeper Newton runs "
            "the XLA tile path (ROADMAP.md queue 1 item 9)")
    if ip_pack.shape[1] != tile_kernel.PACK_FAST:
        raise ValueError("the fused path needs pack_ip_data_fast rows")
    (n_tiles, o, bbmin, bbmax, act_ids, act_mask, act_n,
     overflow) = active_tiles(st, p_def, pose, intrinsics, H, W,
                               st.tile_chunk)
    imgs, depths, wss, dr_beam, dr_win = _fused_tile_pass(
        st, packed_w, ip_pack, p_def, o, pose, intrinsics, H, W,
        act_ids, act_mask, bbmin, bbmax)
    frame, fdepth, fws = _scatter_frame(n_tiles, st.tile ** 2, bg_color,
                                        act_ids, act_mask, imgs, depths, wss)
    return {"tiles_image": frame, "tiles_depth": fdepth, "tiles_ws": fws,
            "n_active": act_n, "n_tile_overflow": overflow,
            "dropped_beam": dr_beam,
            "dropped_window": dr_win.to(torch.int64)}


def render_frame_exact(
    settings: InteractiveSettings,
    packed_w: torch.Tensor,
    p_def: torch.Tensor,          # [nIP, 3]
    p_ori: torch.Tensor,          # [nIP, 3]
    F: torch.Tensor,              # [nIP, 3, 3]
    dF: torch.Tensor,             # [nIP, 3, 3, 3]
    pose: torch.Tensor,
    intrinsics: Tuple[float, float, float, float],
    H: int,
    W: int,
    bg_color,
    tile_chunk: int = 2,
) -> Dict[str, torch.Tensor]:
    """Fidelity oracle: the fused frame's tile lattice, samples and
    composite, with each sample's k nearest IPs found by brute force over
    all IPs, the general Newton solve, the same per-axis ip_dx reject and
    1/dist blend, and the field evaluated by ``kernels.field.field_eval``
    (the field kernel on the card). O(samples x nIP): offline only."""
    st = settings
    _check_supported(st)
    dev = p_def.device
    ts = st.tile
    T2 = ts * ts
    K = st.samples
    (n_tiles, _, bbmin, bbmax, act_ids, act_mask, act_n,
     overflow) = active_tiles(st, p_def, pose, intrinsics, H, W,
                               tile_chunk)
    a_cap = act_ids.shape[0]
    ip_ok = ((p_def > bbmin) & (p_def < bbmax)).all(dim=-1)       # [nIP]
    kseek = st.bend.num_seek_ip
    inf = float("inf")

    imgs, depths, wss = [], [], []
    for c0 in range(0, a_cap, tile_chunk):
        tids = act_ids[c0:c0 + tile_chunk]
        cmask = act_mask[c0:c0 + tile_chunk]
        C = tids.shape[0]
        o_, d = _tile_rays(tids, st, H, W, pose, intrinsics)
        near, far = _near_far(o_, d, bbmin, bbmax, st.min_near)
        thit = near < 1e30
        t0, t1, _ = _tile_span(near, far, cmask)
        kk = (torch.arange(K, dtype=torch.float32, device=dev) + 0.5) / K
        t = t0[:, None] + (t1 - t0)[:, None] * kk[None, :]        # [C, K]
        dt = ((t1 - t0) / K)[:, None]
        xs = tuple(o_[i] + t[:, None, :] * d[i][:, :, None]
                   for i in range(3))                             # [C,T2,K]
        x = torch.stack([c.reshape(-1) for c in xs], dim=-1)      # [M, 3]
        M = x.shape[0]

        ids_l, dist_l = [], []
        for b0 in range(0, M, 8192):
            xq = x[b0:b0 + 8192]
            d2 = None
            for i in range(3):
                diff = xq[:, i:i + 1] - p_def[None, :, i]
                d2 = diff * diff if d2 is None else d2 + diff * diff
            d2 = torch.where(ip_ok[None, :], d2, inf)
            ids_b, dist_b = [], []
            for _ in range(kseek):
                best, j = torch.min(d2, dim=1)
                ids_b.append(j)
                dist_b.append(torch.sqrt(torch.clamp(best, min=0.0)))
                d2 = d2.scatter(1, j[:, None], inf)
            ids_l.append(torch.stack(ids_b, 1))
            dist_l.append(torch.stack(dist_b, 1))
        ids = torch.cat(ids_l, 0)
        dist = torch.cat(dist_l, 0)

        p_rest, _ = newton_invert(x, p_ori[ids], p_def[ids], F[ids], dF[ids],
                                  st.bend.max_iter_num)           # [M, k, 3]
        has = torch.isfinite(dist)
        moved = torch.abs(p_rest - p_ori[ids])
        ok = has & (moved <= st.bend.ip_dx).all(dim=-1)
        w = torch.where(ok, 1.0 / torch.clamp(dist, min=1e-8), 0.0)
        wsum = w.sum(dim=1)
        found = wsum > 0
        wn = w / torch.clamp(wsum, min=1e-30)[:, None]
        x_rest = torch.einsum("mk,mkd->md", wn, p_rest)
        x_rest = torch.where(found[:, None], x_rest, x)

        valid = (found.reshape(C, T2, K) & (t[:, None, :] >= near[..., None])
                 & (t[:, None, :] <= far[..., None]) & thit[..., None])
        ds = tuple(d[i][:, :, None].expand(C, T2, K).reshape(-1)
                   for i in range(3))
        sigma, rgb = field_kernel.field_eval(
            packed_w, st.spec, tuple(x_rest[:, i].contiguous()
                                     for i in range(3)), ds)
        sigma = (sigma * st.density_scale).reshape(C, T2, K)
        sigma = torch.where(valid, sigma, 0.0)
        rgb = rgb.reshape(3, C, T2, K)

        tau = sigma * dt[:, None, :]
        cum = torch.cumsum(tau, dim=-1)
        T_excl = torch.exp(-(cum - tau))
        alpha = 1.0 - torch.exp(-tau)
        T_prev = torch.cat([torch.ones_like(cum[..., :1]),
                            torch.exp(-cum[..., :-1])], dim=-1)
        w2 = torch.where(T_prev >= st.T_thresh, alpha * T_excl, 0.0)
        wss.append(w2.sum(dim=-1))
        depths.append((w2 * t[:, None, :]).sum(dim=-1))
        imgs.append(torch.stack([(w2 * rgb[i]).sum(dim=-1)
                                 for i in range(3)], dim=-1))

    frame, fdepth, fws = _scatter_frame(
        n_tiles, T2, bg_color, act_ids, act_mask, torch.cat(imgs, 0),
        torch.cat(depths, 0), torch.cat(wss, 0))
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    return {"tiles_image": frame, "tiles_depth": fdepth, "tiles_ws": fws,
            "n_active": act_n, "n_tile_overflow": overflow,
            "dropped_beam": zero, "dropped_window": zero}


def tiles_to_image(tiles, H: int, W: int, ts: int = 16) -> np.ndarray:
    """[n_tiles, ts*ts, C] -> [H, W, C] numpy."""
    if isinstance(tiles, torch.Tensor):
        tiles = tiles.detach().cpu().numpy()
    tiles = np.asarray(tiles)
    c = tiles.shape[-1] if tiles.ndim == 3 else 1
    out = tiles.reshape(H // ts, W // ts, ts, ts, -1).transpose(0, 2, 1, 3, 4)
    out = out.reshape(H, W, -1)
    return out if c > 1 else out[..., 0]
