"""Interactive frame rendering: tile activity, compaction, candidate prep
and the fused tile kernel; plus the exact-bending oracle.

Port of ``pienerf_tpu.render.interactive`` for deformed, static
(``deformed=False``) and cut frames: the fused frame (``render_frame_fused``,
the tile kernel; ``max_iter_num == 1``) with the cut-split into bend and
static tile classes and the camera-fixed static cache, the binned Newton
frame (``render_frame``, any ``max_iter_num``; the field kernel), and the
exact-bending oracle. Either kernel width (64 or the 128-wide student)
follows from the packed weights, and so does the fused frame's paired
schedule (``kernels.field.pack_weights_paired``); ``block_tiles`` sets its
tiles per thread block. Every tensor stays on the device of the
pose. Under ``torch.profiler`` the fused frame records its stages as spans
(``utils/trace.py``): ``frame.render`` around it, and inside that
``frame.render.activity``, ``frame.render.prep`` once a tile pass and
``frame.render.scatter``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pienerf_tpu_torch.kernels import field as field_kernel
from pienerf_tpu_torch.kernels import tile as tile_kernel
from pienerf_tpu_torch.models.network import NetworkSpec
from pienerf_tpu_torch.ops import beam_bend
from pienerf_tpu_torch.ops.bending import newton_invert
from pienerf_tpu_torch.utils.trace import (FRAME_RENDER,
                                          FRAME_RENDER_ACTIVITY,
                                          FRAME_RENDER_PREP,
                                          FRAME_RENDER_SCATTER, span)


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
    deformed: bool = True          # False: static frame, no bending
    cut: bool = False              # bend only inside cut_bounds; the rest
    #                                renders static
    bound: float = 1.0             # scene bound: the march box of cut and
    #                                static frames
    seg_samples: int = 8           # Ks: samples per early-exit segment
    bend_sub: int = 4              # Ksb: samples per bend sub-window
    tighten_sampling: bool = False  # crop each tile's range to its span
    bend_window: int = 64          # Wn candidate rows per sub-window
    gate_tiles: bool = True        # tile active only with >= 1 candidate
    cut_split: bool = True         # cut mode: tiles whose rays miss the cut
    #                                box take the static kernel pass
    cut_static_frac: float = 0.95  # slots of that static class, of n_tiles
    block_tiles: int = 1           # fused kernel: tiles per thread block
    prep_approx_topk: bool = False  # the TPU's approx_max_k candidate
    #                                compaction: accepted and not read; the
    #                                prep always runs the exact top-k,
    #                                which meets approx_max_k's contract


def _check_supported(st: InteractiveSettings) -> None:
    if st.tile != 16:
        raise ValueError("the fused tile kernel is specialised to 16x16")


def _cut_box(st: InteractiveSettings, cut_bounds, device
             ) -> Optional[torch.Tensor]:
    """cut_bounds [xmin, xmax, ymin, ymax, zmin, zmax] as f32 in cut mode,
    None otherwise."""
    if not st.cut:
        return None
    if cut_bounds is None:
        raise ValueError("cut mode needs cut_bounds [6]")
    return torch.as_tensor(cut_bounds, dtype=torch.float32,
                           device=device).reshape(6)


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


def _scene_box(st, device):
    """The full scene box +-(bound + 1e-3): cut and static frames march
    through it, since the field has density anywhere in it."""
    hi = torch.full((3,), st.bound + 1e-3, dtype=torch.float32,
                    device=device)
    return -hi, hi


def _cap(frac, n_tiles, chunk):
    """Slot count: frac of the tiles, rounded down to chunk, >= chunk."""
    cap = int(n_tiles * frac)
    return max(chunk, (cap // chunk) * chunk)


def _tile_hits(st, bbmin, bbmax, pose, intrinsics, H, W):
    """Every tile's rays against the march box. Returns (all_tids, o,
    d_all, near_all, far_all, hit_tile)."""
    n_tiles = (H // st.tile) * (W // st.tile)
    all_tids = torch.arange(n_tiles, dtype=torch.int64, device=pose.device)
    o, d_all = _tile_rays(all_tids, st, H, W, pose, intrinsics)
    near_all, far_all = _near_far(o, d_all, bbmin, bbmax, st.min_near)
    return all_tids, o, d_all, near_all, far_all, (near_all < 1e30).any(1)


def tile_kernel_inputs(st, ip_pack, p_def, o, pose, intrinsics, H, W,
                       act_ids, act_mask, bbmin, bbmax, *, deformed=True,
                       cut=False, cut_bounds=None, t_jitter=0.5):
    """Per-slot ray data and, when ``deformed``, candidate prep for one
    tile-kernel pass over a compacted slot list. Static passes get zero
    candidates and bin counts, which the kernel does not read. Returns
    (args, kw, dropped_beam): ``args`` = (tile_sc, bin_start, params, dirs,
    cand) and ``kw`` the kernel's static sizes and mode, as
    ``kernels.tile.render_tiles`` takes them."""
    with span(FRAME_RENDER_PREP):
        dev = o.device
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

        if deformed:
            axis = _central_axis(d)
            origin = o.expand(a_cap, 3)
            tan_half = torch.full((a_cap,), ts * 0.75 / intrinsics[0],
                                  dtype=torch.float32, device=dev)
            # cut mode marches the full range (outside the cut box renders
            # the static scene); the crop margin exceeds the bend reach so
            # tightening stays lossless
            tmarg = (max(3.0 * st.bend.ip_dx,
                         beam_bend.reach_of(st.bend) + st.bend.ip_dx)
                     if st.tighten_sampling and not cut else 0.0)
            cand, bin_start, n_drop_beam, t0, t1 = tile_kernel.prep_candidates(
                ip_pack, p_def, origin, axis, tan_half, t0, t1,
                n_cand=st.bend.ips_per_tile, n_bins=K + 2,
                beam_margin=beam_bend.margin_of(st.bend), tighten_margin=tmarg)
            dropped_beam = torch.where(act_mask, n_drop_beam, 0).sum()
        else:
            cand = torch.zeros((a_cap, max(st.bend.ips_per_tile, 64),
                                tile_kernel.PACK_FAST), dtype=torch.float32,
                               device=dev)
            bin_start = torch.zeros((a_cap, K + 4), dtype=torch.int32,
                                    device=dev)
            dropped_beam = torch.zeros((), dtype=torch.int64, device=dev)

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
        if cut:
            params[13:19] = cut_bounds
        params[19] = t_jitter                  # 0.5: bin centers
        params[20] = beam_bend.reach_of(st.bend)

        if K % st.seg_samples == 0:
            Ks = st.seg_samples
        else:
            Ks = next(k for k in (16, 8, 4, 2, 1) if K % k == 0)
        Ksb = st.bend_sub if Ks % st.bend_sub == 0 else Ks
        kw = dict(K=K, Ks=Ks, Ksb=Ksb,
                  Wn=min(st.bend_window, st.bend.ips_per_tile),
                  num_seek=st.bend.num_seek_ip, deformed=deformed, cut=cut)
        return (tile_sc, bin_start, params, dirs, cand), kw, dropped_beam


def _fused_tile_pass(st, packed_w, ip_pack, p_def, o, pose, intrinsics,
                     H, W, act_ids, act_mask, bbmin, bbmax, **mode):
    """Candidate prep and one tile-kernel pass over a compacted slot list;
    ``mode`` as tile_kernel_inputs takes it. Returns (imgs [A, T2, 3],
    depths, wss, dropped_beam, dropped_window)."""
    args, kw, dropped_beam = tile_kernel_inputs(
        st, ip_pack, p_def, o, pose, intrinsics, H, W, act_ids, act_mask,
        bbmin, bbmax, **mode)
    out = tile_kernel.render_tiles(st.spec, packed_w, *args, **kw,
                                   block_tiles=st.block_tiles)
    imgs = out[:, 0:3, :].transpose(1, 2)                         # [A,T2,3]
    dropped_window = torch.where(act_mask, out[:, 5, 0], 0.0).sum()
    return imgs, out[:, 3, :], out[:, 4, :], dropped_beam, dropped_window


def _scatter_frame(n_tiles, T2, bg_color, parts):
    """Composite onto the background and scatter each (ids, mask, imgs,
    depths, wss) slot list into the frame, in order."""
    with span(FRAME_RENDER_SCATTER):
        dev = parts[0][2].device
        bg = torch.as_tensor(bg_color, dtype=torch.float32,
                             device=dev).expand(3)
        frame = torch.zeros((n_tiles + 1, T2, 3), device=dev) + bg
        fdepth = torch.zeros((n_tiles + 1, T2), device=dev)
        fws = torch.zeros((n_tiles + 1, T2), device=dev)
        for ids, mask, imgs, depths, wss in parts:
            imgs = imgs + (1.0 - wss)[..., None] * bg
            safe = torch.where(mask, ids, n_tiles)
            frame[safe] = imgs
            fdepth[safe] = depths
            fws[safe] = wss
        return frame[:n_tiles], fdepth[:n_tiles], fws[:n_tiles]


def active_tiles(st, p_def, pose, intrinsics, H, W, chunk):
    """Tile activity and slot compaction: rays against the march box (the
    deformed IPs' bbox, or the scene box in cut and static frames), and in
    deformed non-cut frames the candidate gate. Returns (n_tiles, o,
    bbmin, bbmax, act_ids, act_mask, act_n, overflow)."""
    with span(FRAME_RENDER_ACTIVITY):
        if st.deformed and not st.cut:           # the deformed IPs' bbox
            bbmin, bbmax = p_def.amin(dim=0) - 1e-3, p_def.amax(dim=0) + 1e-3
        else:
            bbmin, bbmax = _scene_box(st, pose.device)
        all_tids, o, d_all, near_all, far_all, hit_tile = _tile_hits(
            st, bbmin, bbmax, pose, intrinsics, H, W)
        n_tiles = all_tids.shape[0]
        if st.deformed and not st.cut and st.gate_tiles:
            hit_tile = hit_tile & _tiles_with_candidates(
                st, p_def, o, d_all, near_all, far_all, hit_tile, intrinsics)
        act_ids, act_mask, act_n, overflow = _compact_tiles(
            hit_tile, _cap(st.active_frac, n_tiles, chunk), all_tids)
        return n_tiles, o, bbmin, bbmax, act_ids, act_mask, act_n, overflow


def cut_classes(st, pose, intrinsics, H, W, cut_bounds):
    """The cut-split partition of the tiles that hit the scene box: the
    bend class, whose rays enter the cut box (``active_frac`` slots), and
    the static class, whose rays never do and so cannot hold a bending
    sample (``cut_static_frac`` slots). It depends on the camera and the
    cut box only. Returns (o, bbmin, bbmax, bend, static), each class as
    (ids, mask, n, overflow)."""
    with span(FRAME_RENDER_ACTIVITY):
        bbmin, bbmax = _scene_box(st, pose.device)
        all_tids, o, d_all, _, _, hit_tile = _tile_hits(
            st, bbmin, bbmax, pose, intrinsics, H, W)
        n_tiles = all_tids.shape[0]
        cb = cut_bounds
        cnear, _ = _near_far(o, d_all, cb[0::2], cb[1::2], st.min_near)
        cut_hit = (cnear < 1e30).any(dim=1)
        bend = _compact_tiles(hit_tile & cut_hit,
                              _cap(st.active_frac, n_tiles, st.tile_chunk),
                              all_tids)
        static = _compact_tiles(
            hit_tile & ~cut_hit,
            _cap(st.cut_static_frac, n_tiles, st.tile_chunk), all_tids)
        return o, bbmin, bbmax, bend, static


def render_static_cache(
    settings: InteractiveSettings,
    packed_w: torch.Tensor,
    pose: torch.Tensor,
    intrinsics: Tuple[float, float, float, float],
    H: int,
    W: int,
    cut_bounds,
    t_jitter: float = 0.5,
) -> Dict[str, torch.Tensor]:
    """The cut-split static class rendered once per camera. Its tiles'
    rays never enter the cut box, so their pixels depend on the weights,
    pose, intrinsics and cut box only, never on the sim state; under a
    fixed camera ``render_frame_fused(static_cache=...)`` reuses them and
    its frame equals the uncached one exactly (same kernel, slots and
    jitter). Nothing checks that the cache matches the frame's inputs:
    rebuild it on any camera, weights or cut box change."""
    st = settings
    _check_supported(st)
    cb = torch.as_tensor(cut_bounds, dtype=torch.float32,
                         device=pose.device).reshape(6)
    o, bbmin, bbmax, _, (ids_s, mask_s, n_s, ovf_s) = cut_classes(
        st, pose, intrinsics, H, W, cb)
    imgs_s, dep_s, ws_s, _, _ = _fused_tile_pass(
        st, packed_w, None, None, o, pose, intrinsics, H, W, ids_s, mask_s,
        bbmin, bbmax, deformed=False, t_jitter=t_jitter)
    return {"ids": ids_s, "mask": mask_s, "n": n_s, "overflow": ovf_s,
            "imgs": imgs_s, "depths": dep_s, "ws": ws_s}


def render_frame_fused(
    settings: InteractiveSettings,
    packed_w: torch.Tensor,       # [7, Wd, Wd] kernels.field.pack_weights
    #                               or pack_weights_paired's [4, 128, 128]
    ip_pack: torch.Tensor,        # [nIP, 16] beam_bend.pack_ip_data_fast
    p_def: torch.Tensor,          # [nIP, 3]
    pose: torch.Tensor,           # [4, 4]
    intrinsics: Tuple[float, float, float, float],
    H: int,
    W: int,
    bg_color,
    cut_bounds=None,              # [6] in cut mode
    t_jitter: float = 0.5,
    static_cache: Optional[Dict[str, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """Fused-kernel frame: torch ops do tile activity and candidate prep;
    the tile kernel does bend -> field -> composite. Deformed, static
    (``deformed=False``) and cut frames; with ``cut_split`` a cut frame
    renders its bend class and its static class (or takes the latter from
    ``render_static_cache``) in two passes and scatters them in that
    order. Capacity overflow is counted in ``dropped_beam`` /
    ``dropped_window`` / ``n_tile_overflow``."""
    with span(FRAME_RENDER):
        st = settings
        _check_supported(st)
        if st.bend.max_iter_num != 1:
            raise NotImplementedError(
                "the fused frame needs max_iter_num == 1; deeper Newton runs "
                "render_frame")
        if ip_pack.shape[1] != tile_kernel.PACK_FAST:
            raise ValueError("the fused path needs pack_ip_data_fast rows")
        cb = _cut_box(st, cut_bounds, pose.device)
        T2 = st.tile ** 2

        if st.cut and st.deformed and st.cut_split:
            o, bbmin, bbmax, bend, static = cut_classes(
                st, pose, intrinsics, H, W, cb)
            n_tiles = (H // st.tile) * (W // st.tile)
            ids_b, mask_b, n_b, ovf_b = bend
            imgs_b, dep_b, ws_b, dr_beam, dr_win = _fused_tile_pass(
                st, packed_w, ip_pack, p_def, o, pose, intrinsics, H, W,
                ids_b, mask_b, bbmin, bbmax, deformed=True, cut=True,
                cut_bounds=cb, t_jitter=t_jitter)
            if static_cache is None:
                ids_s, mask_s, n_s, ovf_s = static
                imgs_s, dep_s, ws_s, _, _ = _fused_tile_pass(
                    st, packed_w, ip_pack, p_def, o, pose, intrinsics, H, W,
                    ids_s, mask_s, bbmin, bbmax, deformed=False,
                    t_jitter=t_jitter)
            else:
                c = static_cache
                ids_s, mask_s, n_s, ovf_s = c["ids"], c["mask"], c["n"], \
                    c["overflow"]
                imgs_s, dep_s, ws_s = c["imgs"], c["depths"], c["ws"]
            frame, fdepth, fws = _scatter_frame(
                n_tiles, T2, bg_color,
                [(ids_b, mask_b, imgs_b, dep_b, ws_b),
                 (ids_s, mask_s, imgs_s, dep_s, ws_s)])
            return {"tiles_image": frame, "tiles_depth": fdepth,
                    "tiles_ws": fws, "n_active": n_b + n_s,
                    "n_tile_overflow": ovf_b + ovf_s,
                    "dropped_beam": dr_beam,
                    "dropped_window": dr_win.to(torch.int64)}

        (n_tiles, o, bbmin, bbmax, act_ids, act_mask, act_n,
         overflow) = active_tiles(st, p_def, pose, intrinsics, H, W,
                                   st.tile_chunk)
        imgs, depths, wss, dr_beam, dr_win = _fused_tile_pass(
            st, packed_w, ip_pack, p_def, o, pose, intrinsics, H, W,
            act_ids, act_mask, bbmin, bbmax, deformed=st.deformed, cut=st.cut,
            cut_bounds=cb, t_jitter=t_jitter)
        frame, fdepth, fws = _scatter_frame(
            n_tiles, T2, bg_color, [(act_ids, act_mask, imgs, depths, wss)])
        return {"tiles_image": frame, "tiles_depth": fdepth, "tiles_ws": fws,
                "n_active": act_n, "n_tile_overflow": overflow,
                "dropped_beam": dr_beam,
                "dropped_window": dr_win.to(torch.int64)}


def _composite(st, sigma, rgb, t, dt):
    """Composite along K: sigma [C, T2, K] (0 where invalid), rgb [3, C,
    T2, K], sample depths t and widths dt [C, K | 1]. A sample counts while
    the transmittance before it is >= T_thresh. Returns (img [C, T2, 3],
    depth [C, T2], ws [C, T2])."""
    tau = sigma * dt[:, None, :]
    cum = torch.cumsum(tau, dim=-1)
    T_excl = torch.exp(-(cum - tau))
    alpha = 1.0 - torch.exp(-tau)
    T_prev = torch.cat([torch.ones_like(cum[..., :1]),
                        torch.exp(-cum[..., :-1])], dim=-1)
    w = torch.where(T_prev >= st.T_thresh, alpha * T_excl, 0.0)
    img = torch.stack([(w * rgb[i]).sum(dim=-1) for i in range(3)], dim=-1)
    return img, (w * t[:, None, :]).sum(dim=-1), w.sum(dim=-1)


def render_frame(
    settings: InteractiveSettings,
    packed_w: torch.Tensor,       # [7, Wd, Wd] kernels.field.pack_weights
    ip_pack: torch.Tensor,        # [nIP, 48 | 16] beam_bend.pack_for
    p_def: torch.Tensor,          # [nIP, 3]
    pose: torch.Tensor,           # [4, 4]
    intrinsics: Tuple[float, float, float, float],
    H: int,
    W: int,
    bg_color,
    cut_bounds=None,              # [6] in cut mode
) -> Dict[str, torch.Tensor]:
    """Binned-candidate frame, main_gui's path for any ``max_iter_num``
    (the JAX package's XLA tile path): tile activity and compaction as the
    fused frame, then per chunk of ``tile_chunk`` slots the beam candidates
    in IP order (``select_tile_candidates``), depth bins
    (``bin_candidates``), bin-centred samples, ``bend_tile_samples`` (the
    48-wide rows run ``max_iter_num`` Newton steps, the 16-wide rows the
    exact single step), the field through ``kernels.field.field_eval``
    (the field kernel on the card) and the composite. Deformed, static
    (``deformed=False``) and cut frames, one pass without the cut split.
    Chunks holding no active slot are skipped (one host sync): their slots
    are masked out of the frame and the counters. ``dropped_window``
    counts bin-capacity drops."""
    st = settings
    dev = pose.device
    cb = _cut_box(st, cut_bounds, dev)
    ts = st.tile
    if H % ts or W % ts:
        raise ValueError(f"H, W must be multiples of the tile {ts}")
    T2 = ts * ts
    K = st.samples
    C = st.tile_chunk
    (n_tiles, _, bbmin, bbmax, act_ids, act_mask, act_n,
     overflow) = active_tiles(st, p_def, pose, intrinsics, H, W, C)
    a_cap = act_ids.shape[0]
    tan_half = torch.full((C,), ts * 0.75 / intrinsics[0],
                          dtype=torch.float32, device=dev)
    kk = (torch.arange(K, dtype=torch.float32, device=dev) + 0.5) / K
    dropped_beam = torch.zeros((), dtype=torch.int64, device=dev)
    dropped_bin = torch.zeros((), dtype=torch.int64, device=dev)
    n_live = -(-int(act_n) // C) * C

    imgs, depths, wss = [], [], []
    for c0 in range(0, n_live, C):
        tids = act_ids[c0:c0 + C]
        cmask = act_mask[c0:c0 + C]
        o_, d = _tile_rays(tids, st, H, W, pose, intrinsics)
        near, far = _near_far(o_, d, bbmin, bbmax, st.min_near)
        thit = near < 1e30
        t0, t1, _ = _tile_span(near, far, cmask)
        if st.deformed:
            cand, proj, m, dr_beam = beam_bend.select_tile_candidates(
                st.bend, ip_pack, p_def, o_.expand(C, 3), _central_axis(d),
                tan_half, t0, t1)
            bins, dr_bin = beam_bend.bin_candidates(
                st.bend, cand, proj, m, t0, (t1 - t0) / K,
                K + 2 * st.bend.halo_bins)
            dropped_beam = dropped_beam + torch.where(cmask, dr_beam, 0).sum()
            dropped_bin = dropped_bin + torch.where(cmask, dr_bin, 0).sum()

        # tile-uniform samples at the bin centres
        t = t0[:, None] + (t1 - t0)[:, None] * kk[None, :]       # [C, K]
        dt = ((t1 - t0) / K)[:, None]
        xs = tuple(o_[i] + t[:, None, :] * d[i][:, :, None]
                   for i in range(3))                             # [C,T2,K]
        if st.deformed:
            xm, found = beam_bend.bend_tile_samples(st.bend, bins, xs)
            if st.cut:
                # outside the cut box the static scene renders unbent
                in_cut = torch.ones_like(found)
                for i in range(3):
                    in_cut = (in_cut & (xs[i] > cb[2 * i])
                              & (xs[i] < cb[2 * i + 1]))
                xm = tuple(torch.where(in_cut, xm[i], xs[i])
                           for i in range(3))
                found = found | ~in_cut
        else:
            xm, found = xs, torch.ones(xs[0].shape, dtype=torch.bool,
                                       device=dev)

        valid = (found & (t[:, None, :] >= near[..., None])
                 & (t[:, None, :] <= far[..., None]) & thit[..., None])
        ds = tuple(d[i][:, :, None].expand(C, T2, K).reshape(-1)
                   for i in range(3))
        sigma, rgb = field_kernel.field_eval(
            packed_w, st.spec, tuple(c.reshape(-1) for c in xm), ds)
        sigma = (sigma * st.density_scale).reshape(C, T2, K)
        sigma = torch.where(valid, sigma, 0.0)
        for acc, v in zip((imgs, depths, wss), _composite(
                st, sigma, rgb.reshape(3, C, T2, K), t, dt)):
            acc.append(v)
    # the skipped chunks' slots are inactive: masked out by the scatter
    imgs.append(torch.zeros((a_cap - n_live, T2, 3), device=dev))
    depths.append(torch.zeros((a_cap - n_live, T2), device=dev))
    wss.append(torch.zeros((a_cap - n_live, T2), device=dev))

    frame, fdepth, fws = _scatter_frame(
        n_tiles, T2, bg_color, [(act_ids, act_mask, torch.cat(imgs, 0),
                                 torch.cat(depths, 0), torch.cat(wss, 0))])
    return {"tiles_image": frame, "tiles_depth": fdepth, "tiles_ws": fws,
            "n_active": act_n, "n_tile_overflow": overflow,
            "dropped_beam": dropped_beam, "dropped_window": dropped_bin}


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
    cut_bounds=None,              # [6] in cut mode
) -> Dict[str, torch.Tensor]:
    """Fidelity oracle: the fused frame's tile lattice, samples and
    composite, with each sample's k nearest IPs found by brute force over
    all IPs, the general Newton solve, the same per-axis ip_dx reject and
    1/dist blend, and the field evaluated by ``kernels.field.field_eval``
    (the field kernel on the card). In cut mode it marches the full scene
    box without the candidate gate and keeps the bent position only inside
    the cut box. Deformed frames only. O(samples x nIP): offline only."""
    st = settings
    _check_supported(st)
    if not st.deformed:
        raise ValueError("the exact oracle renders deformed frames")
    dev = p_def.device
    cb = _cut_box(st, cut_bounds, dev)
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
        if st.cut:
            in_cut = torch.ones_like(found)
            for i in range(3):
                in_cut = (in_cut & (x[:, i] > cb[2 * i])
                          & (x[:, i] < cb[2 * i + 1]))
            x_rest = torch.where(in_cut[:, None], x_rest, x)
            found = found | ~in_cut

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

        for acc, v in zip((imgs, depths, wss),
                          _composite(st, sigma, rgb, t, dt)):
            acc.append(v)

    frame, fdepth, fws = _scatter_frame(
        n_tiles, T2, bg_color, [(act_ids, act_mask, torch.cat(imgs, 0),
                                 torch.cat(depths, 0), torch.cat(wss, 0))])
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
