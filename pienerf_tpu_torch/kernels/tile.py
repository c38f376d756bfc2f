"""Fused per-tile frame kernel: candidate prep, the CUDA kernel
``csrc/tile_kernel.cu`` and its plain PyTorch version.

Port of ``pienerf_tpu.ops.pallas.tile_kernel`` with one tile per block, at
both packed widths (``kernels.field.KERNEL_NETS``: Wd 64 and the 128-wide
student), in its three frame modes: deformed (bend every sample), static
(``deformed=False``: no candidates, no bending) and cut (``deformed=True,
cut=True``: bend only inside the cut box). Two schedule variants ride on
every mode: ``paired`` (64-wide nets packed by
``kernels.field.pack_weights_paired``: each sample's sigma chain runs beside
the previous sample's color chain, rgb composites one segment late) and
``block_tiles`` = B > 1 (one thread block renders B consecutive tiles).
Both give the default schedule's output bit for bit. ``render_tiles``
launches the kernel for CUDA tensors and takes ``render_tiles_plain`` only
for CPU tensors. Every bf16 instantiation runs the field MLP on the tensor
cores (``csrc/mma_mlp.cuh``), every f32 one on the CUDA cores (the default
and ``block_tiles`` schedules register-blocked, ``csrc/field_f32.cuh``, on
the live samples alone, packed into passes of 256; ``render_tiles_plain``'s
``stats`` counts them).
``render_tiles_timed`` launches the kernel's timed instantiation (CUDA
only, either dtype), which also returns where each tile's clock cycles
went.

torch-ngp's hash-grid net (``kernels.field.GRID_NET``, packed as a
``GridPack`` with its table) runs the f32 default schedule in all three
modes (``csrc/tile_kernel_grid.cu``): its multiresolution hash encoding
takes the Fourier features' place, and ``render_tiles_plain`` encodes with
``models.hash_encoder.encode``. Under ``torch.profiler`` its launches add
four device counters (``read_grid_counters``); otherwise the kernel reads
no clock.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from pienerf_tpu_torch.kernels import _build
from pienerf_tpu_torch.kernels.field import (GRID_NET, WIDTHS, check_aligned,
                                             check_arg, check_kernel_spec,
                                             encode_rows, is_grid_pack,
                                             is_paired, mlp_paired_plain,
                                             mlp_plain)
from pienerf_tpu_torch.models import hash_encoder
from pienerf_tpu_torch.models.network import NetworkSpec, torch_dtype
from pienerf_tpu_torch.models.sh_encoder import sh_encode
from pienerf_tpu_torch.utils.trace import FRAME_TILE_LAUNCH, span

T2 = 256          # rays per 16x16 tile
PACK_FAST = 16    # candidate rows: p_def(3) p_ori(3) F^-1(9) valid(1)
MODES = ("deformed", "static", "cut")
# the columns of render_tiles_timed's cycles: the phases, then the tile's
# total cycles and its start and end on the global timer (ns), then the
# points the f32 MLP evaluated and the passes of 256 it ran
SPLIT_PHASES = ("staging", "scan", "blend", "mlp", "composite")
SPLIT_COUNTS = ("points", "passes")
SPLIT_COLS = len(SPLIT_PHASES) + 3 + len(SPLIT_COUNTS)
# the f32 kernel's bound on one sample's sigma (expf(15) < 3.3e6), from
# which it bounds a sample's optical depth (render_tiles_plain's "points")
SIGMA_BOUND = 3.3e6
# the hash-grid launches' device counters (csrc/grid_encode.cuh
# GridCounter), in order
GRID_COUNTERS = ("encode_cycles", "tile_cycles", "samples", "rows")


def mode_of(deformed: bool, cut: bool) -> str:
    """The kernel mode of a (deformed, cut) pair; cut needs deformed, as in
    the Pallas kernel, so (False, True) is the static march."""
    if not deformed:
        return "static"
    return "cut" if cut else "deformed"


def prep_candidates(
    ip_pack: torch.Tensor,   # [nIP, 16] fast-pack rows
    p_def: torch.Tensor,     # [nIP, 3]
    origin: torch.Tensor,    # [A, 3]
    axis: torch.Tensor,      # [A, 3] unit central dirs
    tan_half: torch.Tensor,  # [A]
    t0: torch.Tensor,        # [A]
    t1: torch.Tensor,        # [A]
    n_cand: int,             # P candidate capacity per tile
    n_bins: int,             # K + 2
    beam_margin: float,
    tighten_margin: float = 0.0,
) -> Tuple[torch.Tensor, ...]:
    """Depth-sorted beam candidates and per-bin prefix counts.

    Returns (cand [A, P, 16] sorted by depth with invalid rows last,
    bin_start [A, n_bins + 2] int32 prefix counts at the bin edges with the
    valid count appended, n_dropped [A], t0e [A], t1e [A]); see the JAX
    original for the contract. The order matches ``lax.top_k``: a stable
    descending sort keeps equal keys (the -inf slots too) in ascending
    index order, which ``torch.topk`` does not promise."""
    P = n_cand
    proj = None
    lat2 = None
    for i in range(3):
        rel = p_def[None, :, i] - origin[:, i:i + 1]             # [A, nIP]
        c = rel * axis[:, i:i + 1]
        proj = c if proj is None else proj + c
        lat2 = rel * rel if lat2 is None else lat2 + rel * rel
    lat2 = lat2 - proj * proj
    radius = tan_half[:, None] * torch.clamp(proj, min=0.0) + beam_margin
    ok = ((lat2 <= radius * radius)
          & (proj >= t0[:, None] - beam_margin)
          & (proj <= t1[:, None] + beam_margin))

    keyv = torch.where(ok, -proj, torch.full_like(proj, -float("inf")))
    k_eff = min(P, keyv.shape[1])
    negproj, ids = torch.sort(keyv, dim=1, descending=True, stable=True)
    negproj, ids = negproj[:, :k_eff], ids[:, :k_eff]
    if k_eff < P:
        padn = P - k_eff
        negproj = torch.cat([negproj, torch.full(
            (negproj.shape[0], padn), -float("inf"), device=proj.device)], 1)
        ids = torch.cat([ids, torch.zeros((ids.shape[0], padn),
                                          dtype=ids.dtype,
                                          device=ids.device)], 1)
    cproj = -negproj
    valid = torch.isfinite(cproj)
    count = valid.sum(dim=1)
    n_dropped = ok.sum(dim=1) - count
    cproj = torch.where(valid, cproj, torch.full_like(cproj, float("inf")))

    cand = ip_pack[ids]                                        # [A, P, 16]
    cand[..., PACK_FAST - 1] = torch.where(
        valid, cand[..., PACK_FAST - 1], torch.zeros_like(cproj))

    if tighten_margin > 0.0:
        pmin = cproj[:, 0]
        pmax = torch.where(valid, cproj,
                           torch.full_like(cproj, -float("inf"))).amax(1)
        has = count > 0
        t0e = torch.where(has, torch.maximum(t0, pmin - tighten_margin), t0)
        t1e = torch.where(has, torch.minimum(t1, pmax + tighten_margin), t1)
        t0e = torch.minimum(t0e, t1 - 1e-3)
        t1e = torch.maximum(t1e, t0e + 1e-3)
    else:
        t0e, t1e = t0, t1

    dt = (t1e - t0e) / (n_bins - 2)
    edges = (t0e[:, None]
             + (torch.arange(n_bins + 1, dtype=torch.float32,
                             device=t0.device)[None, :] - 1.0)
             * dt[:, None])                                    # [A, nb+1]
    bin_start = (cproj[:, :, None] < edges[:, None, :]).sum(dim=1)
    bin_start = torch.cat([bin_start, count[:, None]], 1).to(torch.int32)
    return cand, bin_start, n_dropped, t0e, t1e


def _gather_bs(bs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(bs, 1, idx[:, None])[:, 0]


def _window_edges(bs, i_lo, i_hi, K):
    """Candidate rows [lo, hi) between prefix edges i_lo and i_hi, clamped
    to the sorted list's ends (row 0 and the appended valid count)."""
    lo = torch.where(i_lo <= 0, 0, _gather_bs(bs, i_lo.clamp(min=0)))
    hi = torch.where(i_hi >= K + 2, bs[:, K + 3],
                     _gather_bs(bs, i_hi.clamp(max=K + 2)))
    return lo, hi


def _bend_segment(x, cand, bs, halo, k_seg, ip_dx, *, K, Ksb, Wn,
                  num_seek):
    """Bend one segment's samples x (3 x [n, T2, Ks]) of n tiles through
    each Ksb-deep sub-segment's candidate window (tile_kernel.py:366-463):
    num_seek nearest rows, one Newton step, the per-axis ip_dx reject and
    the inverse-distance blend. Returns (xm, found, window drops [n])."""
    n, _, Ks = x[0].shape
    P = cand.shape[1]
    dev = x[0].device
    ri = torch.arange(Wn, device=dev)
    dropped = torch.zeros((n,), dtype=torch.int64, device=dev)
    xs, found_l = [], []
    for sb in range(Ks // Ksb):
        k0 = k_seg + sb * Ksb
        lo, hi = _window_edges(bs, k0 + 1 - halo, k0 + Ksb + 1 + halo, K)
        # center the kept rows on the sub-segment's own bins when [lo, hi)
        # exceeds Wn; the overflow is counted
        own_lo = bs[:, k0 + 1]
        own_hi = bs[:, k0 + Ksb + 1]
        a = own_lo - torch.div(Wn - (own_hi - own_lo), 2,
                               rounding_mode="floor")
        a = torch.minimum(torch.maximum(a, lo), torch.maximum(lo, hi - Wn))
        a = a.clamp(0, P - Wn)
        dropped += torch.clamp(hi - lo - Wn, min=0)
        rows = a[:, None] + ri[None, :]
        cw = torch.gather(cand, 1,
                          rows[:, :, None].expand(n, Wn, PACK_FAST))
        row_ok = ((ri[None, :] >= (lo - a)[:, None])
                  & (ri[None, :] < (hi - a)[:, None])
                  & (cw[:, :, PACK_FAST - 1] > 0.0))              # [n, Wn]

        xb = [c[..., sb * Ksb:(sb + 1) * Ksb] for c in x]       # [n,T2,Ksb]
        dd = None
        for i in range(3):
            diff = xb[i][:, None] - cw[:, :, i, None, None]     # [n,Wn,T2,Ksb]
            dd = diff * diff if dd is None else dd + diff * diff
        dd = torch.where(row_ok[:, :, None, None], dd,
                         torch.full_like(dd, float("inf")))
        m = [torch.zeros_like(xb[0]) for _ in range(3)]
        wsum = torch.zeros_like(xb[0])
        for _ in range(num_seek):
            best, j = torch.min(dd, dim=1)                       # first min
            has = torch.isfinite(best)
            sel = torch.gather(
                cw[:, :, None, None, :].expand(n, Wn, T2, Ksb, PACK_FAST),
                1, j[:, None, :, :, None].expand(n, 1, T2, Ksb,
                                                 PACK_FAST))[:, 0]
            sel = torch.where(has[..., None], sel, torch.zeros_like(sel))
            q = [xb[i] - sel[..., i] for i in range(3)]
            pr = [sel[..., 3 + dd_i] + sel[..., 6 + 3 * dd_i] * q[0]
                  + sel[..., 7 + 3 * dd_i] * q[1]
                  + sel[..., 8 + 3 * dd_i] * q[2] for dd_i in range(3)]
            ok3 = has
            for i in range(3):
                ok3 = ok3 & (torch.abs(pr[i] - sel[..., 3 + i]) <= ip_dx)
            wgt = torch.where(ok3, torch.rsqrt(torch.clamp(best, min=1e-16)),
                              torch.zeros_like(best))
            m = [m[i] + wgt * pr[i] for i in range(3)]
            wsum = wsum + wgt
            dd = dd.scatter(1, j[:, None], float("inf"))
        found = wsum > 0.0
        invw = 1.0 / torch.clamp(wsum, min=1e-30)
        xs.append([torch.where(found, m[i] * invw, xb[i]) for i in range(3)])
        found_l.append(found)
    xm = [torch.cat([p[i] for p in xs], 2) for i in range(3)]
    return xm, torch.cat(found_l, 2), dropped


def _pad_tiles(B, tile_sc, bin_start, dirs, cand):
    """Pad the per-tile inputs to a multiple of B tiles with inactive slots
    (``dirs`` ones, the rest zeros; tile_kernel.py:684-698)."""
    pad = -tile_sc.shape[0] % B
    if pad == 0:
        return tile_sc, bin_start, dirs, cand

    def ext(t, fill):
        return torch.cat([t, torch.full((pad,) + tuple(t.shape[1:]), fill,
                                        dtype=t.dtype, device=t.device)], 0)
    return ext(tile_sc, 0), ext(bin_start, 0), ext(dirs, 1), ext(cand, 0)


def _resolve_paired(spec, packed_w, paired) -> bool:
    """``paired`` None infers the pairing from a 128-wide pack on a 64-wide
    net (tile_kernel.py:700-709); True demands that layout, False
    refuses it."""
    if paired is None:
        paired = is_paired(spec, packed_w)
    elif not paired and is_paired(spec, packed_w):
        raise ValueError("paired=False with a pack_weights_paired pack")
    if paired:
        lp = max(spec.num_layers, spec.num_layers_color)
        if tuple(packed_w.shape) != (lp, 128, 128) or not is_paired(
                spec, packed_w):
            raise ValueError(
                f"paired=True expects the pack_weights_paired layout "
                f"[{lp}, 128, 128] of a 64-wide net, got "
                f"{tuple(packed_w.shape)}")
    return bool(paired)


def _refuse_grid_schedule(spec, packed_w, paired, block_tiles) -> None:
    """The hash-grid net runs the f32 default schedule alone."""
    if not is_grid_pack(packed_w):
        return
    what = ("compute dtype " + spec.compute_dtype
            if spec.compute_dtype != "float32" else "the paired schedule"
            if paired else f"block_tiles {block_tiles}"
            if int(block_tiles) > 1 else None)
    if what is not None:
        raise NotImplementedError(
            f"the {GRID_NET} net runs the tile kernel's f32 default "
            f"schedule alone, not {what}")


def _grid_inside(xm, bound: float) -> torch.Tensor:
    """Which positions lie in the hash grid's box, as the kernel decides
    (each axis's (x + bound) / (2 bound) in [0, 1]; NaN outside)."""
    inside = None
    for c in xm:
        u = (c + bound) / (2.0 * bound)
        ok = (u >= 0.0) & (u <= 1.0)
        inside = ok if inside is None else inside & ok
    return inside


def render_tiles_plain(
    spec: NetworkSpec,
    packed_w: torch.Tensor,    # [L, Wd, Wd], the paired [lp, 128, 128] or a
    #                            GridPack
    tile_sc: torch.Tensor,     # [A, 8]  t0, t1, active
    bin_start: torch.Tensor,   # [A, >= K+4] int32
    params: torch.Tensor,      # [24]
    dirs: torch.Tensor,        # [A, 8, 256]
    cand: torch.Tensor,        # [A, P, 16]
    *, K: int, Ks: int, Ksb: int, Wn: int, num_seek: int,
    deformed: bool = True, cut: bool = False,
    stats: Optional[dict] = None,
    paired: Optional[bool] = None, block_tiles: int = 1,
) -> torch.Tensor:
    """Plain PyTorch version of the tile kernel, vectorised over tiles.
    Loops over segments and sub-segments with per-tile alive and skip
    masks, so the dropped count follows the kernel's rules. Static mode
    (``deformed=False``) reads no candidates and bends nothing; cut mode
    bends every sample, then keeps the bent position only strictly inside
    the cut box params[13:19] and renders the rest unbent, and drops the
    empty-segment skip. Returns out [A, 8, 256] (r, g, b, depth, ws,
    dropped, 0, 0). When given, ``stats["segments"]`` counts the (tile,
    segment) pairs executed, the data-dependent work a bound on the
    kernel's time is counted from, and ``stats["points"]`` and
    ``stats["passes"]`` the samples the f32 kernel's MLP evaluates and the
    passes of 256 they take: per group of up to 4 samples of a sub-segment,
    those with ``vmask`` on a ray whose transmittance at the group's start
    (less the kernel's rounding margin, ``csrc/tile_kernel.cuh:live_from``)
    is still >= T_thresh, and ceil(n / 256) passes for n of them. Given a
    list under ``stats["groups"]``, each executed group appends (tile,
    first sample, n). With a ``GridPack``, ``stats["inside"]`` counts those
    points that lie in the grid's box (each reads 16 x 8 table rows in the
    kernel), and the encoding is the hash grid's.

    ``paired`` follows the reference's pending/drain schedule on the
    block-diagonal pack: each executed segment's pass evaluates its sigma
    chain beside the previous executed segment's color chain (from the
    stored geo features), adds that segment's rgb against its stored
    weights, and the last pending segment drains after the loop.
    ``block_tiles`` pads the tiles to a multiple of B with inactive slots
    and cuts the output back, as the kernel's wrapper does."""
    _refuse_grid_schedule(spec, packed_w, paired, block_tiles)
    paired = _resolve_paired(spec, packed_w, paired)
    grid = is_grid_pack(packed_w)
    A0 = tile_sc.shape[0]
    tile_sc, bin_start, dirs, cand = _pad_tiles(
        max(1, block_tiles), tile_sc, bin_start, dirs, cand)
    dev = tile_sc.device
    cdt = torch_dtype(spec.compute_dtype)
    A = tile_sc.shape[0]
    t0, t1 = tile_sc[:, 0], tile_sc[:, 1]
    active = tile_sc[:, 2] > 0.0
    o = params[0:3]
    T_thresh, dscale, ip_dx = params[9], params[10], params[11]
    min_near, t_jit, reach = params[12], params[19], params[20]
    d = dirs[:, 0:3, :]                                         # [A, 3, T2]

    BIG = 3.4e38
    near = torch.full((A, T2), -BIG, device=dev)
    far = torch.full((A, T2), BIG, device=dev)
    for i in range(3):
        inv = 1.0 / d[:, i]
        ta = (params[3 + i] - o[i]) * inv
        tb = (params[6 + i] - o[i]) * inv
        near = torch.maximum(near, torch.minimum(ta, tb))
        far = torch.minimum(far, torch.maximum(ta, tb))
    thit = near <= far
    near = torch.maximum(near, min_near)

    dt_s = (t1 - t0) / K                                          # [A]
    sh = sh_encode((d[:, 0], d[:, 1], d[:, 2]),
                   feature_major=True).to(cdt)                  # [16, A, T2]
    if deformed:
        halo = torch.clamp(torch.ceil(reach / torch.clamp(dt_s, min=1e-9))
                           .to(torch.int64), min=1)
        bs = bin_start.to(torch.int64)

    out = torch.zeros((A, 8, T2), dtype=torch.float32, device=dev)
    cum = torch.zeros((A, T2), device=dev)
    dropped = torch.zeros((A,), dtype=torch.int64, device=dev)
    alive = active.clone()
    if paired:
        # per tile: the previous executed segment's geo features and
        # composite weights (f32, as the kernel's scratch), and whether one
        # is pending
        geo_prev = torch.zeros((A, 15, T2, Ks), device=dev)
        w_prev = torch.zeros((A, T2, Ks), device=dev)
        pending = torch.zeros((A,), dtype=torch.bool, device=dev)
    for s in range(K // Ks):
        run = alive
        if deformed and not cut:
            # whole-segment skip: no candidate in the segment's halo window
            slo, shi = _window_edges(bs, s * Ks + 1 - halo,
                                     s * Ks + Ks + 1 + halo, K)
            run = alive & ((shi - slo) > 0)
        idx = torch.nonzero(run)[:, 0]
        n = idx.shape[0]
        if stats is not None:
            stats["segments"] = stats.get("segments", 0) + n
        if n == 0:
            continue
        tdt = dt_s[idx]
        kk = (s * Ks + torch.arange(Ks, device=dev)).float()
        t = (t0[idx][:, None, None]
             + (kk[None, None, :] + t_jit) * tdt[:, None, None]
             ).expand(n, T2, Ks)
        dd_ = d[idx]                                             # [n,3,T2]
        x = [o[i] + t * dd_[:, i, :, None] for i in range(3)]   # [n,T2,Ks]
        if deformed:
            xm, found, drop = _bend_segment(
                x, cand[idx], bs[idx], halo[idx], s * Ks, ip_dx, K=K,
                Ksb=Ksb, Wn=Wn, num_seek=num_seek)
            dropped[idx] += drop
            if cut:
                # outside the cut box the static scene renders unbent
                in_cut = torch.ones_like(found)
                for i in range(3):
                    in_cut = (in_cut & (x[i] > params[13 + 2 * i])
                              & (x[i] < params[14 + 2 * i]))
                xm = [torch.where(in_cut, xm[i], x[i]) for i in range(3)]
                found = found | ~in_cut
        else:
            xm = x
            found = torch.ones((n, T2, Ks), dtype=torch.bool, device=dev)

        enc = encode_rows(tuple(c.reshape(-1) for c in xm), spec, cdt,
                          packed_w)
        shs = sh[:, idx][..., None].expand(16, n, T2, Ks).reshape(16, -1)
        if paired:
            gp = geo_prev[idx].to(cdt).permute(1, 0, 2, 3).reshape(15, -1)
            sigma, geo, rgb = mlp_paired_plain(packed_w, spec, enc, shs, gp)
        else:
            sigma, rgb = mlp_plain(packed_w, spec, enc, shs)
        sigma = sigma.reshape(n, T2, Ks)
        rgb = rgb.reshape(3, n, T2, Ks)

        vmask = (found & (t >= near[idx][..., None])
                 & (t <= far[idx][..., None]) & thit[idx][..., None])
        sg = torch.where(vmask, sigma * dscale, torch.zeros_like(sigma))
        tau = sg * tdt[:, None, None]
        csum = torch.cumsum(tau, dim=2)
        if stats is not None:
            _count_live(stats, idx, s * Ks, vmask, csum, cum[idx], dscale,
                        tdt, T_thresh, Ks=Ks, Ksb=Ksb,
                        inside=_grid_inside(xm, spec.bound) if grid
                        else None)
        c_before = cum[idx][..., None] + (csum - tau)
        T_prev = torch.exp(-c_before)
        wgt = torch.where(T_prev >= T_thresh,
                          (1.0 - torch.exp(-tau)) * T_prev,
                          torch.zeros_like(tau))
        # paired: rgb is the previous executed segment's, against its
        # stored weights (zero the first time through)
        wc = (w_prev[idx] * pending[idx].float()[:, None, None]
              if paired else wgt)
        acc = torch.stack([(wc * rgb[0]).sum(2), (wc * rgb[1]).sum(2),
                           (wc * rgb[2]).sum(2), (wgt * t).sum(2),
                           wgt.sum(2)], 1)                        # [n,5,T2]
        out[idx, 0:5] += acc
        cum[idx] = cum[idx] + csum[..., -1]
        alive[idx] = torch.exp(-cum[idx]).amax(dim=1) >= T_thresh
        if paired:
            geo_prev[idx] = geo.float().reshape(15, n, T2, Ks).permute(
                1, 0, 2, 3)
            w_prev[idx] = wgt
            pending[idx] = True
    if paired:
        # drain: the last pending segment's color chain (sigma input zeros)
        idx = torch.nonzero(pending)[:, 0]
        n = idx.shape[0]
        if n:
            gp = geo_prev[idx].to(cdt).permute(1, 0, 2, 3).reshape(15, -1)
            shs = sh[:, idx][..., None].expand(16, n, T2, Ks).reshape(16, -1)
            _, _, rgb = mlp_paired_plain(packed_w, spec, None, shs, gp)
            rgb = rgb.reshape(3, n, T2, Ks)
            wp = w_prev[idx]
            out[idx, 0:3] += torch.stack(
                [(wp * rgb[i]).sum(2) for i in range(3)], 1)
    out[:, 5] = torch.where(active, dropped, 0).float()[:, None]
    return out[:A0]


def _count_live(stats, idx, k_seg, vmask, csum, cum, dscale, dt_s, T_thresh,
                *, Ks, Ksb, inside=None):
    """Add one executed segment's live points and MLP passes (the f32
    kernel's compaction) to ``stats``: the segment from sample k_seg of
    tiles idx [n], vmask, csum [n, T2, Ks], cum [n, T2] before the
    segment, dt_s [n]; with ``inside`` [n, T2, Ks] (a hash grid's box)
    also ``stats["inside"]``, the live points inside."""
    tau_max = (SIGMA_BOUND * dscale) * dt_s                         # [n]
    bounded = (tau_max >= 0) & (tau_max < float("inf"))
    for k0 in range(Ks):
        if (k0 % Ksb) % 4:
            continue                          # not a group's first sample
        nk = min(4, Ksb - k0 % Ksb)
        S = csum[..., k0 - 1] if k0 else torch.zeros_like(cum)
        lo = S - (S + tau_max[:, None]) * 2.0 ** -21
        lo = torch.where(lo > 0, lo, torch.zeros_like(lo))
        dead = bounded[:, None] & (torch.exp(-(cum + lo)) < T_thresh)
        live = vmask[..., k0:k0 + nk] & ~dead[..., None]
        n = live.sum((1, 2))
        if inside is not None:
            stats["inside"] = stats.get("inside", 0) + int(
                (live & inside[..., k0:k0 + nk]).sum())
        stats["points"] = stats.get("points", 0) + int(n.sum())
        stats["passes"] = stats.get("passes", 0) + int(
            ((n + T2 - 1) // T2).sum())
        if "groups" in stats:
            stats["groups"] += [(int(a), k_seg + k0, int(c))
                                for a, c in zip(idx, n)]


def render_tiles(
    spec: NetworkSpec,
    packed_w: torch.Tensor,
    tile_sc: torch.Tensor,
    bin_start: torch.Tensor,
    params: torch.Tensor,
    dirs: torch.Tensor,
    cand: torch.Tensor,
    *, K: int, Ks: int, Ksb: int, Wn: int, num_seek: int,
    deformed: bool = True, cut: bool = False,
    paired: Optional[bool] = None, block_tiles: int = 1,
) -> torch.Tensor:
    """Run the fused tile kernel over A tiles -> out [A, 8, 256].

    CPU tensors take render_tiles_plain; CUDA tensors launch the kernel in
    the mode ``mode_of(deformed, cut)`` for the net (its width Wd, or
    ``GRID_NET`` for a ``GridPack``) and count the launch in
    ``render_tiles.launches[(mode, net, schedule, compute_dtype)]``
    (schedule "default", "paired" or "block"; a paired launch with B > 1
    counts as paired). ``paired`` None infers the
    pairing from the pack; ``block_tiles`` B > 1 renders B tiles per thread
    block, A padded to a multiple of B with inactive slots and the output
    cut back to A. The hash-grid net takes the f32 default schedule alone.
    Under ``torch.profiler`` the CUDA branch (argument
    checks and the ctypes launch) is the ``frame.tile_launch`` span, which
    the launched kernel links to, and a hash-grid launch adds to the
    device's counters (``read_grid_counters``)."""
    _check_shapes(cand, bin_start, K=K, Ks=Ks, Ksb=Ksb, Wn=Wn,
                  num_seek=num_seek, block_tiles=block_tiles)
    _refuse_grid_schedule(spec, packed_w, paired, block_tiles)
    B = int(block_tiles)
    kw = dict(K=K, Ks=Ks, Ksb=Ksb, Wn=Wn, num_seek=num_seek,
              deformed=deformed, cut=cut)
    if tile_sc.device.type == "cpu":
        return render_tiles_plain(spec, packed_w, tile_sc, bin_start, params,
                                  dirs, cand, **kw, paired=paired,
                                  block_tiles=B)
    with span(FRAME_TILE_LAUNCH):
        mode = mode_of(deformed, cut)
        wd = check_kernel_spec(spec, packed_w, allow_paired=True,
                               allow_grid=True)
        paired = _resolve_paired(spec, packed_w, paired)
        # the paired, block_tiles and hash-grid instantiations are
        # libraries of their own (one nvcc each, side by side)
        name = ("tile_grid" if wd == GRID_NET else "tile_paired" if paired
                else "tile_block" if B > 1 else "tile")
        ctr = (grid_counters_when_traced(tile_sc.device)
               if wd == GRID_NET else None)
        out = _launch(name, "pienerf_render_" + name.replace("tile", "tiles"),
                      spec, packed_w, tile_sc, bin_start, params, dirs, cand,
                      B, paired, wd, ctr, **kw)
        render_tiles.launches[launch_key(mode, wd, paired, B,
                                         spec.compute_dtype)] += 1
        return out


def render_tiles_timed(
    spec: NetworkSpec,
    packed_w: torch.Tensor,
    tile_sc: torch.Tensor,
    bin_start: torch.Tensor,
    params: torch.Tensor,
    dirs: torch.Tensor,
    cand: torch.Tensor,
    *, K: int, Ks: int, Ksb: int, Wn: int, num_seek: int,
    cut: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tile kernel's timed instantiation (f32 or bf16, the default
    schedule, deformed or cut mode, either width) on CUDA tensors -> (out,
    cycles).
    ``out`` equals ``render_tiles``'s bit for bit; ``cycles`` [A, 8,
    SPLIT_COLS] int64 holds, per tile and warp, the clock64() cycles of the
    five phases (window staging, scan, bend and blend, MLP with the f32
    path's compaction, composite with the segment's early exit), the
    tile's total cycles, its start and end on the global nanosecond timer,
    and the points the f32 MLP evaluated and the passes of 256 it ran (0
    in bf16); zeros for an inactive slot. A library built before the
    counts (``split_cols``) fills the first 8 columns only. A measurement
    for ``chip_smoke.py``; it counts no launch."""
    if tile_sc.device.type != "cuda":
        raise ValueError("render_tiles_timed runs on CUDA tensors only")
    _check_shapes(cand, bin_start, K=K, Ks=Ks, Ksb=Ksb, Wn=Wn,
                  num_seek=num_seek, block_tiles=1)
    wd = check_kernel_spec(spec, packed_w, allow_paired=False)
    cols = split_cols(_build.library("tile_timed"))
    cycles = torch.zeros((tile_sc.shape[0], T2 // 32, SPLIT_COLS),
                         dtype=torch.int64, device=tile_sc.device)
    # a library without the counts writes [A, 8, cols]: launch on a buffer
    # of that shape, then copy it in
    rec = cycles if cols == SPLIT_COLS else cycles[..., :cols].contiguous()
    out = _launch("tile_timed", "pienerf_render_tiles_timed", spec, packed_w,
                  tile_sc, bin_start, params, dirs, cand, 1, False, wd,
                  rec, K=K, Ks=Ks, Ksb=Ksb, Wn=Wn, num_seek=num_seek,
                  deformed=True, cut=cut)
    if rec is not cycles:
        cycles[..., :cols] = rec
    return out, cycles


def split_cols(lib) -> int:
    """The columns of a timed library's record: its
    ``pienerf_render_tiles_split_cols()``, or 8 for one built before the
    f32 path's counts (which has no such entry)."""
    fn = getattr(lib, "pienerf_render_tiles_split_cols", None)
    return len(SPLIT_PHASES) + 3 if fn is None else int(fn())


def _check_shapes(cand, bin_start, *, K, Ks, Ksb, Wn, num_seek,
                  block_tiles):
    """Raise on the sizes the kernel and its plain version refuse."""
    if cand.shape[1] < Wn:
        raise ValueError(f"candidate capacity {cand.shape[1]} must be >= "
                         f"window {Wn}")
    if bin_start.shape[1] < K + 4:
        raise ValueError(f"bin_start width {bin_start.shape[1]} < K + 4")
    if K % Ks or Ks % Ksb:
        raise ValueError(f"K={K}, Ks={Ks}, Ksb={Ksb} must nest")
    if not 1 <= num_seek <= 3:
        raise ValueError(f"num_seek {num_seek} must be 1..3")
    if int(block_tiles) < 1:
        raise ValueError(f"block_tiles {block_tiles} must be >= 1")


@functools.lru_cache(maxsize=8)
def grid_levels(grid: hash_encoder.HashGridSpec) -> np.ndarray:
    """The hash-grid kernel's per-level constants (``csrc/grid_encode.cuh``
    GridLevels) as 65 uint32 words: the levels' scales (f32 bits), dense
    strides (resolution + 1), rows and first rows, then the dense levels'
    bit mask; ``hash_encoder``'s constants, which its plain encoding
    uses."""
    scales, res, rows, first, dense = hash_encoder._level_constants(grid)
    mask = sum(1 << lvl for lvl in range(grid.num_levels) if dense[lvl])
    words = np.concatenate([scales.astype(np.float32).view(np.uint32),
                            (res + 1).astype(np.uint32),
                            rows.astype(np.uint32), first.astype(np.uint32),
                            np.array([mask], np.uint32)])
    words.setflags(write=False)
    return words


def grid_counters_when_traced(device) -> Optional[torch.Tensor]:
    """What a hash-grid launch on ``device`` takes as its counter buffer:
    while ``torch.profiler`` records, the device's running sums (int64 [4],
    ``GRID_COUNTERS``, made at first use), else None, and then the kernel
    reads no clock."""
    if not torch.autograd._profiler_enabled():
        return None
    bufs = render_tiles.grid_counters
    if device not in bufs:
        bufs[device] = torch.zeros(len(GRID_COUNTERS), dtype=torch.int64,
                                   device=device)
    return bufs[device]


def read_grid_counters(zero: bool = False) -> Dict[str, int]:
    """The hash-grid launches' counters summed over every device since
    they were last zeroed (``GRID_COUNTERS``: warp cycles in the encode
    stage, warp cycles of the whole tile, samples encoded, table rows
    read); all zero where no launch ran under a profiler. Reading waits
    for the device; ``zero`` then zeroes the sums."""
    total = [0] * len(GRID_COUNTERS)
    for buf in render_tiles.grid_counters.values():
        total = [a + b for a, b in zip(total, buf.tolist())]
        if zero:
            buf.zero_()
    return dict(zip(GRID_COUNTERS, total))


def _launch(lib_name, fn_name, spec, packed_w, tile_sc, bin_start, params,
            dirs, cand, B, paired, wd, cycles, *, K, Ks, Ksb, Wn, num_seek,
            deformed, cut):
    """Check the arguments, pad A to a multiple of B and launch the C entry
    ``fn_name`` of library ``lib_name`` -> out [A, 8, 256]. For the
    hash-grid net (``wd`` GRID_NET) ``cycles`` is the counter buffer or
    None."""
    dev = tile_sc.device
    A0 = tile_sc.shape[0]
    P, BS = cand.shape[1], bin_start.shape[1]
    tile_sc, bin_start, dirs, cand = _pad_tiles(B, tile_sc, bin_start, dirs,
                                                cand)
    A = tile_sc.shape[0]
    grid = wd == GRID_NET
    args = [(tile_sc, "tile_sc", torch.float32, (A, 8)),
            (bin_start, "bin_start", torch.int32, (A, BS)),
            (params, "params", torch.float32, (24,)),
            (dirs, "dirs", torch.float32, (A, 8, T2)),
            (cand, "cand", torch.float32, (A, P, PACK_FAST)),
            (packed_w, "packed_w", torch.float32,
             (4, 128, 128) if paired else (5, 64, 64) if grid
             else (7, wd, wd))]
    if grid:
        args.append((packed_w.table, "table", torch.float32,
                     (spec.grid.total_params, 2)))
    for t, name, dtype, shape in args:
        check_arg(t, name, dtype, shape, dev)
    # each sub-segment's window lands in shared memory by one bulk copy
    check_aligned(cand, "cand")
    out = torch.empty((A, 8, T2), dtype=torch.float32, device=dev)
    lib = _build.library(lib_name)
    fn = getattr(lib, fn_name)
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
    head = (tile_sc.data_ptr(), bin_start.data_ptr(), params.data_ptr(),
            dirs.data_ptr(), cand.data_ptr(), packed_w.data_ptr(),
            out.data_ptr(), A, B, BS, P, K, Ks, Ksb, Wn, num_seek,
            float(spec.bound))
    if grid:
        # the table's rows are read as float2: 8-byte aligned
        check_aligned(packed_w.table, "table", 8)
        levels = grid_levels(spec.grid)
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [
            ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
        rc = fn(*head, int(deformed), int(cut), packed_w.table.data_ptr(),
                levels.ctypes.data,
                None if cycles is None else cycles.data_ptr(), stream)
    else:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [
            ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * (
                2 if cycles is not None else 1)
        extra = () if cycles is None else (cycles.data_ptr(),)
        rc = fn(*head, int(spec.compute_dtype == "bfloat16"),
                int(deformed), int(cut), wd, *extra, stream)
    _build.check(lib, rc, fn_name)
    return out[:A0]


def launch_key(mode: str, wd, paired: bool, block_tiles: int, dtype: str):
    """The ``render_tiles.launches`` entry a launch counts in: (mode, net,
    schedule, compute dtype), the net its width or ``GRID_NET``, the
    schedule one of ``SCHEDULES``, the dtype one of ``DTYPES``."""
    return (mode, wd, "paired" if paired
            else "block" if block_tiles > 1 else "default", dtype)


def net_label(wd) -> str:
    """A launch key's net as the entry points print it: ``w64``, ``w128``
    or ``hashgrid``."""
    return wd if wd == GRID_NET else f"w{wd}"


SCHEDULES = ("default", "paired", "block")
DTYPES = ("float32", "bfloat16")
render_tiles.launches = {
    (m, wd, v, t): 0 for m in MODES for wd in WIDTHS for v in SCHEDULES
    for t in DTYPES if not (v == "paired" and wd != 64)}
render_tiles.launches.update(
    {(m, GRID_NET, "default", "float32"): 0 for m in MODES})
# the hash-grid counters' running sums, by device
# (grid_counters_when_traced)
render_tiles.grid_counters = {}
