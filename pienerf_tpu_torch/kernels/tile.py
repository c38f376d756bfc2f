"""Fused per-tile frame kernel: candidate prep, the CUDA kernel
``csrc/tile_kernel.cu`` and its plain PyTorch version.

Port of ``pienerf_tpu.ops.pallas.tile_kernel`` with one tile per block, at
both packed widths (``kernels.field.KERNEL_NETS``: Wd 64 and the 128-wide
student), in its three frame modes: deformed (bend every sample), static
(``deformed=False``: no candidates, no bending) and cut (``deformed=True,
cut=True``: bend only inside the cut box). The paired and ``block_tiles``
variants are not ported yet (ROADMAP.md §2). ``render_tiles`` launches the
kernel for CUDA tensors and takes ``render_tiles_plain`` only for CPU
tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from pienerf_tpu_torch.kernels import _build
from pienerf_tpu_torch.kernels.field import (WIDTHS, check_arg,
                                             check_kernel_spec, encode_rows,
                                             mlp_plain)
from pienerf_tpu_torch.models.network import NetworkSpec, torch_dtype
from pienerf_tpu_torch.models.sh_encoder import sh_encode

T2 = 256          # rays per 16x16 tile
PACK_FAST = 16    # candidate rows: p_def(3) p_ori(3) F^-1(9) valid(1)
MODES = ("deformed", "static", "cut")


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


def render_tiles_plain(
    spec: NetworkSpec,
    packed_w: torch.Tensor,    # [L, Wd, Wd]
    tile_sc: torch.Tensor,     # [A, 8]  t0, t1, active
    bin_start: torch.Tensor,   # [A, >= K+4] int32
    params: torch.Tensor,      # [24]
    dirs: torch.Tensor,        # [A, 8, 256]
    cand: torch.Tensor,        # [A, P, 16]
    *, K: int, Ks: int, Ksb: int, Wn: int, num_seek: int,
    deformed: bool = True, cut: bool = False,
    stats: Optional[dict] = None,
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
    kernel's time is counted from."""
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

        enc = encode_rows(tuple(c.reshape(-1) for c in xm), spec, cdt)
        shs = sh[:, idx][..., None].expand(16, n, T2, Ks).reshape(16, -1)
        sigma, rgb = mlp_plain(packed_w, spec, enc, shs)
        sigma = sigma.reshape(n, T2, Ks)
        rgb = rgb.reshape(3, n, T2, Ks)

        vmask = (found & (t >= near[idx][..., None])
                 & (t <= far[idx][..., None]) & thit[idx][..., None])
        sg = torch.where(vmask, sigma * dscale, torch.zeros_like(sigma))
        tau = sg * tdt[:, None, None]
        csum = torch.cumsum(tau, dim=2)
        c_before = cum[idx][..., None] + (csum - tau)
        T_prev = torch.exp(-c_before)
        wgt = torch.where(T_prev >= T_thresh,
                          (1.0 - torch.exp(-tau)) * T_prev,
                          torch.zeros_like(tau))
        acc = torch.stack([(wgt * rgb[0]).sum(2), (wgt * rgb[1]).sum(2),
                           (wgt * rgb[2]).sum(2), (wgt * t).sum(2),
                           wgt.sum(2)], 1)                        # [n,5,T2]
        out[idx, 0:5] += acc
        cum[idx] = cum[idx] + csum[..., -1]
        alive[idx] = torch.exp(-cum[idx]).amax(dim=1) >= T_thresh
    out[:, 5] = torch.where(active, dropped, 0).float()[:, None]
    return out


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
) -> torch.Tensor:
    """Run the fused tile kernel over A tiles -> out [A, 8, 256].

    CPU tensors take render_tiles_plain; CUDA tensors launch the kernel in
    the mode ``mode_of(deformed, cut)`` at the pack's width Wd and count
    the launch in ``render_tiles.launches[(mode, Wd)]``."""
    A, P = cand.shape[0], cand.shape[1]
    BS = bin_start.shape[1]
    if P < Wn:
        raise ValueError(f"candidate capacity {P} must be >= window {Wn}")
    if BS < K + 4:
        raise ValueError(f"bin_start width {BS} < K + 4")
    if K % Ks or Ks % Ksb:
        raise ValueError(f"K={K}, Ks={Ks}, Ksb={Ksb} must nest")
    if not 1 <= num_seek <= 3:
        raise ValueError(f"num_seek {num_seek} must be 1..3")
    kw = dict(K=K, Ks=Ks, Ksb=Ksb, Wn=Wn, num_seek=num_seek,
              deformed=deformed, cut=cut)
    if tile_sc.device.type == "cpu":
        return render_tiles_plain(spec, packed_w, tile_sc, bin_start, params,
                                  dirs, cand, **kw)
    dev = tile_sc.device
    mode = mode_of(deformed, cut)
    wd = check_kernel_spec(spec, packed_w)
    for t, name, dtype, shape in (
            (tile_sc, "tile_sc", torch.float32, (A, 8)),
            (bin_start, "bin_start", torch.int32, (A, BS)),
            (params, "params", torch.float32, (24,)),
            (dirs, "dirs", torch.float32, (A, 8, T2)),
            (cand, "cand", torch.float32, (A, P, PACK_FAST)),
            (packed_w, "packed_w", torch.float32, (7, wd, wd))):
        check_arg(t, name, dtype, shape, dev)
    out = torch.empty((A, 8, T2), dtype=torch.float32, device=dev)
    lib = _build.library("tile")
    fn = lib.pienerf_render_tiles
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [
        ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
    rc = fn(tile_sc.data_ptr(), bin_start.data_ptr(), params.data_ptr(),
            dirs.data_ptr(), cand.data_ptr(), packed_w.data_ptr(),
            out.data_ptr(), A, BS, P, K, Ks, Ksb, Wn, num_seek,
            float(spec.bound), int(spec.compute_dtype == "bfloat16"),
            int(deformed), int(cut), wd, stream)
    _build.check(lib, rc, "render_tiles")
    render_tiles.launches[(mode, wd)] += 1
    return out


render_tiles.launches = {(m, wd): 0 for m in MODES for wd in WIDTHS}
