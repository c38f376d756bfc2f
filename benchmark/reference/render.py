"""Plain reference of the viewer's fused frame: the per-IP pack, tile
activity and compaction (with the cut split), candidate prep, and the tile
renderer with the field in plain PyTorch: the Fourier MLP (backbone
``mlp``) or torch-ngp's hash-grid field (backbone ``hashgrid``,
``hashgrid.py``), by the configuration's backbone.

A frozen copy of the plain code of the program's fused path (its pack,
``render_frame_fused``, ``prep_candidates`` and ``render_tiles_plain`` in
the default schedule), written against the field's raw [in, out] weight
matrices instead of the program's packed tiles. It imports nothing of the
program under test and nothing of JAX. ``Pass`` records, for each tile
pass, what these inputs need of a renderer: the samples the field is
needs evaluated at, the (sample, window row) pairs its bends scan, and the
bytes of the pass's inputs and outputs; with the hash grid also the
encoding's operations at the needed samples and the bytes of the distinct
table rows their corners read (each has to be read at least once). A
sample is needed where it can
change the output: its ray hits the box, it lies in [near, far] and its
ray's transmittance before it is still at or above ``T_thresh`` (in cut
mode a bend also needs the sample inside the cut box, and a field
evaluation needs its bend to have found a row).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional

import torch

from . import hashgrid

T2 = 256          # rays per 16x16 tile
TILE = 16
PACK = 16         # candidate rows: p_def(3) p_ori(3) F^-1(9) valid(1)


class Settings(NamedTuple):
    """What a fused frame reads from the configuration."""
    samples: int           # K
    num_seek: int
    ip_dx: float
    ips_per_tile: int      # P
    bend_window: int       # Wn
    active_frac: float
    tile_chunk: int
    min_near: float
    T_thresh: float
    tighten: bool
    cut: bool
    bound: float
    cut_static_frac: float
    n_freqs: int
    dtype: str = "float32"   # the field's: float32 or bfloat16
    seg_samples: int = 8
    bend_sub: int = 4
    backbone: str = "mlp"    # the field's encoding: mlp or hashgrid
    grid: Optional[hashgrid.Grid] = None     # hashgrid's table layout

    @property
    def reach(self) -> float:
        return 2.0 * self.ip_dx

    @property
    def margin(self) -> float:
        return max(0.08, self.reach)


class Pass(NamedTuple):
    """The work one tile pass needs (see the module docstring)."""
    mode: str              # "deformed", "static" or "cut"
    slots: int             # A
    samples: int           # field evaluations the output needs
    bend_rows: int         # (needed bend, live window row) pairs
    bytes: int             # inputs read once and outputs written once
    grid_flops: int = 0    # the hash encoding's operations (f32)
    grid_bytes: int = 0    # distinct table rows read, x C x 4 B


# ---------------------------------------------------------------------------
# the field
# ---------------------------------------------------------------------------

SH_C = (0.28209479177387814, 0.48860251190291987,
        (1.0925484305920792, 0.94617469575755997, 0.31539156525251999,
         0.54627421529603959),
        (0.59004358992664352, 2.8906114426405538, 0.45704579946446572,
         0.3731763325901154, 1.4453057213202769))


def sh_encode4(x, y, z):
    """Degree-4 real spherical harmonics, [16, ...] (the tcnn basis)."""
    C0, C1, C2, C3 = SH_C
    xy, xz, yz = x * y, x * z, y * z
    x2, y2, z2 = x * x, y * y, z * z
    return torch.stack([
        C0 * torch.ones_like(x), -C1 * y, C1 * z, -C1 * x,
        C2[0] * xy, -C2[0] * yz, C2[1] * z2 - C2[2], -C2[0] * xz,
        C2[3] * (x2 - y2),
        C3[0] * y * (-3.0 * x2 + y2), C3[1] * xy * z,
        C3[2] * y * (1.0 - 5.0 * z2), C3[3] * z * (5.0 * z2 - 3.0),
        C3[2] * x * (1.0 - 5.0 * z2), C3[4] * z * (x2 - y2),
        C3[0] * x * (-x2 + 3.0 * y2)], dim=0)


def freq_encode(comps, n_freqs, bound):
    """[x, sin(2^k pi x), cos(2^k pi x)] per axis by the double-angle
    ladder, feature-major [3 (2 n_freqs + 1), N]."""
    rows = []
    for c in comps:
        cn = c.reshape(-1) / bound
        rows.append(cn)
        s, co = torch.sin(math.pi * cn), torch.cos(math.pi * cn)
        sins, coss = [s], [co]
        for _ in range(n_freqs - 1):
            s, co = 2.0 * s * co, co * co - s * s
            sins.append(s)
            coss.append(co)
        rows.extend(sins)
        rows.extend(coss)
    return torch.stack(rows, 0)


def field(layers, enc, sh, dtype: str = "float32"):
    """The bias-free Fourier MLP: enc [F, M], sh [16, M] -> (sigma [M],
    rgb [3, M]). ``layers`` = (sigma_net, color_net), [in, out] each. In
    bf16 the inputs, the weights and every layer's output are rounded to
    bf16 and each product sums in f32, as the fused kernels do."""
    cdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]

    def chain(h, net):
        for i, w in enumerate(net):
            h = (w.to(cdt).float().T @ h.float()).to(cdt)
            if i != len(net) - 1:
                h = torch.relu(h)
        return h

    sigma_net, color_net = layers
    h = chain(enc.to(cdt), sigma_net)
    sigma = torch.exp(torch.clamp(h[0].float(), -15.0, 15.0))
    hc = chain(torch.cat([sh.to(cdt), h[1:16]], 0), color_net)
    return sigma, torch.sigmoid(hc[:3].float())


def macs_per_sample(layers) -> int:
    return sum(int(w.shape[0]) * int(w.shape[1]) for net in layers
               for w in net)


# ---------------------------------------------------------------------------
# the per-IP pack
# ---------------------------------------------------------------------------

def _inv3x3(a):
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
    c01 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
    det = a[..., 0, 0] * c00 + a[..., 0, 1] * c01 + a[..., 0, 2] * c02
    ok = torch.abs(det) > 1e-20
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)),
                          torch.zeros_like(det))
    adj = torch.stack([
        torch.stack([c00,
                     a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2],
                     a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]],
                    -1),
        torch.stack([c01,
                     a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0],
                     a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]],
                    -1),
        torch.stack([c02,
                     a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1],
                     a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]],
                    -1)], -2)
    return inv_det[..., None, None] * adj, ok


def pack_ips(p_def, p_ori, F):
    """[nIP, 16] rows: p_def, p_ori, F^-1 row-major, valid."""
    n = p_def.shape[0]
    Finv, ok = _inv3x3(F)
    return torch.cat([p_def, p_ori, Finv.reshape(n, 9),
                      ok.to(p_def.dtype)[:, None]], dim=1)


# ---------------------------------------------------------------------------
# tile activity, compaction, the cut split
# ---------------------------------------------------------------------------

def _tile_rays(tids, H, W, pose, intr):
    fx, fy, cx, cy = intr
    tx, ty = tids % (W // TILE), tids // (W // TILE)
    j = torch.arange(T2, dtype=torch.int64, device=tids.device)
    py = (ty[:, None] * TILE + j[None, :] // TILE).float() + 0.5
    px = (tx[:, None] * TILE + j[None, :] % TILE).float() + 0.5
    dx, dy = (px - cx) / fx, (py - cy) / fy
    nrm = torch.sqrt(dx * dx + dy * dy + 1.0)
    cam = (dx / nrm, dy / nrm, torch.ones_like(dx) / nrm)
    R = pose[:3, :3]
    return pose[:3, 3], tuple(R[i, 0] * cam[0] + R[i, 1] * cam[1]
                              + R[i, 2] * cam[2] for i in range(3))


def _near_far(o, d, bbmin, bbmax, min_near):
    BIG = torch.tensor(3.4e38, dtype=torch.float32, device=d[0].device)
    near = far = None
    for i in range(3):
        inv = 1.0 / d[i]
        ta, tb = (bbmin[i] - o[i]) * inv, (bbmax[i] - o[i]) * inv
        lo, hi = torch.minimum(ta, tb), torch.maximum(ta, tb)
        near = lo if near is None else torch.maximum(near, lo)
        far = hi if far is None else torch.minimum(far, hi)
    miss = near > far
    near = torch.clamp(near, min=min_near)
    return torch.where(miss, BIG, near), torch.where(miss, BIG, far)


def _tile_span(near, far, mask):
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


def _beam(st, p_def, origin_rows, axis, tan_half, t0, t1):
    """In-beam test of every IP against every tile's beam: (ok [A, nIP],
    proj [A, nIP])."""
    proj = lat2 = None
    for i in range(3):
        rel = p_def[None, :, i] - origin_rows[:, i:i + 1]
        c = rel * axis[:, i:i + 1]
        proj = c if proj is None else proj + c
        lat2 = rel * rel if lat2 is None else lat2 + rel * rel
    lat2 = lat2 - proj * proj
    m = st.margin
    radius = tan_half[:, None] * torch.clamp(proj, min=0.0) + m
    ok = ((lat2 <= radius * radius) & (proj >= t0[:, None] - m)
          & (proj <= t1[:, None] + m))
    return ok, proj


def _compact(mask, cap, all_tids):
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    take = mask & (rank < cap)
    ids = torch.zeros((cap + 1,), dtype=torch.int64, device=mask.device)
    ids.scatter_(0, torch.where(take, rank, cap), torch.where(take, all_tids, 0))
    n = take.sum()
    return ids[:cap], torch.arange(cap, device=mask.device) < n, n, \
        mask.sum() - n


def _cap(frac, n_tiles, chunk):
    return max(chunk, (int(n_tiles * frac) // chunk) * chunk)


def _tile_hits(bbmin, bbmax, pose, intr, H, W, min_near):
    n_tiles = (H // TILE) * (W // TILE)
    tids = torch.arange(n_tiles, dtype=torch.int64, device=pose.device)
    o, d = _tile_rays(tids, H, W, pose, intr)
    near, far = _near_far(o, d, bbmin, bbmax, min_near)
    return tids, o, d, near, far, (near < 1e30).any(1)


# ---------------------------------------------------------------------------
# candidate prep and the tile renderer
# ---------------------------------------------------------------------------

def prep_candidates(st, pack, p_def, origin, axis, tan_half, t0, t1, n_bins,
                    tighten_margin):
    """Depth-sorted beam candidates [A, P, 16] with invalid rows last, the
    per-bin prefix counts [A, n_bins + 2], drops [A] and the (tightened)
    span."""
    P = st.ips_per_tile
    ok, proj = _beam(st, p_def, origin, axis, tan_half, t0, t1)
    keyv = torch.where(ok, -proj, torch.full_like(proj, -float("inf")))
    k_eff = min(P, keyv.shape[1])
    negproj, ids = torch.sort(keyv, dim=1, descending=True, stable=True)
    negproj, ids = negproj[:, :k_eff], ids[:, :k_eff]
    if k_eff < P:
        negproj = torch.cat([negproj, torch.full(
            (negproj.shape[0], P - k_eff), -float("inf"),
            device=proj.device)], 1)
        ids = torch.cat([ids, torch.zeros((ids.shape[0], P - k_eff),
                                          dtype=ids.dtype,
                                          device=ids.device)], 1)
    cproj = -negproj
    valid = torch.isfinite(cproj)
    count = valid.sum(dim=1)
    n_dropped = ok.sum(dim=1) - count
    cproj = torch.where(valid, cproj, torch.full_like(cproj, float("inf")))
    cand = pack[ids]
    cand[..., PACK - 1] = torch.where(valid, cand[..., PACK - 1],
                                      torch.zeros_like(cproj))
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
    edges = t0e[:, None] + (torch.arange(n_bins + 1, dtype=torch.float32,
                                         device=t0.device)[None, :]
                            - 1.0) * dt[:, None]
    bin_start = (cproj[:, :, None] < edges[:, None, :]).sum(dim=1)
    bin_start = torch.cat([bin_start, count[:, None]], 1).to(torch.int32)
    return cand, bin_start, n_dropped, t0e, t1e


def _gather_bs(bs, idx):
    return torch.gather(bs, 1, idx[:, None])[:, 0]


def _window_edges(bs, i_lo, i_hi, K):
    lo = torch.where(i_lo <= 0, 0, _gather_bs(bs, i_lo.clamp(min=0)))
    hi = torch.where(i_hi >= K + 2, bs[:, K + 3],
                     _gather_bs(bs, i_hi.clamp(max=K + 2)))
    return lo, hi


def _bend_segment(x, cand, bs, halo, k_seg, ip_dx, K, Ksb, Wn, num_seek):
    """Bend a segment's samples x (3 x [n, T2, Ks]) through each Ksb-deep
    sub-segment's window of Wn candidate rows: num_seek nearest rows, the
    exact single step through F^-1, the per-axis ip_dx reject and the
    inverse-distance blend. Returns (bent x, found, window drops [n], live
    window rows [n, Ks // Ksb])."""
    n, _, Ks = x[0].shape
    P = cand.shape[1]
    dev = x[0].device
    ri = torch.arange(Wn, device=dev)
    dropped = torch.zeros((n,), dtype=torch.int64, device=dev)
    xs, found_l, live = [], [], []
    for sb in range(Ks // Ksb):
        k0 = k_seg + sb * Ksb
        lo, hi = _window_edges(bs, k0 + 1 - halo, k0 + Ksb + 1 + halo, K)
        own_lo, own_hi = bs[:, k0 + 1], bs[:, k0 + Ksb + 1]
        a = own_lo - torch.div(Wn - (own_hi - own_lo), 2,
                               rounding_mode="floor")
        a = torch.minimum(torch.maximum(a, lo), torch.maximum(lo, hi - Wn))
        a = a.clamp(0, P - Wn)
        dropped += torch.clamp(hi - lo - Wn, min=0)
        rows = a[:, None] + ri[None, :]
        cw = torch.gather(cand, 1, rows[:, :, None].expand(n, Wn, PACK))
        row_ok = ((ri[None, :] >= (lo - a)[:, None])
                  & (ri[None, :] < (hi - a)[:, None])
                  & (cw[:, :, PACK - 1] > 0.0))
        live.append(row_ok.sum(dim=1))
        xb = [c[..., sb * Ksb:(sb + 1) * Ksb] for c in x]
        dd = None
        for i in range(3):
            diff = xb[i][:, None] - cw[:, :, i, None, None]
            dd = diff * diff if dd is None else dd + diff * diff
        dd = torch.where(row_ok[:, :, None, None], dd,
                         torch.full_like(dd, float("inf")))
        m = [torch.zeros_like(xb[0]) for _ in range(3)]
        wsum = torch.zeros_like(xb[0])
        for _ in range(num_seek):
            best, j = torch.min(dd, dim=1)
            has = torch.isfinite(best)
            sel = torch.gather(
                cw[:, :, None, None, :].expand(n, Wn, T2, Ksb, PACK), 1,
                j[:, None, :, :, None].expand(n, 1, T2, Ksb, PACK))[:, 0]
            sel = torch.where(has[..., None], sel, torch.zeros_like(sel))
            q = [xb[i] - sel[..., i] for i in range(3)]
            pr = [sel[..., 3 + e] + sel[..., 6 + 3 * e] * q[0]
                  + sel[..., 7 + 3 * e] * q[1] + sel[..., 8 + 3 * e] * q[2]
                  for e in range(3)]
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
    return ([torch.cat([p[i] for p in xs], 2) for i in range(3)],
            torch.cat(found_l, 2), dropped, torch.stack(live, 1))


def render_tiles(st, layers, tile_sc, bin_start, params, dirs, cand, *,
                 deformed, cut, work, table=None):
    """One tile pass -> out [A, 8, 256] (r, g, b, depth, ws, dropped, 0,
    0): per early-exit segment of Ks samples, the bend (deformed and cut
    modes; cut keeps it strictly inside the cut box), the field and the
    front-to-back composite while the transmittance stays >= T_thresh.
    ``work`` adds the needed samples and bend rows (module docstring),
    and with a ``seen`` row mask the table rows and operations of the hash
    encoding at them. ``table``: the hash grid's [rows, C]."""
    K = st.samples
    Ks = st.seg_samples if K % st.seg_samples == 0 else next(
        k for k in (16, 8, 4, 2, 1) if K % k == 0)
    Ksb = st.bend_sub if Ks % st.bend_sub == 0 else Ks
    Wn = min(st.bend_window, st.ips_per_tile)
    dev = tile_sc.device
    A = tile_sc.shape[0]
    t0, t1 = tile_sc[:, 0], tile_sc[:, 1]
    active = tile_sc[:, 2] > 0.0
    o = params[0:3]
    T_thresh, dscale, ip_dx = params[9], params[10], params[11]
    min_near, t_jit, reach = params[12], params[19], params[20]
    d = dirs[:, 0:3, :]
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
    dt_s = (t1 - t0) / K
    sh = sh_encode4(d[:, 0], d[:, 1], d[:, 2])                 # [16, A, T2]
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
            slo, shi = _window_edges(bs, s * Ks + 1 - halo,
                                     s * Ks + Ks + 1 + halo, K)
            run = alive & ((shi - slo) > 0)
        idx = torch.nonzero(run)[:, 0]
        n = idx.shape[0]
        if n == 0:
            continue
        tdt = dt_s[idx]
        kk = (s * Ks + torch.arange(Ks, device=dev)).float()
        t = (t0[idx][:, None, None]
             + (kk[None, None, :] + t_jit) * tdt[:, None, None]
             ).expand(n, T2, Ks)
        dd_ = d[idx]
        x = [o[i] + t * dd_[:, i, :, None] for i in range(3)]
        if deformed:
            in_cut = torch.ones((n, T2, Ks), dtype=torch.bool, device=dev)
            if cut:
                for i in range(3):
                    in_cut = (in_cut & (x[i] > params[13 + 2 * i])
                              & (x[i] < params[14 + 2 * i]))
            xm, found, drop, live = _bend_segment(
                x, cand[idx], bs[idx], halo[idx], s * Ks, ip_dx, K, Ksb, Wn,
                st.num_seek)
            dropped[idx] += drop
            if cut:
                xm = [torch.where(in_cut, xm[i], x[i]) for i in range(3)]
                found = found | ~in_cut
        else:
            xm = x
            found = torch.ones((n, T2, Ks), dtype=torch.bool, device=dev)
        if st.backbone == "hashgrid":
            enc = hashgrid.encode(table, st.grid, xm, st.bound)
        else:
            enc = freq_encode(xm, st.n_freqs, st.bound)
        shs = sh[:, idx][..., None].expand(16, n, T2, Ks).reshape(16, -1)
        sigma, rgb = field(layers, enc, shs, st.dtype)
        sigma = sigma.reshape(n, T2, Ks)
        rgb = rgb.reshape(3, n, T2, Ks)
        in_range = ((t >= near[idx][..., None]) & (t <= far[idx][..., None])
                    & thit[idx][..., None])
        vmask = found & in_range
        sg = torch.where(vmask, sigma * dscale, torch.zeros_like(sigma))
        tau = sg * tdt[:, None, None]
        csum = torch.cumsum(tau, dim=2)
        T_prev = torch.exp(-(cum[idx][..., None] + (csum - tau)))
        lit = T_prev >= T_thresh
        wgt = torch.where(lit, (1.0 - torch.exp(-tau)) * T_prev,
                          torch.zeros_like(tau))
        work["samples"] += int((vmask & lit).sum())
        if "seen" in work:
            need = vmask & lit
            n_in = hashgrid.touch(work["seen"], st.grid,
                                  [c[need] for c in xm], st.bound)
            work["grid_flops"] += hashgrid.flops_per_sample(st.grid) * n_in
        if deformed:
            bent = (in_range & lit & in_cut).reshape(n, T2, Ks // Ksb, Ksb)
            work["bend_rows"] += int((bent.sum(dim=(1, 3)) * live).sum())
        out[idx, 0:5] += torch.stack(
            [(wgt * rgb[0]).sum(2), (wgt * rgb[1]).sum(2),
             (wgt * rgb[2]).sum(2), (wgt * t).sum(2), wgt.sum(2)], 1)
        cum[idx] = cum[idx] + csum[..., -1]
        alive[idx] = torch.exp(-cum[idx]).amax(dim=1) >= T_thresh
    out[:, 5] = torch.where(active, dropped, 0).float()[:, None]
    return out


def _tile_pass(st, layers, pack, p_def, o, pose, intr, H, W, ids, mask,
               bbmin, bbmax, *, deformed, cut, cut_box, passes, table):
    """Candidate prep and one tile pass over a compacted slot list; the
    pass's work goes to ``passes``. Returns (imgs [A, T2, 3], depths, wss,
    dropped_beam, dropped_window)."""
    dev = o.device
    K = st.samples
    A = ids.shape[0]
    o_, d = _tile_rays(ids, H, W, pose, intr)
    near, far = _near_far(o_, d, bbmin, bbmax, st.min_near)
    t0, t1, any_hit = _tile_span(near, far, mask)
    dirs = torch.zeros((A, 8, T2), dtype=torch.float32, device=dev)
    for i in range(3):
        dirs[:, i, :] = d[i]
    if deformed:
        axis = _central_axis(d)
        tan_half = torch.full((A,), TILE * 0.75 / intr[0],
                              dtype=torch.float32, device=dev)
        tmarg = (max(3.0 * st.ip_dx, st.reach + st.ip_dx)
                 if st.tighten and not cut else 0.0)
        cand, bin_start, n_drop, t0, t1 = prep_candidates(
            st, pack, p_def, o.expand(A, 3), axis, tan_half, t0, t1, K + 2,
            tmarg)
        dropped_beam = torch.where(mask, n_drop, 0).sum()
    else:
        cand = torch.zeros((A, max(st.ips_per_tile, 64), PACK),
                           dtype=torch.float32, device=dev)
        bin_start = torch.zeros((A, K + 4), dtype=torch.int32, device=dev)
        dropped_beam = torch.zeros((), dtype=torch.int64, device=dev)
    tile_sc = torch.zeros((A, 8), dtype=torch.float32, device=dev)
    tile_sc[:, 0], tile_sc[:, 1], tile_sc[:, 2] = t0, t1, any_hit.float()
    params = torch.zeros((24,), dtype=torch.float32, device=dev)
    params[0:3] = o
    params[3:6] = bbmin
    params[6:9] = bbmax
    params[9] = st.T_thresh
    params[10] = 1.0
    params[11] = st.ip_dx
    params[12] = st.min_near
    if cut:
        params[13:19] = cut_box
    params[19] = 0.5
    params[20] = st.reach
    work = {"samples": 0, "bend_rows": 0}
    if st.backbone == "hashgrid":
        work.update(grid_flops=0, seen=torch.zeros(
            (st.grid.rows,), dtype=torch.bool, device=dev))
    out = render_tiles(st, layers, tile_sc, bin_start, params, dirs, cand,
                       deformed=deformed, cut=cut, work=work, table=table)
    # the pass reads its slots' scalars, the frame's params, the rays, the
    # weights and, when it bends, the candidates and their bin counts; it
    # writes one [8, 256] row a slot
    read = [tile_sc, params, dirs] + ([cand, bin_start] if deformed else [])
    nbytes = (sum(t.numel() * t.element_size() for t in read)
              + sum(w.numel() * 4 for net in layers for w in net)
              + out.numel() * 4)
    grid_bytes = 0 if "seen" not in work else (
        int(work["seen"].sum()) * st.grid.level_dim * table.element_size())
    passes.append(Pass(mode="static" if not deformed else
                       "cut" if cut else "deformed", slots=A,
                       samples=work["samples"], bend_rows=work["bend_rows"],
                       bytes=nbytes, grid_flops=work.get("grid_flops", 0),
                       grid_bytes=grid_bytes))
    imgs = out[:, 0:3, :].transpose(1, 2)
    dropped_window = torch.where(mask, out[:, 5, 0], 0.0).sum()
    return imgs, out[:, 3, :], out[:, 4, :], dropped_beam, dropped_window


def _scatter(n_tiles, bg, parts):
    dev = parts[0][2].device
    bgv = torch.as_tensor(bg, dtype=torch.float32, device=dev).expand(3)
    frame = torch.zeros((n_tiles + 1, T2, 3), device=dev) + bgv
    fdepth = torch.zeros((n_tiles + 1, T2), device=dev)
    fws = torch.zeros((n_tiles + 1, T2), device=dev)
    for ids, mask, imgs, depths, wss in parts:
        safe = torch.where(mask, ids, n_tiles)
        frame[safe] = imgs + (1.0 - wss)[..., None] * bgv
        fdepth[safe] = depths
        fws[safe] = wss
    return frame[:n_tiles], fdepth[:n_tiles], fws[:n_tiles]


def render_frame(st: Settings, layers, pack, p_def, pose, intr, H, W, bg,
                 cut_box: Optional[torch.Tensor] = None,
                 passes: Optional[List[Pass]] = None,
                 table: Optional[torch.Tensor] = None):
    """The viewer's fused frame with the cut split in cut mode (``table``:
    the hash grid's, for that backbone). Returns
    (image [n_tiles, T2, 3] composited on ``bg``, counters [4] int64:
    n_active, dropped_beam, dropped_window, n_tile_overflow)."""
    passes = [] if passes is None else passes
    n_tiles = (H // TILE) * (W // TILE)
    if st.cut:
        hi = torch.full((3,), st.bound + 1e-3, dtype=torch.float32,
                        device=pose.device)
        bbmin, bbmax = -hi, hi
        tids, o, d_all, _, _, hit = _tile_hits(bbmin, bbmax, pose, intr, H,
                                               W, st.min_near)
        cnear, _ = _near_far(o, d_all, cut_box[0::2], cut_box[1::2],
                             st.min_near)
        cut_hit = (cnear < 1e30).any(dim=1)
        ids_b, mask_b, n_b, ovf_b = _compact(
            hit & cut_hit, _cap(st.active_frac, n_tiles, st.tile_chunk), tids)
        ids_s, mask_s, n_s, ovf_s = _compact(
            hit & ~cut_hit, _cap(st.cut_static_frac, n_tiles, st.tile_chunk),
            tids)
        img_b, dep_b, ws_b, dr_beam, dr_win = _tile_pass(
            st, layers, pack, p_def, o, pose, intr, H, W, ids_b, mask_b,
            bbmin, bbmax, deformed=True, cut=True, cut_box=cut_box,
            passes=passes, table=table)
        img_s, dep_s, ws_s, _, _ = _tile_pass(
            st, layers, pack, p_def, o, pose, intr, H, W, ids_s, mask_s,
            bbmin, bbmax, deformed=False, cut=False, cut_box=None,
            passes=passes, table=table)
        frame, _, _ = _scatter(n_tiles, bg, [
            (ids_b, mask_b, img_b, dep_b, ws_b),
            (ids_s, mask_s, img_s, dep_s, ws_s)])
        counters = torch.stack([n_b + n_s, dr_beam, dr_win.to(torch.int64),
                                ovf_b + ovf_s])
        return frame, counters
    bbmin, bbmax = p_def.amin(dim=0) - 1e-3, p_def.amax(dim=0) + 1e-3
    tids, o, d_all, near_all, far_all, hit = _tile_hits(
        bbmin, bbmax, pose, intr, H, W, st.min_near)
    # the candidate gate: a tile is active only with an IP in its beam
    t0, t1, _ = _tile_span(near_all, far_all, hit)
    tan_half = torch.full((n_tiles,), TILE * 0.75 / intr[0],
                          dtype=torch.float32, device=pose.device)
    ok, _ = _beam(st, p_def, o.expand(n_tiles, 3), _central_axis(d_all),
                  tan_half, t0, t1)
    hit = hit & (ok.sum(dim=1) > 0)
    ids, mask, n_act, ovf = _compact(
        hit, _cap(st.active_frac, n_tiles, st.tile_chunk), tids)
    img, dep, ws, dr_beam, dr_win = _tile_pass(
        st, layers, pack, p_def, o, pose, intr, H, W, ids, mask, bbmin,
        bbmax, deformed=True, cut=False, cut_box=None, passes=passes,
        table=table)
    frame, _, _ = _scatter(n_tiles, bg, [(ids, mask, img, dep, ws)])
    return frame, torch.stack([n_act, dr_beam, dr_win.to(torch.int64), ovf])
