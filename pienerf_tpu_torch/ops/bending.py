"""Quadratic ray bending: map deformed-space samples back to rest space.

Port of ``pienerf_tpu.ops.bending`` (reference raymarching.cu:930-1489).
For a deformed sample x:

1. find the k nearest deformed integration points (IPs) through the
   spatial hash (the 27-cell neighborhood, or a per-cell cache of the
   IPs nearest the cell's center), k = num_seek_IP in 1..3;
2. per IP, Newton-solve F q + 1/2 (dF . q) q = x - p_def_k for the rest
   offset q, (dF . q)[d, c] = sum_j dF[j, d, c] q_j, and reject IPs whose
   solution moved more than ip_dx on an axis;
3. blend the valid rest-space positions by inverse deformed distance.

The exact-bending oracle of ``render/interactive.py`` uses the Newton
solve alone; ``render/deformed.py`` uses ``bend_points``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from pienerf_tpu_torch.ops import spatial_hash as sh


def _inv3x3(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched closed-form 3x3 inverse. Returns (A_inv, ok mask)."""
    a = A
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
                    -1),
    ], -2)
    return inv_det[..., None, None] * adj, ok


def newton_invert(
    x: torch.Tensor,             # [M, 3] deformed sample
    p_ori_k: torch.Tensor,       # [M, k, 3] rest IP positions
    p_def_k: torch.Tensor,       # [M, k, 3] deformed IP positions
    F_k: torch.Tensor,           # [M, k, 3, 3]
    dF_k: torch.Tensor,          # [M, k, 3, 3, 3]
    max_iter: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(sample, IP) Newton solve with convergence masking. Returns
    (p_rest [M, k, 3], ok [M, k] (all true, as in the JAX package))."""
    q_target = x[:, None, :] - p_def_k
    q = torch.zeros_like(q_target)
    alive = torch.ones(q.shape[:-1], dtype=torch.bool, device=q.device)
    for _ in range(max_iter):
        dFq = torch.einsum("mkjdc,mkj->mkdc", dF_k, q)
        J = F_k + dFq
        J_inv, ok = _inv3x3(J)
        Fq = torch.einsum("mkdc,mkc->mkd", F_k, q)
        dFq_q = torch.einsum("mkdc,mkc->mkd", dFq, q)
        r = Fq + 0.5 * dFq_q - q_target
        dq = torch.einsum("mkdc,mkc->mkd", J_inv, r)
        step_ok = ok & alive
        q = torch.where(step_ok[..., None], q - dq, q)
        converged = torch.sum(dq * dq, dim=-1) < 1e-12
        alive = alive & ok & ~converged
    return p_ori_k + q, torch.ones(q.shape[:-1], dtype=torch.bool,
                                   device=q.device)


def _topk_smallest(cand: torch.Tensor, d2: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest d2 per row by repeated min-extraction, each taking
    the first minimum on ties as JAX's argmin does: (ids [M, k], -1 where
    none is left; dist [M, k])."""
    ids, dists = [], []
    d2 = d2.clone()
    for _ in range(k):
        j = torch.argmin(d2, dim=1, keepdim=True)
        best = torch.gather(d2, 1, j)[:, 0]
        fin = torch.isfinite(best)
        ids.append(torch.where(fin, torch.gather(cand, 1, j)[:, 0],
                               torch.full_like(best, -1, dtype=cand.dtype)))
        dists.append(torch.sqrt(torch.where(fin, best,
                                            torch.zeros_like(best))))
        d2.scatter_(1, j, float("inf"))
    return torch.stack(ids, dim=1), torch.stack(dists, dim=1)


def _nearest_of(cand: torch.Tensor, p_def: torch.Tensor, x: torch.Tensor,
                k: int):
    """k nearest of the candidate ids cand [M, C] (-1: none) to x [M, 3]."""
    pc = p_def[torch.clamp(cand, min=0)]
    d2 = ((pc - x[:, None, :]) ** 2).sum(dim=-1)
    d2 = torch.where(cand >= 0, d2, torch.full_like(d2, float("inf")))
    return _topk_smallest(cand, d2, k)


def find_closest_ips(layout: sh.HashGridLayout, table: torch.Tensor,
                     p_def: torch.Tensor, x: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k nearest IPs among the 27-cell neighborhood of each x:
    (ids [M, k], -1 for missing; dist [M, k])."""
    cand = sh.gather_neighborhood(layout, table, sh.cell_of(layout, x))
    return _nearest_of(cand, p_def, x, k)


def build_cell_candidates(layout: sh.HashGridLayout, table: torch.Tensor,
                          p_def: torch.Tensor, k_cand: int = 8
                          ) -> torch.Tensor:
    """Per-frame cache [n_cells, k_cand] (-1 padded): the k_cand IPs of
    each cell's 27-neighborhood nearest to the cell's center. A sample's
    nearest IP is assumed to be among its cell's; sound for k_cand >= ~8
    at IP spacing ~ cell size."""
    r0, r1, r2 = layout.resolution
    dev = p_def.device
    gz, gy, gx = torch.meshgrid(torch.arange(r2, device=dev),
                                torch.arange(r1, device=dev),
                                torch.arange(r0, device=dev), indexing="ij")
    cells = torch.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)], -1)
    bbmin = torch.tensor(layout.bbmin, dtype=torch.float32, device=dev)
    centers = bbmin + (cells.float() + 0.5) * layout.hgs
    cand = sh.gather_neighborhood(layout, table, cells)
    return _nearest_of(cand, p_def, centers, k_cand)[0]


def find_closest_ips_cached(layout: sh.HashGridLayout,
                            cell_cand: torch.Tensor, p_def: torch.Tensor,
                            x: torch.Tensor, k: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest IPs per sample from the per-cell candidate cache."""
    cand = cell_cand[sh.cell_index(layout, sh.cell_of(layout, x))]
    return _nearest_of(cand, p_def, x, k)


class BendSettings(NamedTuple):
    """Static bending configuration."""
    num_seek_ip: int = 3
    max_iter_num: int = 1
    ip_dx: float = 0.0525          # sim.dx * 1.05 (main_gui.py:56)
    cut: bool = False


def bend_points(layout: sh.HashGridLayout, settings: BendSettings,
                table: Optional[torch.Tensor], p_def: torch.Tensor,
                p_ori: torch.Tensor, F: torch.Tensor, dF: torch.Tensor,
                x: torch.Tensor, bbmin: torch.Tensor, bbmax: torch.Tensor,
                cell_cand: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deformed samples x [M, 3] -> (x_rest [M, 3], found [M]). found is
    False where no IP is usable: the caller treats the sample as empty
    (raymarching.cu:1212-1254). With ``cell_cand`` (build_cell_candidates)
    the search takes the cached path and ``table`` is unused."""
    k = settings.num_seek_ip
    if cell_cand is not None:
        ids, dist = find_closest_ips_cached(layout, cell_cand, p_def, x, k)
    else:
        ids, dist = find_closest_ips(layout, table, p_def, x, k)
    safe = torch.clamp(ids, min=0)
    pd, po, Fk, dFk = p_def[safe], p_ori[safe], F[safe], dF[safe]
    # IPs on or outside the deformed bbox are rejected
    # (raymarching.cu:1243-1251), and so are solutions that moved more
    # than ip_dx on an axis
    has = (ids >= 0) & ((pd > bbmin) & (pd < bbmax)).all(dim=-1)
    p_rest, _ = newton_invert(x, po, pd, Fk, dFk, settings.max_iter_num)
    ok = has & ((p_rest - po).abs() <= settings.ip_dx).all(dim=-1)
    w = torch.where(ok, 1.0 / torch.clamp(dist, min=1e-8),
                    torch.zeros_like(dist))
    wsum = w.sum(dim=1)
    found = wsum > 0
    w = w / torch.clamp(wsum, min=1e-30)[:, None]
    x_rest = torch.einsum("mk,mkd->md", w, p_rest)
    return torch.where(found[:, None], x_rest, x), found
