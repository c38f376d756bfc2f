"""Deformed-space rendering: march in deformed space, bend the samples to
rest space, query the unmodified field.

Port of ``pienerf_tpu.render.deformed`` (in place of the reference's
alive-ray loop, per-frame spatial hash and bending kernel,
nerf/renderer.py:755-907, raymarching.cu:1122-1489):

  1. the per-frame spatial hash of the deformed IPs (one stable sort)
  2. the dilated cell occupancy: lattice points more than one hash cell
     from every IP cannot bend, so they are no candidates
  3. rank-compaction of the candidates to K_bend slots a ray
  4. bending (cached k-NN seek + Newton) of the live compacted samples
  5. the occupancy test at the rest-space points, a second compaction to
     the field's sample budget, one field evaluation, compositing

``cut`` bends only inside cut_bounds and renders the rest of the scene
statically (reference raymarching.cu:1197-1212).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from pienerf_tpu_torch.ops import bending as bend_ops
from pienerf_tpu_torch.ops import raymarch
from pienerf_tpu_torch.ops import spatial_hash as sh
from pienerf_tpu_torch.ops.grid import GRID_SIZE, occupied
from pienerf_tpu_torch.ops.morton import morton3d
from pienerf_tpu_torch.render.renderer import (RenderSettings, as_image,
                                               chunk_for, field_at, finish,
                                               render_chunked)

CHUNK = 16384                      # rays a chunk of render_image_deformed


class DeformedSettings(NamedTuple):
    """Static configuration of the deformed path."""
    base: RenderSettings
    bend: bend_ops.BendSettings
    layout: sh.HashGridLayout
    max_bend_samples: int = 128     # K_bend: lattice candidates bent a ray
    k_cell_candidates: int = 8      # per-cell cached nearest IPs


def prepare_frame(settings: DeformedSettings, p_def: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The frame's spatial structures over the deformed IPs: (cell_cand
    [n_cells, k_cand] nearest-IP cache, near_obj [n_cells] dilated
    occupancy)."""
    table, counts = sh.build_table(settings.layout, p_def)
    cell_cand = bend_ops.build_cell_candidates(
        settings.layout, table, p_def, settings.k_cell_candidates)
    return cell_cand, sh.dilated_occupancy(settings.layout, counts)


def _occupancy_at(bitfield, pts, bound: float, cascade: int):
    """Occupancy bit at world points (the finest applicable mip level)."""
    lvl = raymarch.mip_level(pts, torch.zeros(pts.shape[:-1],
                                              device=pts.device), cascade)
    mip_bound = torch.clamp(torch.exp2(lvl.float()), max=bound)
    cell = torch.clamp(0.5 * (pts / mip_bound[..., None] + 1.0) * GRID_SIZE,
                       0, GRID_SIZE - 1).to(torch.int32)
    return occupied(bitfield, lvl,
                    morton3d(cell[..., 0], cell[..., 1], cell[..., 2]))


def render_rays_deformed(
    field,
    settings: DeformedSettings,
    bitfield: torch.Tensor,
    p_def: torch.Tensor,          # [nIP, 3]
    p_ori: torch.Tensor,          # [nIP, 3]
    F: torch.Tensor,              # [nIP, 3, 3]
    dF: torch.Tensor,             # [nIP, 3, 3, 3]
    rays_o: torch.Tensor,         # [N, 3]
    rays_d: torch.Tensor,         # [N, 3]
    bg_color,
    cut_bounds: Optional[torch.Tensor] = None,   # [6] when bend.cut
    cell_cand: Optional[torch.Tensor] = None,    # from prepare_frame
    near_obj: Optional[torch.Tensor] = None,     # from prepare_frame
) -> Dict[str, torch.Tensor]:
    st = settings.base
    bd = settings.bend
    n = rays_o.shape[0]
    # the frame's deformed box: the IPs', or the scene's in cut mode
    marg = 1e-3
    if bd.cut:
        bbmin = torch.full((3,), -st.bound - marg, device=p_def.device)
        bbmax = torch.full((3,), st.bound + marg, device=p_def.device)
    else:
        bbmin, bbmax = p_def.amin(dim=0) - marg, p_def.amax(dim=0) + marg
    nears, fars = raymarch.near_far_from_aabb(
        rays_o, rays_d, torch.cat([bbmin, bbmax]), st.min_near)
    if cell_cand is None or near_obj is None:
        cell_cand, near_obj = prepare_frame(settings, p_def)

    # the lattice in deformed space
    t, dt, _ = raymarch.march_lattice(
        rays_o, rays_d, nears, fars, bitfield, st.bound, st.cascade,
        st.max_steps, st.dt_gamma, st.max_steps)
    xs = rays_o[:, None, :] + t[..., None] * rays_d[:, None, :]  # [N, S, 3]
    inside_t = t < fars[:, None]
    near_mask = near_obj[sh.cell_index(settings.layout,
                                       sh.cell_of(settings.layout, xs))]
    if bd.cut:
        cb = cut_bounds
        in_cut = ((xs[..., 0] > cb[0]) & (xs[..., 0] < cb[1])
                  & (xs[..., 1] > cb[2]) & (xs[..., 1] < cb[3])
                  & (xs[..., 2] > cb[4]) & (xs[..., 2] < cb[5]))
        # the static part: occupancy at the unbent point
        occ_static = _occupancy_at(bitfield,
                                   torch.clamp(xs, -st.bound, st.bound),
                                   st.bound, st.cascade)
        candidate = inside_t & torch.where(in_cut, near_mask, occ_static)
        bendable = in_cut
    else:
        candidate = inside_t & near_mask
        bendable = torch.ones_like(candidate)

    # compact the candidates to K_bend a ray
    kb = settings.max_bend_samples
    idx, mask_b = raymarch.compact_samples(candidate, kb)
    ts = torch.gather(t, 1, idx)
    dts = torch.gather(dt, 1, idx)
    xb = rays_o[:, None, :] + ts[..., None] * rays_d[:, None, :]
    if bd.cut:
        xb = torch.clamp(xb, -st.bound, st.bound)
    else:
        xb = torch.minimum(torch.maximum(xb, bbmin), bbmax - 1e-6)
    bendable_c = torch.gather(bendable, 1, idx) & mask_b

    # bend the live bendable slots through the cached k-NN path (the JAX
    # package bends every slot of its static buffer; a dead slot is dropped
    # below whatever it maps to, so bending only the live ones changes no
    # output)
    x_flat = xb.reshape(n * kb, 3)
    bc = bendable_c.reshape(-1)
    sel = bc.nonzero().squeeze(1)
    x_map = x_flat.clone()
    ok = torch.ones_like(bc)
    if sel.numel():
        x_rest, found = bend_ops.bend_points(
            settings.layout, bd, None, p_def, p_ori, F, dF, x_flat[sel],
            bbmin, bbmax, cell_cand=cell_cand)
        x_map[sel] = x_rest
        ok[sel] = found

    # occupancy at the mapped points, then the field's sample budget
    x_map = torch.clamp(x_map, -st.bound, st.bound)
    occ = _occupancy_at(bitfield, x_map, st.bound, st.cascade)
    valid = (ok & occ).reshape(n, kb) & mask_b
    k = st.max_samples
    idx2, mask = raymarch.compact_samples(valid, k)
    ts2 = torch.gather(ts, 1, idx2)
    dts2 = torch.gather(dts, 1, idx2)
    xm = torch.gather(x_map.reshape(n, kb, 3), 1,
                      idx2[..., None].expand(n, k, 3))
    xm = xm.reshape(n * k, 3)
    dm = rays_d[:, None, :].expand(n, k, 3).reshape(n * k, 3)
    sigmas, rgbs = field_at(field, mask, tuple(xm.unbind(1)),
                            tuple(dm.unbind(1)))
    sigmas = (sigmas * st.density_scale).reshape(n, k)
    ws, depth, image = raymarch.composite(sigmas, rgbs.reshape(n, k, 3),
                                          dts2, ts2, mask, st.T_thresh)
    return finish(field, st, rays_o, rays_d, bg_color, nears, fars, ws,
                  depth, image)


def render_deformed_chunked(field, settings: DeformedSettings, bitfield,
                            p_def, p_ori, F, dF, rays_o, rays_d, bg_color,
                            cut_bounds=None, chunk: int = CHUNK
                            ) -> Dict[str, torch.Tensor]:
    """render_rays_deformed over fixed-size ray chunks, the frame's spatial
    structures built once and shared by every chunk. Rays are independent,
    so the result does not depend on ``chunk`` beyond the field's summation
    order (a chunk's live samples set its matmul shape)."""
    cell_cand, near_obj = prepare_frame(settings, p_def)
    return render_chunked(
        lambda ro, rd, _s: render_rays_deformed(
            field, settings, bitfield, p_def, p_ori, F, dF, ro, rd,
            bg_color, cut_bounds, cell_cand, near_obj),
        rays_o, rays_d, chunk_for(field, chunk))


def render_image_deformed(field, settings: DeformedSettings, grid,
                          p_def, p_ori, F, dF, pose: torch.Tensor,
                          intrinsics, H: int, W: int, bg_color: float = 1.0,
                          chunk: int = CHUNK, cut_bounds=None
                          ) -> Dict[str, torch.Tensor]:
    """A full deformed frame: image [H, W, 3], depth, weights_sum."""
    from pienerf_tpu_torch.data.rays import get_rays_full

    rays_o, rays_d = get_rays_full(pose, intrinsics, H, W)
    out = render_deformed_chunked(field, settings, grid.bitfield, p_def,
                                  p_ori, F, dF, rays_o, rays_d, bg_color,
                                  cut_bounds, chunk)
    return as_image(out, H, W)
