"""Hierarchical (coarse + fine) rendering without the occupancy grid.

Port of ``pienerf_tpu.render.fast``: the reference's pure-torch fallback
(nerf/renderer.py:137-266, sample_pdf :19-53). Pass 1 takes K1 stratified
samples in [near, far] and evaluates density only; pass 2 draws K2
importance samples from the coarse weights' CDF, merges and sorts them
with the coarse ones, evaluates the field and composites with early
termination. The two uniform draws come from an explicit generator or are
passed in.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from pienerf_tpu_torch.ops import raymarch
from pienerf_tpu_torch.render.renderer import (CHUNK, as_image, chunk_for,
                                               finish, render_chunked)


class FastSettings(NamedTuple):
    bound: float = 1.0
    min_near: float = 0.05
    density_scale: float = 1.0
    T_thresh: float = 1e-2
    num_coarse: int = 64
    num_fine: int = 64
    bg_radius: float = -1.0


def sample_pdf(t_mid: torch.Tensor, weights: torch.Tensor, n_samples: int,
               u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF sampling: t_mid [N, K-1] bin centers, weights [N, K-1],
    u [N, S] in [0, 1) -> [N, S]. The JAX package's one-hot contractions
    are gathers here (equal for finite values)."""
    w = weights + 1e-5
    cdf = torch.cumsum(w, dim=-1)
    cdf = cdf / cdf[:, -1:]
    inds = (u[:, :, None] >= cdf[:, None, :]).sum(dim=-1)
    below = torch.clamp(inds - 1, 0, cdf.shape[1] - 1)
    above = torch.clamp(inds, 0, cdf.shape[1] - 1)
    cdf_b = torch.gather(cdf, 1, below)
    cdf_a = torch.gather(cdf, 1, above)
    t_b = torch.gather(t_mid, 1, below)
    t_a = torch.gather(t_mid, 1, above)
    denom = torch.where(cdf_a - cdf_b < 1e-5, torch.ones_like(cdf_a),
                        cdf_a - cdf_b)
    frac = torch.clamp((u - cdf_b) / denom, 0.0, 1.0)
    return t_b + frac * (t_a - t_b)


MapFn = Callable[[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
                 Tuple[Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                       Optional[torch.Tensor]]]


def _positions(rays_o, rays_d, t):
    return tuple((rays_o[:, i, None] + t * rays_d[:, i, None]).reshape(-1)
                 for i in range(3))


def draw(n: int, settings: FastSettings,
         generator: Optional[torch.Generator], device
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two uniform draws of n rays: (coarse [n, K1], fine [n, K2])."""
    gdev = generator.device if generator is not None else device
    uc = torch.rand((n, settings.num_coarse), generator=generator,
                    device=gdev)
    uf = torch.rand((n, settings.num_fine), generator=generator, device=gdev)
    return uc.to(device), uf.to(device)


def render_rays_fast(field, settings: FastSettings, rays_o: torch.Tensor,
                     rays_d: torch.Tensor, bg_color,
                     generator: Optional[torch.Generator] = None,
                     aabb: Optional[torch.Tensor] = None,
                     map_fn: Optional[MapFn] = None,
                     u_coarse: Optional[torch.Tensor] = None,
                     u_fine: Optional[torch.Tensor] = None
                     ) -> Dict[str, torch.Tensor]:
    """Render a batch of rays. ``u_coarse`` [N, K1] and ``u_fine`` [N, K2]
    are the two uniform draws (the JAX package's key_c and key_f draws),
    taken from ``generator`` when not passed. ``map_fn`` maps deformed
    sample positions to rest space and may drop samples."""
    st = settings
    n = rays_o.shape[0]
    dev = rays_o.device
    if u_coarse is None or u_fine is None:
        u_coarse, u_fine = draw(n, st, generator, dev)
    if aabb is None:
        aabb = torch.tensor([-st.bound] * 3 + [st.bound] * 3, device=dev)
    nears, fars = raymarch.near_far_from_aabb(rays_o, rays_d, aabb,
                                              st.min_near)
    hit = nears < 1e30
    nears = torch.where(hit, nears, torch.full_like(nears, 2.0))
    fars = torch.where(hit, fars, torch.full_like(fars, 2.0 + 1e-3))
    k1, k2 = st.num_coarse, st.num_fine

    # coarse stratified samples, density only
    u = (torch.arange(k1, dtype=torch.float32, device=dev)[None]
         + u_coarse) / k1
    t_c = nears[:, None] + (fars - nears)[:, None] * u
    xs = _positions(rays_o, rays_d, t_c)
    keep = None
    if map_fn is not None:
        xs, keep = map_fn(xs)
    sigma_c, _ = field.density(xs)
    sigma_c = sigma_c * st.density_scale
    if keep is not None:
        sigma_c = torch.where(keep, sigma_c, torch.zeros_like(sigma_c))
    sigma_c = sigma_c.reshape(n, k1)

    # importance samples from the coarse CDF
    dt_c = torch.diff(t_c, dim=1)
    tau = sigma_c[:, :-1] * dt_c
    w_c = (1.0 - torch.exp(-tau)) * torch.exp(-torch.cumsum(
        torch.nn.functional.pad(tau, (1, 0))[:, :-1], dim=1))
    t_mid = 0.5 * (t_c[:, :-1] + t_c[:, 1:])
    t_f = sample_pdf(t_mid, w_c, k2, u_fine)

    # the union, sorted along the ray
    t_all = torch.sort(torch.cat([t_c, t_f], dim=1), dim=1).values
    k = k1 + k2
    dts = torch.diff(t_all, dim=1)
    dts = torch.cat([dts, torch.full((n, 1), 1e10, device=dev)], dim=1)
    dts = torch.minimum(dts, (fars - nears)[:, None])

    xs = _positions(rays_o, rays_d, t_all)
    keep = None
    if map_fn is not None:
        xs, keep = map_fn(xs)
    ds = tuple(rays_d[:, i, None].expand(n, k).reshape(-1) for i in range(3))
    sigma, rgb = field(xs, ds)
    sigma = sigma * st.density_scale
    if keep is not None:
        sigma = torch.where(keep, sigma, torch.zeros_like(sigma))
    mask = hit[:, None].expand(n, k)
    ws, depth, image = raymarch.composite(
        sigma.reshape(n, k), rgb.reshape(n, k, 3), dts, t_all, mask,
        st.T_thresh)
    return finish(field, st, rays_o, rays_d, bg_color, nears, fars, ws,
                  depth, image)


def render_image_fast(field, settings: FastSettings, pose: torch.Tensor,
                      intrinsics, H: int, W: int, bg_color: float = 1.0,
                      generator: Optional[torch.Generator] = None,
                      chunk: int = CHUNK,
                      draws: Optional[Tuple[torch.Tensor, torch.Tensor]]
                      = None) -> Dict[str, torch.Tensor]:
    """A full frame in fixed-size ray chunks. ``draws`` = (coarse
    [HW, K1], fine [HW, K2]) gives every ray's draws; otherwise each chunk
    draws its own from ``generator``."""
    from pienerf_tpu_torch.data.rays import get_rays_full

    rays_o, rays_d = get_rays_full(pose, intrinsics, H, W)

    def fn(ro, rd, s):
        uc = uf = None
        if draws is not None:
            uc, uf = (_padded(d[s:s + ro.shape[0]], ro.shape[0])
                      for d in draws)
        return render_rays_fast(field, settings, ro, rd, bg_color,
                                generator=generator, u_coarse=uc,
                                u_fine=uf)

    out = render_chunked(fn, rays_o, rays_d, chunk_for(field, chunk))
    return as_image(out, H, W)


def _padded(d: torch.Tensor, n: int) -> torch.Tensor:
    """Draws of a padded last chunk: zeros for the padded rays."""
    if d.shape[0] == n:
        return d
    return torch.cat([d, d.new_zeros((n - d.shape[0], d.shape[1]))])
