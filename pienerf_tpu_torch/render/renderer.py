"""Static (undeformed) radiance-field rendering through the occupancy grid.

Port of ``pienerf_tpu.render.renderer``. A static-shape pipeline in place
of the reference's alive-ray loop (nerf/renderer.py:267-388):

  1. near/far slab test
  2. the analytic lattice march with occupancy bit tests (ops/raymarch)
  3. rank-compaction of the occupied samples into an [N, K] buffer
  4. one batched field evaluation over the live samples (``FieldMLP``: a
     chain of ``torch.matmul``, as the JAX package's XLA path, not the
     fused field kernel; the masked slots of the static buffer, which the
     JAX package evaluates too, are skipped: they never reach the image)
  5. masked exclusive-scan compositing with early termination

Depth is sum(w_k * t_k) over absolute sample positions, then normalized by
[near, far], as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch

from pienerf_tpu_torch.ops import raymarch

# rays a chunk of render_image: the mlp field's activations at K = 256 take
# a few GB a chunk; the hashgrid encode holds [8, L, rays * K] corner
# indices and weights (about 0.8 MB a ray at L = 16, K = 256), so its chunk
# is cut to keep a chunk's peak near 13 GB of the card's 80
CHUNK = 65536
CHUNK_HASHGRID = 16384


class RenderSettings(NamedTuple):
    """Static rendering configuration."""
    bound: float = 1.0
    cascade: int = 1
    min_near: float = 0.2
    density_scale: float = 1.0
    dt_gamma: float = 0.0
    max_steps: int = 1024
    T_thresh: float = 1e-2
    max_samples: int = 64          # K: compacted samples per ray
    bg_radius: float = -1.0


def field_at(field, mask: torch.Tensor, xs, ds):
    """(sigma [M], rgb [M, 3]) of the field at the M = mask.numel() samples
    xs, ds (component tuples), evaluated only where ``mask`` holds; the
    rest read 0. The JAX package evaluates every slot of its static
    buffers; a masked slot's values never reach the image (compositing
    weighs it by 0), so evaluating only the live ones changes no output."""
    sel = mask.reshape(-1).nonzero().squeeze(1)
    m = mask.numel()
    sigma = xs[0].new_zeros(m)
    rgb = xs[0].new_zeros((m, 3))
    if sel.numel():
        s, c = field(tuple(x[sel] for x in xs), tuple(d[sel] for d in ds))
        sigma[sel] = s
        rgb[sel] = c
    return sigma, rgb


def finish(field, st, rays_o, rays_d, bg_color, nears, fars, ws, depth,
           image) -> Dict[str, torch.Tensor]:
    """Background blend and normalized depth, shared by the renderers."""
    if st.bg_radius > 0:
        sph = raymarch.sph_from_ray(rays_o, rays_d, st.bg_radius)
        bg = field.background(sph, rays_d)
    else:
        bg = torch.as_tensor(bg_color, dtype=torch.float32,
                             device=rays_o.device).expand(rays_o.shape[0], 3)
    image = image + (1.0 - ws)[:, None] * bg
    depth_n = (torch.clamp(depth - nears, min=0.0)
               / torch.clamp(fars - nears, min=1e-6))
    return {"image": image, "depth": depth_n, "depth_raw": depth,
            "weights_sum": ws}


def render_rays(field, settings: RenderSettings, bitfield: torch.Tensor,
                rays_o: torch.Tensor, rays_d: torch.Tensor, bg_color,
                perturb: bool = False,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
    """Render a batch of rays: image [N, 3], depth [N], depth_raw [N],
    weights_sum [N]. ``perturb`` jitters each ray's start by ``noise`` [N]
    in [0, 1), drawn from ``generator`` when not passed."""
    st = settings
    n = rays_o.shape[0]
    dev = rays_o.device
    aabb = torch.tensor([-st.bound] * 3 + [st.bound] * 3, device=dev)
    nears, fars = raymarch.near_far_from_aabb(rays_o, rays_d, aabb,
                                              st.min_near)
    if perturb and noise is None:
        gdev = generator.device if generator is not None else dev
        noise = torch.rand((n,), generator=generator, device=gdev).to(dev)
    t, dt, valid = raymarch.march_lattice(
        rays_o, rays_d, nears, fars, bitfield, st.bound, st.cascade,
        st.max_steps, st.dt_gamma, st.max_steps,
        noise=noise if perturb else None)
    idx, mask = raymarch.compact_samples(valid, st.max_samples)
    ts = torch.gather(t, 1, idx)                              # [N, K]
    dts = torch.gather(dt, 1, idx)
    k = st.max_samples
    xs = tuple(torch.clamp(rays_o[:, i, None] + ts * rays_d[:, i, None],
                           -st.bound, st.bound).reshape(n * k)
               for i in range(3))
    ds = tuple(rays_d[:, i, None].expand(n, k).reshape(n * k)
               for i in range(3))
    sigmas, rgbs = field_at(field, mask, xs, ds)
    sigmas = (sigmas * st.density_scale).reshape(n, k)
    ws, depth, image = raymarch.composite(sigmas, rgbs.reshape(n, k, 3),
                                          dts, ts, mask, st.T_thresh)
    return finish(field, st, rays_o, rays_d, bg_color, nears, fars, ws,
                  depth, image)


def chunk_for(field, chunk: int) -> int:
    """A chunk of at most ``chunk`` rays, cut for the hashgrid encode."""
    if field.spec.backbone == "hashgrid":
        return min(chunk, CHUNK_HASHGRID)
    return chunk


def render_chunked(fn: Callable[..., Dict[str, torch.Tensor]],
                   rays_o: torch.Tensor, rays_d: torch.Tensor, chunk: int
                   ) -> Dict[str, torch.Tensor]:
    """``fn(rays_o, rays_d, start)`` over fixed-size ray chunks. The last
    chunk is padded with rays of 1.0, as the JAX package pads, and the
    padded rays never leave this function. Returns image, depth_raw,
    weights_sum over the N rays."""
    n = rays_o.shape[0]
    chunk = min(chunk, max(256, 1 << (n - 1).bit_length()))
    parts = {"image": [], "depth_raw": [], "weights_sum": []}
    for s in range(0, n, chunk):
        ro, rd = rays_o[s:s + chunk], rays_d[s:s + chunk]
        take = ro.shape[0]
        if take < chunk:
            pad = ro.new_ones((chunk - take, 3))
            ro, rd = torch.cat([ro, pad]), torch.cat([rd, pad])
        out = fn(ro, rd, s)
        for key, v in parts.items():
            v.append(out[key][:take])
    return {k: torch.cat(v) for k, v in parts.items()}


def as_image(out: Dict[str, torch.Tensor], H: int, W: int
             ) -> Dict[str, torch.Tensor]:
    return {"image": out["image"].reshape(H, W, 3),
            "depth": out["depth_raw"].reshape(H, W),
            "weights_sum": out["weights_sum"].reshape(H, W)}


def render_image(field, settings: RenderSettings, grid, pose: torch.Tensor,
                 intrinsics, H: int, W: int, bg_color: float = 1.0,
                 chunk: int = CHUNK) -> Dict[str, torch.Tensor]:
    """A full frame in fixed-size ray chunks: image [H, W, 3], depth
    [H, W] (unnormalized), weights_sum [H, W], on the pose's device."""
    from pienerf_tpu_torch.data.rays import get_rays_full

    rays_o, rays_d = get_rays_full(pose, intrinsics, H, W)
    out = render_chunked(
        lambda ro, rd, _s: render_rays(field, settings, grid.bitfield, ro,
                                       rd, bg_color),
        rays_o, rays_d, chunk_for(field, chunk))
    return as_image(out, H, W)
