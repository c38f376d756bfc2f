"""Camera rays and the training samplers (port of ``pienerf_tpu.data.rays``).

Pixel-center convention (i + 0.5), unit directions, cam2world poses. The
samplers take an explicit ``torch.Generator`` or the draws themselves (the
tests pass JAX's); a draw made here is made on the generator's device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def get_rays_full(pose: torch.Tensor, intrinsics, H: int, W: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All H*W rays of one pose: (rays_o [HW, 3], rays_d [HW, 3])."""
    fx, fy, cx, cy = intrinsics
    dev = pose.device
    j, i = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev) + 0.5,
        torch.arange(W, dtype=torch.float32, device=dev) + 0.5,
        indexing="ij")
    dirs = torch.stack([(i.reshape(-1) - cx) / fx, (j.reshape(-1) - cy) / fy,
                        torch.ones(H * W, device=dev)], dim=-1)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    rays_d = dirs @ pose[:3, :3].float().T
    rays_o = pose[:3, 3].float().expand(rays_d.shape)
    return rays_o, rays_d


def get_rays_sampled(pose: torch.Tensor, intrinsics, H: int, W: int,
                     inds: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rays at flat pixel indices ``inds`` [N] (training subsets)."""
    fx, fy, cx, cy = intrinsics
    px = (inds % W).float() + 0.5
    py = torch.div(inds, W, rounding_mode="floor").float() + 0.5
    dirs = torch.stack([(px - cx) / fx, (py - cy) / fy,
                        torch.ones_like(px)], dim=-1)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    rays_d = dirs @ pose[:3, :3].float().T
    rays_o = pose[:3, 3].float().expand(rays_d.shape)
    return rays_o, rays_d


def _gdev(generator: Optional[torch.Generator], device):
    return generator.device if generator is not None else device


def sample_patch_indices(generator: Optional[torch.Generator], H: int,
                         W: int, n: int, patch_size: int, device=None,
                         x0: Optional[torch.Tensor] = None,
                         y0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flat pixel indices of n // p^2 random p x p patches (reference
    nerf/utils.py:83-98): top-left corners ``x0`` in [0, H - p), ``y0`` in
    [0, W - p) (drawn when not passed), expanded by the patch's grid."""
    p = patch_size
    n_patch = max(n // (p * p), 1)
    if x0 is None or y0 is None:
        g = _gdev(generator, device)
        x0 = torch.randint(0, H - p, (n_patch,), generator=generator,
                           device=g)
        y0 = torch.randint(0, W - p, (n_patch,), generator=generator,
                           device=g)
    dev = device if device is not None else x0.device
    x0, y0 = x0.to(dev, torch.int64), y0.to(dev, torch.int64)
    pi, pj = torch.meshgrid(torch.arange(p, device=dev),
                            torch.arange(p, device=dev), indexing="ij")
    ix = x0[:, None] + pi.reshape(-1)[None, :]
    iy = y0[:, None] + pj.reshape(-1)[None, :]
    return (ix * W + iy).reshape(-1)


def sample_pixel_indices(generator: Optional[torch.Generator], H: int,
                         W: int, n: int,
                         error_map: Optional[torch.Tensor] = None,
                         device=None, inds: Optional[torch.Tensor] = None,
                         coarse: Optional[torch.Tensor] = None,
                         u: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Uniform or error-map-weighted pixel indices (reference
    nerf/utils.py:100-125). Uniform: ``inds`` [n] in [0, H*W). Weighted:
    ``coarse`` [n] cells of the 128x128 error grid drawn in proportion to
    error_map + 1e-8 (the distribution of JAX's categorical on its log),
    jittered inside the cell by ``u`` [n, 2] in [0, 1). Returns (inds,
    coarse or None)."""
    dev = device
    if dev is None:
        dev = error_map.device if error_map is not None else (
            inds.device if inds is not None else
            _gdev(generator, None) or "cpu")
    if error_map is None:
        if inds is None:
            inds = torch.randint(0, H * W, (n,), generator=generator,
                                 device=_gdev(generator, dev))
        return inds.to(dev, torch.int64), None
    g = _gdev(generator, dev)
    if coarse is None:
        coarse = torch.multinomial((error_map + 1e-8).to(g), n,
                                   replacement=True, generator=generator)
    if u is None:
        u = torch.rand((n, 2), generator=generator, device=g)
    coarse = coarse.to(dev, torch.int64)
    u = u.to(dev, torch.float32)
    cx_ = torch.div(coarse, 128, rounding_mode="floor")
    cy_ = coarse % 128
    sx, sy = H / 128.0, W / 128.0
    ix = torch.clamp((cx_ * sx + u[:, 0] * sx).to(torch.int32), 0, H - 1)
    iy = torch.clamp((cy_ * sy + u[:, 1] * sy).to(torch.int32), 0, W - 1)
    return ix.to(torch.int64) * W + iy.to(torch.int64), coarse
