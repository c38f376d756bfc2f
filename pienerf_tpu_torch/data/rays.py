"""Camera rays for one pose (port of ``pienerf_tpu.data.rays``:
``get_rays_full``; the training samplers wait for the trainer).

Pixel-center convention (i + 0.5), unit directions, cam2world poses.
"""

from __future__ import annotations

from typing import Tuple

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
