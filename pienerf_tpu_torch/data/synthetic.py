"""Procedural test scene: an analytic radiance field + rendered GT images.

Port of ``pienerf_tpu.data.synthetic`` (numpy, so the same arithmetic):
no dataset files ship with the repo, so training runs on this analytic
scene, a soft-edged sphere whose color varies with position (or the
"hard" scene). GT images come from dense ray integration, independent of
the rendering stack. ``render_gt(..., device=...)`` integrates the same
function in float64 torch on a device (the card renders an 800x800 view
in well under a second, the host in tens of seconds); ``alpha=True``
returns straight-alpha RGBA for writing a blender-layout dataset.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


def sphere_sigma(x: np.ndarray, r0: float = 0.5, sigma0: float = 40.0,
                 sharp: float = 40.0) -> np.ndarray:
    """Soft sphere density: sigma0 * sigmoid(sharp * (r0 - |x|))."""
    r = np.linalg.norm(x, axis=-1)
    return sigma0 / (1.0 + np.exp(np.clip(-sharp * (r0 - r), -60.0, 60.0)))


def sphere_rgb(x: np.ndarray) -> np.ndarray:
    """Position-dependent albedo in [0.1, 0.9]."""
    return 0.5 + 0.4 * np.sin(np.asarray(x) * np.array([3.0, 5.0, 7.0]))


# --- "hard" scene: high-frequency texture + self-occlusion ----------------
#
# The smooth sphere is the friendliest possible input for a Fourier-MLP
# prior (round-3 review): low-frequency geometry, no occlusion between
# surfaces, albedo at wavenumbers 3-7. This scene exists to stress the
# opposite regime with a still purely-analytic field:
#   - geometry: four overlapping lobes at different depths (a ray from most
#     orbit poses crosses 2-3 surface sheets -> real self-occlusion and
#     disocclusion edges), surfaces displaced by a wavenumber-(9,11,13)
#     bump field (sharp silhouettes move at high spatial frequency),
#   - albedo: wavenumbers (17, 23, 29) plus a phase-modulation term, far
#     above the sphere scene's (3, 5, 7).
# All ops are elementwise + exp, identical under numpy and torch: the `xp`
# arg runs the SAME function on a device while the tests hold it to this
# numpy oracle.

_HARD_CENTERS = np.array([
    [0.22, 0.02, 0.10],
    [-0.25, 0.12, -0.20],
    [0.00, -0.26, 0.24],
    [-0.04, 0.28, -0.02],
])
_HARD_RADII = np.array([0.34, 0.27, 0.23, 0.19])


def _const(xp, v, like):
    """A constant array in ``like``'s dtype (and, under torch, device)."""
    if xp is np:
        return np.asarray(v, dtype=like.dtype)
    return xp.as_tensor(np.asarray(v), dtype=like.dtype, device=like.device)


def hard_sigma(x, sigma0: float = 60.0, sharp: float = 60.0, xp=np):
    """Soft union of four bump-displaced lobes (see module comment)."""
    x = xp.asarray(x)
    bump = (0.05 * xp.sin(9.0 * x[..., 0]) * xp.sin(11.0 * x[..., 1])
            * xp.sin(13.0 * x[..., 2]))
    # occupancy union: 1 - prod(1 - occ_k), smooth everywhere
    one_minus = None
    for k in range(_HARD_CENTERS.shape[0]):
        d = x - _const(xp, _HARD_CENTERS[k], x)
        r = xp.sqrt(xp.sum(d * d, axis=-1))
        occ = 1.0 / (1.0 + xp.exp(xp.clip(
            -sharp * (_HARD_RADII[k] + bump - r), -60.0, 60.0)))
        one_minus = (1.0 - occ) if one_minus is None else one_minus * (1.0 - occ)
    return sigma0 * (1.0 - one_minus)


def hard_rgb(x, xp=np):
    """High-frequency albedo: wavenumbers (17, 23, 29) + phase modulation."""
    x = xp.asarray(x)
    base = xp.sin(x * _const(xp, [17.0, 23.0, 29.0], x))
    mod = xp.sin(7.0 * x[..., 0] * x[..., 1] + 11.0 * x[..., 2])[..., None]
    return 0.5 + 0.35 * base + 0.1 * mod


SCENES = {
    "sphere": (sphere_sigma, sphere_rgb),
    "hard": (lambda x, xp=np: hard_sigma(x, xp=xp),
             lambda x, xp=np: hard_rgb(x, xp=xp)),
}


def scene_field(scene: str, xs, xp=np):
    """(sigma, rgb) of a named analytic scene, under numpy or torch."""
    if scene == "sphere":
        if xp is np:
            return sphere_sigma(xs), sphere_rgb(xs)
        r = xp.sqrt(xp.sum(xs * xs, axis=-1))
        sig = 40.0 / (1.0 + xp.exp(xp.clip(-40.0 * (0.5 - r), -60.0, 60.0)))
        rgb = 0.5 + 0.4 * xp.sin(xs * _const(xp, [3.0, 5.0, 7.0], xs))
        return sig, rgb
    if scene == "hard":
        return hard_sigma(xs, xp=xp), hard_rgb(xs, xp=xp)
    raise ValueError(f"unknown scene {scene!r} (have: sphere, hard)")


def _look_at(eye: np.ndarray) -> np.ndarray:
    """cam2world with +z = viewing direction (matches ray conventions)."""
    fwd = -eye / np.linalg.norm(eye)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    up2 = np.cross(right, fwd)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 0] = right
    pose[:3, 1] = -up2
    pose[:3, 2] = fwd
    pose[:3, 3] = eye
    return pose


def orbit_poses(n: int, radius: float = 2.5, seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    poses = []
    for i in range(n):
        theta = np.pi / 3 + rng.rand() * np.pi / 3
        phi = 2 * np.pi * i / n + rng.rand() * 0.1
        eye = radius * np.array([
            np.sin(theta) * np.cos(phi),
            np.cos(theta),
            np.sin(theta) * np.sin(phi),
        ])
        poses.append(_look_at(eye.astype(np.float64)))
    return np.stack(poses)


def _ray_bounds(rays_o, rays_d, bound, xp):
    """near, far of the slab test against the bound cube, clamped to a
    finite range (see render_gt)."""
    inv = 1.0 / rays_d
    t0 = (-bound - rays_o) * inv
    t1 = (bound - rays_o) * inv
    mx = xp.minimum(t0, t1).max(-1)
    mn = xp.maximum(t0, t1).min(-1)
    if xp is not np:
        mx, mn = mx.values, mn.values
    near = xp.minimum(xp.maximum(mx, xp.full_like(mx, 0.05)),
                      xp.full_like(mx, 1e3))
    far = xp.minimum(xp.maximum(mn, near + 1e-6), xp.full_like(mx, 1e3 + 1e-3))
    return near, far


def _integrate(rays_o, rays_d, n_steps, bound, bg, scene, xp):
    """(premultiplied color [N, 3], weight sum [N]) and the image on bg."""
    near, far = _ray_bounds(rays_o, rays_d, bound, xp)
    steps = (xp.arange(n_steps) + 0.5) / n_steps
    if xp is not np:
        steps = steps.to(rays_o)
    ts = near[:, None] + (far - near)[:, None] * steps[None, :]
    dt = ((far - near) / n_steps)[:, None]
    xs = rays_o[:, None, :] + ts[..., None] * rays_d[:, None, :]
    xs = xp.clip(xs, -4.0 * bound - 4.0, 4.0 * bound + 4.0)
    sig, rgb = scene_field(scene, xs, xp=xp)
    tau = sig * dt
    T = xp.exp(-xp.cumsum(tau, axis=1) + tau)
    alpha = 1.0 - xp.exp(-tau)
    w = alpha * T
    color = (w[..., None] * rgb).sum(1)
    wsum = w.sum(1)
    return color, wsum, color + (1 - wsum)[:, None] * bg


def _straight(color, wsum, xp):
    a = xp.maximum(wsum, xp.full_like(wsum, 1e-12))
    return xp.concatenate([color / a[:, None], wsum[:, None]], -1) \
        if xp is np else xp.cat([color / a[:, None], wsum[:, None]], -1)


def render_gt(pose: np.ndarray, intrinsics, H: int, W: int,
              n_steps: int = 400, bound: float = 1.0,
              bg: float = 1.0, scene: str = "sphere", alpha: bool = False,
              device=None, chunk: int = 1 << 16) -> np.ndarray:
    """Dense quadrature volume rendering of an analytic scene: [H, W, 3]
    on ``bg`` or, with ``alpha``, straight-alpha [H, W, 4] (the color
    where the weights sum to zero is 0). In numpy float64 unless
    ``device`` names a torch device, where the same integral runs in
    float64 torch in ray chunks."""
    fx, fy, cx, cy = intrinsics
    j, i = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5, indexing="ij")
    dirs = np.stack([(i - cx) / fx, (j - cy) / fy, np.ones_like(i)], -1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rays_d = (dirs.reshape(-1, 3) @ pose[:3, :3].T).astype(np.float64)
    rays_o = np.broadcast_to(pose[:3, 3].astype(np.float64), rays_d.shape)

    # slab test against the bound cube; clamp to a finite range so grazing
    # rays (|dir component| ~ 1e-7 -> t ~ 1e7+) cannot push samples to
    # magnitudes where f32 trig NaNs (observed at 800x800: ~200 ppm of
    # edge rays). Legit samples satisfy |x| <= ~3 at these camera radii,
    # so the clamps are exact no-ops on every contributing sample.
    if device is None:
        color, wsum, img = _integrate(rays_o, rays_d, n_steps, bound, bg,
                                      scene, np)
        out = _straight(color, wsum, np) if alpha else img
    else:
        import torch

        ro = torch.as_tensor(np.ascontiguousarray(rays_o), device=device)
        rd = torch.as_tensor(rays_d, device=device)
        parts = []
        for s in range(0, rd.shape[0], chunk):
            color, wsum, img = _integrate(ro[s:s + chunk], rd[s:s + chunk],
                                          n_steps, bound, bg, scene, torch)
            parts.append(_straight(color, wsum, torch) if alpha else img)
        out = torch.cat(parts).cpu().numpy()
    return out.reshape(H, W, 4 if alpha else 3).astype(np.float32)


@dataclass
class SyntheticDataset:
    poses: np.ndarray
    images: np.ndarray
    intrinsics: Tuple[float, float, float, float]
    H: int
    W: int


def make_dataset(n_views: int = 16, H: int = 64, W: int = 64,
                 seed: int = 0, scene: str = "sphere",
                 device=None) -> SyntheticDataset:
    focal = 0.9 * H
    intr = (focal, focal, W / 2.0, H / 2.0)
    poses = orbit_poses(n_views, seed=seed)
    images = np.stack([render_gt(p, intr, H, W, scene=scene, device=device)
                       for p in poses])
    return SyntheticDataset(poses=poses.astype(np.float32), images=images,
                            intrinsics=intr, H=H, W=W)


def scene_points(scene: str, dx: float = 0.05, thresh: float = 0.5,
                 bound: float = 0.7) -> np.ndarray:
    """Physics point cloud for an analytic scene: lattice points where the
    occupancy 1 - exp(-sigma/ ~) clears `thresh` (the role of
    main_sample.py's density threshold for real checkpoints)."""
    c = np.arange(-bound, bound + 1e-6, dx)
    xx, yy, zz = np.meshgrid(c, c, c, indexing="ij")
    pts = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], 1)
    sig, _ = scene_field(scene, pts)
    occ = 1.0 - np.exp(-sig * dx)
    return pts[occ > thresh]


def ngp_matrix_to_nerf(pose: np.ndarray, scale: float = 0.33,
                       offset=(0, 0, 0)) -> np.ndarray:
    """The inverse of ``provider.nerf_matrix_to_ngp``: the transform
    matrix a dataset file holds for an ngp-space pose."""
    p = np.eye(4, dtype=np.float64)
    for src, dst in ((0, 1), (1, 2), (2, 0)):
        p[dst, :3] = pose[src, :3] * np.array([1.0, -1.0, -1.0])
        p[dst, 3] = (pose[src, 3] - offset[src]) / scale
    return p


def write_blender(root: str, splits, intrinsics, H: int, W: int,
                  scale: float = 1.0) -> None:
    """Write a blender-layout dataset: ``transforms_{split}.json`` (h, w,
    fl_x, fl_y, cx, cy, frames of file_path and transform_matrix) and one
    PNG per frame under ``{split}/``. ``splits``: {split: (poses [B, 4, 4]
    in ngp space, images [B, H, W, 3 or 4] in [0, 1])}; read back with
    ``--scale`` equal to ``scale`` and no offset."""
    import json
    import os

    from pienerf_tpu_torch.io.framesink import write_png

    fx, fy, cx, cy = intrinsics
    for split, (poses, images) in splits.items():
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for i, (pose, img) in enumerate(zip(poses, images)):
            name = f"{split}/r_{i}"
            write_png(os.path.join(root, name + ".png"),
                      np.round(np.clip(img, 0.0, 1.0) * 255).astype(
                          np.uint8))
            frames.append({"file_path": name, "transform_matrix":
                           ngp_matrix_to_nerf(pose, scale).tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"h": H, "w": W, "fl_x": fx, "fl_y": fy, "cx": cx,
                       "cy": cy, "frames": frames}, f)
