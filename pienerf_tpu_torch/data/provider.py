"""Dataset loading: blender (transforms_{split}.json) and colmap
(transforms.json) formats (reference: nerf/provider.py:94-332).

Port of ``pienerf_tpu.data.provider``. The JAX package reads images with
cv2 (``imread``, ``cvtColor`` to RGB(A), an ``INTER_AREA`` resize); the
port reads them with ``io.framesink.read_png`` and resizes with
``resize_area``, which reproduces cv2's area interpolation byte for byte:
for integer factors the block mean as cv2 rounds it (``(sum + 2) >> 2``
for 2x2 blocks of 1, 3 or 4 channels, round-half-even of ``sum * (1 /
area)`` otherwise), for other factors cv2's fractional-coverage weights
accumulated in float32 in cv2's order.
"""

from __future__ import annotations

import glob
import json
import math
import os
from typing import List

import numpy as np

from pienerf_tpu_torch.config import PieNeRFConfig
from pienerf_tpu_torch.io.framesink import read_png


def _area_tab(ssize: int, dsize: int, scale: float) -> list:
    """cv2's computeResizeAreaTab: for each destination index, its (source
    index, f32 weight) entries in cv2's order."""
    tab = []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx2 = min(math.floor(fsx2), ssize - 1)
        sx1 = min(math.ceil(fsx1), sx2)
        ent = []
        if sx1 - fsx1 > 1e-3:
            ent.append((sx1 - 1, np.float32((sx1 - fsx1) / cell)))
        ent += [(sx, np.float32(1.0 / cell)) for sx in range(sx1, sx2)]
        if fsx2 - sx2 > 1e-3:
            ent.append((sx2, np.float32(min(fsx2 - sx2, 1.0, cell) / cell)))
        tab.append(ent)
    return tab


def resize_area(img: np.ndarray, size) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_AREA)`` for a
    downscale of a uint8 [H, W] or [H, W, C] image; size = (W', H')."""
    H, W = img.shape[:2]
    W2, H2 = size
    sx, sy = 1.0 / (W2 / W), 1.0 / (H2 / H)          # as cv2 derives them
    if sx < 1 or sy < 1:
        raise NotImplementedError("resize_area downscales only")
    src = img if img.ndim == 3 else img[..., None]
    cn = src.shape[-1]
    isx, isy = int(round(sx)), int(round(sy))
    eps = np.finfo(float).eps
    if abs(sx - isx) < eps and abs(sy - isy) < eps:
        # integer factors: cv2's fast path sums each block in int
        s = src.astype(np.int64).reshape(H2, isy, W2, isx, cn).sum((1, 3))
        if isx == 2 and isy == 2 and cn in (1, 3, 4):
            out = (s + 2) >> 2
        else:
            out = np.rint(s.astype(np.float32)
                          * np.float32(1.0 / (isx * isy)))
    else:
        # cv2's resizeArea_: per source row, the row's weighted columns
        # accumulated in float32 entry by entry; rows into each output
        # row likewise; rounding half to even at the end
        xtab = _area_tab(W, W2, sx)
        n = max(len(e) for e in xtab)
        xi = np.zeros((W2, n), np.int64)
        xw = np.zeros((W2, n), np.float32)
        xok = np.zeros((W2, n, 1), bool)
        for d, ent in enumerate(xtab):
            for k, (si, a) in enumerate(ent):
                xi[d, k], xw[d, k], xok[d, k] = si, a, True
        S = src.astype(np.float32)
        out = np.zeros((H2, W2, cn), np.float32)
        for dy, ent in enumerate(_area_tab(H, H2, sy)):
            acc = None
            for si, beta in ent:
                buf = np.zeros((W2, cn), np.float32)
                for k in range(n):
                    buf = np.where(xok[:, k], buf + S[si][xi[:, k]]
                                   * xw[:, k, None], buf)
                acc = beta * buf if acc is None else acc + beta * buf
            out[dy] = np.rint(acc)
    out = np.clip(out, 0, 255).astype(np.uint8)
    return out if img.ndim == 3 else out[..., 0]


def nerf_matrix_to_ngp(pose: np.ndarray, scale: float = 0.33,
                       offset=(0, 0, 0)) -> np.ndarray:
    """Axis permutation + scale/offset into the ngp unit box
    (reference nerf/provider.py:19-27)."""
    return np.array([
        [pose[1, 0], -pose[1, 1], -pose[1, 2], pose[1, 3] * scale + offset[0]],
        [pose[2, 0], -pose[2, 1], -pose[2, 2], pose[2, 3] * scale + offset[1]],
        [pose[0, 0], -pose[0, 1], -pose[0, 2], pose[0, 3] * scale + offset[2]],
        [0, 0, 0, 1],
    ], dtype=np.float32)


def rand_poses(n: int, radius: float = 1.0,
               theta_range=(np.pi / 3, 2 * np.pi / 3),
               phi_range=(0, 2 * np.pi), seed: int = 0) -> np.ndarray:
    """Random orbit poses (reference nerf/provider.py:57-91)."""
    rng = np.random.RandomState(seed)
    thetas = rng.uniform(*theta_range, size=n)
    phis = rng.uniform(*phi_range, size=n)
    centers = np.stack([
        radius * np.sin(thetas) * np.sin(phis),
        radius * np.cos(thetas),
        radius * np.sin(thetas) * np.cos(phis),
    ], axis=-1)

    def norm(v):
        return v / (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-10)

    forward = -norm(centers)
    up = np.tile([0.0, -1.0, 0.0], (n, 1))
    right = norm(np.cross(forward, up))
    up2 = norm(np.cross(right, forward))
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    poses[:, :3, 0] = right
    poses[:, :3, 1] = up2
    poses[:, :3, 2] = forward
    poses[:, :3, 3] = centers
    return poses


def _slerp_test_poses(frames, scale, offset, n_test: int,
                      seed: int = 0) -> np.ndarray:
    """Colmap test split: slerp between two random train poses
    (reference nerf/provider.py:166-182)."""
    from scipy.spatial.transform import Rotation, Slerp

    rng = np.random.RandomState(seed)
    i0, i1 = rng.choice(len(frames), 2, replace=False)
    p0 = nerf_matrix_to_ngp(np.array(frames[i0]["transform_matrix"],
                                     np.float32), scale, offset)
    p1 = nerf_matrix_to_ngp(np.array(frames[i1]["transform_matrix"],
                                     np.float32), scale, offset)
    rots = Rotation.from_matrix(np.stack([p0[:3, :3], p1[:3, :3]]))
    slerp = Slerp([0, 1], rots)
    poses = []
    for i in range(n_test + 1):
        ratio = np.sin(((i / n_test) - 0.5) * np.pi) * 0.5 + 0.5
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = slerp(ratio).as_matrix()
        pose[:3, 3] = (1 - ratio) * p0[:3, 3] + ratio * p1[:3, 3]
        poses.append(pose)
    return np.stack(poses)


class NeRFDataset:
    """Posed-image dataset.

    Exposes poses [B,4,4] f32, images [B,H,W,C] f32 in [0,1], intrinsics
    (fx, fy, cx, cy), H, W — the interface consumed by Trainer.
    """

    def __init__(self, cfg: PieNeRFConfig, type: str = "train",
                 downscale: int = 1, n_test: int = 10):
        self.cfg = cfg
        self.type = type
        self.root_path = cfg.path
        self.training = type in ("train", "all", "trainval")

        if os.path.exists(os.path.join(self.root_path, "transforms.json")):
            self.mode = "colmap"
            with open(os.path.join(self.root_path, "transforms.json")) as f:
                transform = json.load(f)
        elif os.path.exists(os.path.join(self.root_path, "transforms_train.json")):
            self.mode = "blender"
            if type == "all":
                transform = None
                for p in glob.glob(os.path.join(self.root_path, "*.json")):
                    with open(p) as f:
                        t = json.load(f)
                    if transform is None:
                        transform = t
                    else:
                        transform["frames"].extend(t["frames"])
            elif type == "trainval":
                with open(os.path.join(self.root_path, "transforms_train.json")) as f:
                    transform = json.load(f)
                with open(os.path.join(self.root_path, "transforms_val.json")) as f:
                    transform["frames"].extend(json.load(f)["frames"])
            else:
                with open(os.path.join(self.root_path,
                                       f"transforms_{type}.json")) as f:
                    transform = json.load(f)
        else:
            raise NotImplementedError(
                f"no transforms*.json under {self.root_path}")

        if "h" in transform and "w" in transform:
            self.H = int(transform["h"]) // downscale
            self.W = int(transform["w"]) // downscale
        else:
            self.H = self.W = None

        frames = transform["frames"]
        if self.mode == "colmap" and type == "test":
            # view-interpolated test path: poses only, no images
            self.poses = _slerp_test_poses(frames, cfg.scale, cfg.offset,
                                           n_test)
            self.images = None
            self.H = self.H or int(transform.get("h", 800))
            self.W = self.W or int(transform.get("w", 800))
            self._load_intrinsics(transform, downscale)
            self.radius = float(np.linalg.norm(self.poses[:, :3, 3],
                                               axis=-1).mean())
            return
        if self.mode == "colmap":
            if type == "train":
                frames = frames[1:]
            elif type == "val":
                frames = frames[:1]

        poses: List[np.ndarray] = []
        images: List[np.ndarray] = []
        for f in frames:
            f_path = os.path.join(self.root_path, f["file_path"])
            if self.mode == "blender" and "." not in os.path.basename(f_path):
                f_path += ".png"
            if not os.path.exists(f_path):
                continue
            pose = nerf_matrix_to_ngp(
                np.array(f["transform_matrix"], np.float32),
                scale=cfg.scale, offset=cfg.offset,
            )
            image = read_png(f_path)                 # RGB(A) already
            if self.H is None:
                self.H = image.shape[0] // downscale
                self.W = image.shape[1] // downscale
            if image.shape[0] != self.H or image.shape[1] != self.W:
                image = resize_area(image, (self.W, self.H))
            poses.append(pose)
            images.append(image.astype(np.float32) / 255.0)

        self.poses = np.stack(poses)
        self.images = np.stack(images) if images else None
        self.radius = float(np.linalg.norm(self.poses[:, :3, 3], axis=-1).mean())

        self._load_intrinsics(transform, downscale)

    def _load_intrinsics(self, transform, downscale):
        if "fl_x" in transform or "fl_y" in transform:
            fl_x = transform.get("fl_x", transform.get("fl_y")) / downscale
            fl_y = transform.get("fl_y", transform.get("fl_x")) / downscale
        elif "camera_angle_x" in transform or "camera_angle_y" in transform:
            fl_x = (self.W / (2 * np.tan(transform["camera_angle_x"] / 2))
                    if "camera_angle_x" in transform else None)
            fl_y = (self.H / (2 * np.tan(transform["camera_angle_y"] / 2))
                    if "camera_angle_y" in transform else None)
            fl_x = fl_x if fl_x is not None else fl_y
            fl_y = fl_y if fl_y is not None else fl_x
        else:
            raise RuntimeError("cannot determine focal length")
        cx = transform.get("cx", self.W / 2) / downscale if "cx" in transform else self.W / 2
        cy = transform.get("cy", self.H / 2) / downscale if "cy" in transform else self.H / 2
        self.intrinsics = (float(fl_x), float(fl_y), float(cx), float(cy))
