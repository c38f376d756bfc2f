"""Orbit camera producing torch-ngp-convention camera-to-world poses.

Capability parity with the reference viewer camera (reference:
nerf/gui.py:13-58 — orbit/scale/pan and the dataset-pose import
`pose_to_params` at :23-27), built differently: the state is an explicit
orthonormal camera frame updated with Rodrigues rotations rather than a
scipy quaternion object. The produced poses are identical.

Conventions (must match the rest of the pipeline):
- camera-to-world matrix `pose` with columns (right, up, forward) in
  pose[:3, :3] and the camera position in pose[:3, 3];
- the camera looks along +forward (column 2) toward `center`, i.e. the
  camera sits at  -radius * forward - center;
- the initial frame is diag(1, -1, -1) (the ngp convention flip).
"""

from __future__ import annotations

import numpy as np


def _rodrigues(axis_angle: np.ndarray) -> np.ndarray:
    """Rotation matrix for an axis-angle vector (angle = vector norm)."""
    theta = float(np.linalg.norm(axis_angle))
    if theta < 1e-12:
        return np.eye(3, dtype=np.float64)
    k = axis_angle / theta
    K = np.array([[0.0, -k[2], k[1]],
                  [k[2], 0.0, -k[0]],
                  [-k[1], k[0], 0.0]])
    return np.eye(3) + np.sin(theta) * K + (1.0 - np.cos(theta)) * (K @ K)


class OrbitCamera:
    def __init__(self, W: int, H: int, r: float = 2.0, fovy: float = 60.0):
        self.W = int(W)
        self.H = int(H)
        self.radius = float(r)
        self.fovy = float(fovy)
        self.center = np.zeros(3, dtype=np.float32)
        self.up = np.array([0.0, 1.0, 0.0], dtype=np.float32)
        # ngp-convention initial frame: x right, y down, z toward viewer
        self._frame = np.diag([1.0, -1.0, -1.0]).astype(np.float64)

    @property
    def pose(self) -> np.ndarray:
        res = np.eye(4, dtype=np.float32)
        res[:3, :3] = self._frame
        res[:3, 3] = -self.radius * self._frame[:, 2] - self.center
        return res

    @property
    def intrinsics(self):
        focal = self.H / (2.0 * np.tan(np.radians(self.fovy) / 2.0))
        return (focal, focal, self.W // 2, self.H // 2)

    def orbit(self, dx: float, dy: float) -> None:
        """Drag-orbit: dx spins about the world up axis, dy tilts about the
        camera's right axis (0.1 degree per pixel, matching the reference
        feel)."""
        about_up = _rodrigues(self.up * np.radians(-0.1 * dx))
        about_side = _rodrigues(self._frame[:, 0] * np.radians(-0.1 * dy))
        self._frame = about_up @ about_side @ self._frame
        self._renormalize()

    def scale(self, delta: float) -> None:
        self.radius *= 1.1 ** (-delta)

    def pan(self, dx: float, dy: float, dz: float = 0.0) -> None:
        self.center = (self.center
                       + 5e-4 * (self._frame @ np.array([dx, dy, dz]))
                       ).astype(np.float32)

    def pose_to_params(self, pose: np.ndarray) -> None:
        """Adopt a dataset pose (the viewer's train-view slider,
        reference nerf/gui.py:23-27, 703-712). Exact inverse of `pose` for
        any pose this class produces: radius = |position + center| and the
        frame is the rotation block. (The reference approximates radius
        from the z translation only; this recovers it for any
        orientation.)"""
        pose = np.asarray(pose, np.float64)
        self._frame = pose[:3, :3].copy()
        self.radius = float(np.linalg.norm(pose[:3, 3] + self.center))
        self._renormalize()

    def _renormalize(self) -> None:
        """Keep the frame orthonormal under accumulated increments."""
        u, _, vt = np.linalg.svd(self._frame)
        self._frame = u @ vt
