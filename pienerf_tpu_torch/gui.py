"""Interactive GUI logic: picking, spring forces, dynamic resolution
(port of ``pienerf_tpu.gui``, numpy only, its own copy).

The interaction logic of the reference's dearpygui viewer
(reference: nerf/gui.py:439-952) as headless-testable pure functions; the
port's front-end is the browser page of ``web_viewer``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def screen_to_world(px: float, py: float, depth: float, pose: np.ndarray,
                    intrinsics) -> np.ndarray:
    """Unproject a pixel at ray-depth `depth` to world space
    (reference nerf/gui.py:647-658: picking uses the raw depth buffer)."""
    fx, fy, cx, cy = intrinsics
    d = np.array([(px + 0.5 - cx) / fx, (py + 0.5 - cy) / fy, 1.0])
    d /= np.linalg.norm(d)
    world_dir = pose[:3, :3] @ d
    return pose[:3, 3] + depth * world_dir


def pick_ip(target_world: np.ndarray, ip_positions: np.ndarray,
            max_dist: float = 0.2) -> int:
    """Nearest IP to a picked world point; -1 when too far
    (reference nerf/gui.py:560-569)."""
    d = np.linalg.norm(ip_positions - target_world[None], axis=1)
    i = int(np.argmin(d))
    return i if d[i] <= max_dist else -1


def spring_force(ip_pos: np.ndarray, target: np.ndarray,
                 scale: float = 1.0, gain: float = 1e5,
                 clamp: float = 5e5) -> np.ndarray:
    """Drag force toward the mouse target (reference nerf/gui.py:570-576)."""
    f = gain * scale * (np.asarray(target) - np.asarray(ip_pos))
    n = np.linalg.norm(f)
    if n > clamp:
        f = f * (clamp / n)
    return f


@dataclass
class DynamicResolution:
    """Frame-time-targeting downscale controller
    (reference nerf/gui.py:606-611: target 80 ms, floor 1/4 scale)."""
    target_ms: float = 80.0
    scale: float = 1.0
    min_scale: float = 0.25
    max_scale: float = 1.0

    def update(self, frame_ms: float) -> float:
        full_ms = frame_ms / max(self.scale**2, 1e-6)
        ideal = float(np.sqrt(self.target_ms / max(full_ms, 1e-6)))
        # move halfway toward the ideal scale for hysteresis
        self.scale = float(np.clip(0.5 * (self.scale + ideal),
                                   self.min_scale, self.max_scale))
        return self.scale


@dataclass
class InteractionState:
    """Pause toggle / force lifecycle (reference key bindings:
    space = pause, drag = force, Q/right-click = release)."""
    paused: bool = False
    force_ip: int = -1
    force: np.ndarray = field(default_factory=lambda: np.zeros(3))
    force_scale: float = 1.0

    def toggle_pause(self):
        self.paused = not self.paused

    def start_drag(self, px, py, depth, pose, intrinsics, ip_positions):
        world = screen_to_world(px, py, depth, pose, intrinsics)
        self.force_ip = pick_ip(world, ip_positions)
        return self.force_ip

    def drag_to(self, px, py, depth, pose, intrinsics, ip_positions):
        if self.force_ip < 0:
            # nothing held yet (e.g. the press missed the surface) — try
            # picking where the drag currently is
            self.start_drag(px, py, depth, pose, intrinsics, ip_positions)
        if self.force_ip < 0:
            return np.zeros(3)
        target = screen_to_world(px, py, depth, pose, intrinsics)
        self.force = spring_force(ip_positions[self.force_ip], target,
                                  self.force_scale)
        return self.force

    def wheel(self, delta: float):
        self.force_scale = float(np.clip(self.force_scale * 1.1**delta,
                                         0.01, 100.0))

    def release(self):
        self.force_ip = -1
        self.force = np.zeros(3)


def have_dearpygui() -> bool:
    try:
        import dearpygui  # noqa: F401
        return True
    except ImportError:
        return False
