"""Dataset pose conventions (port of ``pienerf_tpu.data.provider``:
``nerf_matrix_to_ngp`` only; the loaders wait for the trainer)."""

from __future__ import annotations

import numpy as np


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
