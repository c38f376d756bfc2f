"""3D Morton (Z-order) codes: the occupancy grid's cell order.

Port of ``pienerf_tpu.ops.morton``. The bit tricks run in int64 with
32-bit masks (torch's uint32 lacks most ops on CUDA); the codes are the
JAX package's int32 codes.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v so two zero bits sit between each."""
    v = (v | (v << 16)) & 0xFF0000FF
    v = (v | (v << 8)) & 0x0F00F00F
    v = (v | (v << 4)) & 0xC30C30C3
    v = (v | (v << 2)) & 0x49249249
    return v


def _u32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int64) & _M32


def morton3d(x, y, z) -> torch.Tensor:
    """Interleave 10-bit x, y, z into a 30-bit Morton code (int32)."""
    code = (_expand_bits(_u32(x)) | (_expand_bits(_u32(y)) << 1)
            | (_expand_bits(_u32(z)) << 2))
    return (code & _M32).to(torch.int32)


def _compact_bits(x: torch.Tensor) -> torch.Tensor:
    x = x & 0x49249249
    x = (x | (x >> 2)) & 0xC30C30C3
    x = (x | (x >> 4)) & 0x0F00F00F
    x = (x | (x >> 8)) & 0xFF0000FF
    x = (x | (x >> 16)) & 0x0000FFFF
    return x


def morton3d_invert(code):
    """Inverse of morton3d: code -> (x, y, z) int32."""
    code = _u32(code)
    return tuple(_compact_bits(code >> s).to(torch.int32) for s in (0, 1, 2))


def morton3d_np(x, y, z) -> np.ndarray:
    """numpy twin for host-side work (the multiply form of the reference)."""
    x, y, z = (np.asarray(a, np.uint32) for a in (x, y, z))

    def expand(v):
        v = (v * np.uint32(0x00010001)) & np.uint32(0xFF0000FF)
        v = (v * np.uint32(0x00000101)) & np.uint32(0x0F00F00F)
        v = (v * np.uint32(0x00000011)) & np.uint32(0xC30C30C3)
        v = (v * np.uint32(0x00000005)) & np.uint32(0x49249249)
        return v

    with np.errstate(over="ignore"):
        return (expand(x) | (expand(y) << np.uint32(1))
                | (expand(z) << np.uint32(2))).astype(np.int32)
