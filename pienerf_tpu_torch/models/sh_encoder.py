"""Real spherical-harmonics direction encoding, degree 4.

Same basis order and signs as ``pienerf_tpu.models.sh_encoder`` (the tcnn
convention the checkpoints were trained with).
"""

from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.48860251190291987
C2 = (1.0925484305920792, 0.94617469575755997, 0.31539156525251999,
      0.54627421529603959)
C3 = (0.59004358992664352, 2.8906114426405538, 0.45704579946446572,
      0.3731763325901154, 1.4453057213202769)
C4 = (2.5033429417967046, 1.7701307697799304, 0.94617469575756008,
      0.66904654355728921, 3.1735664074561294, 3.7024941420321507,
      0.31735664074561293, 0.47308734787878004, 3.7550144126950569,
      0.62583573544917614)


def sh_encode(dirs, feature_major: bool = False) -> torch.Tensor:
    """Degree 4 (the only degree the entry points use). dirs: [..., 3]
    unit vectors (or a tuple of 3 component tensors).

    Returns [..., 16], or [16, ...] when ``feature_major``."""
    if isinstance(dirs, (tuple, list)):
        x, y, z = dirs
    else:
        x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    xy, xz, yz = x * y, x * z, y * z
    x2, y2, z2 = x * x, y * y, z * z
    one = torch.ones_like(x)
    out = [
        C0 * one, -C1 * y, C1 * z, -C1 * x,
        C2[0] * xy, -C2[0] * yz, C2[1] * z2 - C2[2], -C2[0] * xz,
        C2[3] * (x2 - y2),
        C3[0] * y * (-3.0 * x2 + y2), C3[1] * xy * z,
        C3[2] * y * (1.0 - 5.0 * z2), C3[3] * z * (5.0 * z2 - 3.0),
        C3[2] * x * (1.0 - 5.0 * z2), C3[4] * z * (x2 - y2),
        C3[0] * x * (-x2 + 3.0 * y2),
    ]
    return torch.stack(out, dim=0 if feature_major else -1)
