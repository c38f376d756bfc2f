"""LPIPS perceptual distance (port of ``pienerf_tpu.train.lpips``;
reference nerf/utils.py:286-316, the ``lpips`` package's AlexNet).

The metric is defined by pretrained weights, which are not vendored here.
The net is complete and differentiable, usable as the eval meter and as
the reference's patch training loss (trainer.py:207-218), and activates
when a weight file is at ``$PIENERF_LPIPS_WEIGHTS`` or
``pienerf_tpu_torch/assets/lpips_alex.npz``. Export the npz once from any
machine with the ``lpips`` package::

    import lpips, numpy as np
    m = lpips.LPIPS(net='alex')
    np.savez("lpips_alex.npz",
             **{k: v.numpy() for k, v in m.state_dict().items()})

The loader accepts that raw state-dict layout (``net.slice{K}.{idx}.weight``
/ ``lin{K}.model.1.weight``) and the canonical keys (``conv{i}_w``,
``conv{i}_b``, ``lin{i}_w``). The convolutions are ``F.conv2d`` (the JAX
package runs them as XLA convolutions, outside any Pallas kernel).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

# AlexNet feature extractor: (in_ch, out_ch, kernel, stride, pad), with a
# 3x3 / 2 max pool before slices 2 and 3 (torchvision AlexNet.features)
_ALEX = [
    (3, 64, 11, 4, 2),
    (64, 192, 5, 1, 2),
    (192, 384, 3, 1, 1),
    (384, 256, 3, 1, 1),
    (256, 256, 3, 1, 1),
]
# the conv layers' indices inside torchvision AlexNet.features
_FEATURE_IDX = [0, 3, 6, 8, 10]
# the LPIPS input normalisation (its ScalingLayer constants)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

_DEFAULT_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "lpips_alex.npz")


def weights_path() -> Optional[str]:
    p = os.environ.get("PIENERF_LPIPS_WEIGHTS", _DEFAULT_PATH)
    return p if os.path.exists(p) else None


def available() -> bool:
    return weights_path() is not None


def load_weights(path: Optional[str] = None) -> Dict[str, np.ndarray]:
    """LPIPS-alex weights from an npz as canonical numpy arrays
    (conv{i}_w [out, in, k, k], conv{i}_b [out], lin{i}_w), from either
    key layout; shapes checked. ``weights.lpips_to_torch`` puts them on a
    device."""
    path = path or weights_path()
    if path is None:
        raise FileNotFoundError(
            "LPIPS needs pretrained AlexNet weights; export them to "
            "pienerf_tpu_torch/assets/lpips_alex.npz or set "
            "$PIENERF_LPIPS_WEIGHTS (see train/lpips.py docstring)")
    with np.load(path) as z:
        raw = {k: z[k] for k in z.files}
    if "conv0_w" in raw:
        out = raw
    else:
        out = {}
        for i, fi in enumerate(_FEATURE_IDX):
            out[f"conv{i}_w"] = raw[f"net.slice{i + 1}.{fi}.weight"]
            out[f"conv{i}_b"] = raw[f"net.slice{i + 1}.{fi}.bias"]
            out[f"lin{i}_w"] = raw[f"lin{i}.model.1.weight"]
    for i, (ci, co, k, _, _) in enumerate(_ALEX):
        if out[f"conv{i}_w"].shape != (co, ci, k, k):
            raise ValueError(f"conv{i}_w shape {out[f'conv{i}_w'].shape}, "
                             f"AlexNet wants {(co, ci, k, k)}")
        if out[f"lin{i}_w"].reshape(-1).shape != (co,):
            raise ValueError(f"lin{i}_w shape {out[f'lin{i}_w'].shape}")
    return out


def _features(x: torch.Tensor, w: Dict[str, torch.Tensor]
              ) -> List[torch.Tensor]:
    """AlexNet's relu taps. x: [B, 3, H, W] in [-1, 1]."""
    shift = torch.as_tensor(_SHIFT, device=x.device)[None, :, None, None]
    scale = torch.as_tensor(_SCALE, device=x.device)[None, :, None, None]
    h = (x - shift) / scale
    taps = []
    for i, (_, _, _, stride, pad) in enumerate(_ALEX):
        if i in (1, 2):          # 3x3 / 2 max pool before slices 2 and 3
            h = F.max_pool2d(h, 3, 2)
        h = F.conv2d(h, w[f"conv{i}_w"], stride=stride, padding=pad)
        h = h + w[f"conv{i}_b"][None, :, None, None]
        # maximum, not relu: at a tie it passes half the gradient, as
        # jnp.maximum does
        h = torch.maximum(h, torch.zeros((), device=h.device))
        taps.append(h)
    return taps


def lpips(pred: torch.Tensor, gt: torch.Tensor,
          w: Dict[str, torch.Tensor]) -> torch.Tensor:
    """LPIPS distance per batch item: [B]. pred, gt: [B, H, W, 3] in [0, 1],
    H and W at least 32. Differentiable: the reference adds it, weighted
    1e-3, to the patch loss (nerf/trainer.py:218)."""
    if pred.shape[1] < 32 or pred.shape[2] < 32:
        raise ValueError(
            "LPIPS(alex) needs >=32px inputs (the conv/pool stack collapses "
            "below that, as in the torch implementation)")

    def prep(img):
        return (img.float() * 2.0 - 1.0).permute(0, 3, 1, 2)

    fa = _features(prep(pred), w)
    fb = _features(prep(gt), w)
    total = 0.0
    for i, (a, b) in enumerate(zip(fa, fb)):
        na = a / torch.sqrt((a * a).sum(dim=1, keepdim=True) + 1e-10)
        nb = b / torch.sqrt((b * b).sum(dim=1, keepdim=True) + 1e-10)
        d = (na - nb) ** 2                               # [B, C, H, W]
        lin = w[f"lin{i}_w"].reshape(1, -1, 1, 1)
        total = total + (d * lin).sum(dim=1).mean(dim=(1, 2))
    return total
