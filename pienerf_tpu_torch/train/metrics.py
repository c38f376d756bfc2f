"""Quality metrics: PSNR, SSIM (reference: nerf/utils.py:231-339).

Port of ``pienerf_tpu.train.metrics`` (numpy and scipy, the same
arithmetic). LPIPS and CLIP guidance need pretrained weights that are not
vendored; ``guidance_weights`` finds them where the JAX package looks
(``$PIENERF_LPIPS_WEIGHTS`` / ``$PIENERF_CLIP_WEIGHTS``, else the port's
``assets/``). Without them the trainer logs and goes on as JAX's does; with
them the port raises, since the guidance nets are not ported yet (ROADMAP
section 1, item 11).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

_ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets")
_GUIDANCE = {"lpips": ("PIENERF_LPIPS_WEIGHTS", "lpips_alex.npz"),
             "clip": ("PIENERF_CLIP_WEIGHTS", "clip_vit_b16.npz")}


def guidance_weights(kind: str) -> Optional[str]:
    """The weight file of "lpips" or "clip" where the JAX package would
    load one, else None."""
    env, name = _GUIDANCE[kind]
    p = os.environ.get(env, os.path.join(_ASSETS, name))
    return p if os.path.exists(p) else None


def guidance_unported(kind: str):
    return NotImplementedError(
        f"{kind} weights found at {guidance_weights(kind)}: the {kind} net "
        "is not ported yet (ROADMAP section 1, item 11); unset the weights "
        "to train as the JAX package does without them")


def psnr(pred: np.ndarray, gt: np.ndarray) -> float:
    mse = float(np.mean((np.asarray(pred, np.float64) - np.asarray(gt, np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return -10.0 * np.log10(mse)


def _gaussian_kernel(size=11, sigma=1.5):
    ax = np.arange(size) - size // 2
    k = np.exp(-(ax**2) / (2 * sigma**2))
    k = np.outer(k, k)
    return k / k.sum()


def ssim(pred: np.ndarray, gt: np.ndarray, data_range: float = 1.0) -> float:
    """Windowed SSIM over channels (Wang et al. 2004), numpy implementation."""
    from scipy.signal import fftconvolve

    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    if pred.ndim == 2:
        pred, gt = pred[..., None], gt[..., None]
    k = _gaussian_kernel()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2

    vals = []
    for c in range(pred.shape[-1]):
        x, y = pred[..., c], gt[..., c]
        mx = fftconvolve(x, k, mode="valid")
        my = fftconvolve(y, k, mode="valid")
        mxx = fftconvolve(x * x, k, mode="valid")
        myy = fftconvolve(y * y, k, mode="valid")
        mxy = fftconvolve(x * y, k, mode="valid")
        vx = mxx - mx**2
        vy = myy - my**2
        cxy = mxy - mx * my
        s = ((2 * mx * my + c1) * (2 * cxy + c2)) / (
            (mx**2 + my**2 + c1) * (vx + vy + c2)
        )
        vals.append(s.mean())
    return float(np.mean(vals))


class PSNRMeter:
    def __init__(self):
        self.vals: List[float] = []

    def update(self, pred, gt):
        self.vals.append(psnr(pred, gt))

    def measure(self) -> float:
        return float(np.mean(self.vals)) if self.vals else 0.0

    def clear(self):
        self.vals = []

    def report(self) -> str:
        return f"PSNR = {self.measure():.6f}"


class SSIMMeter(PSNRMeter):
    def update(self, pred, gt):
        self.vals.append(ssim(pred, gt))

    def report(self) -> str:
        return f"SSIM = {self.measure():.6f}"


class LPIPSMeter(PSNRMeter):
    """LPIPS(alex): ``available()`` is False without its weights, and the
    evaluation then leaves it out, as JAX's does; with them ``update``
    raises (the LPIPS net is ROADMAP section 1, item 11)."""

    @staticmethod
    def available() -> bool:
        return guidance_weights("lpips") is not None

    def update(self, pred, gt):
        raise guidance_unported("lpips")

    def report(self) -> str:
        return f"LPIPS = {self.measure():.6f}"
