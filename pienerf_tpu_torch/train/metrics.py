"""Quality metrics: PSNR, SSIM, LPIPS (reference: nerf/utils.py:231-339).

Port of ``pienerf_tpu.train.metrics`` (numpy and scipy, the same
arithmetic). LPIPS needs pretrained perceptual weights that are not
vendored (``train/lpips.py``); its meter raises with the export recipe
when measured without them.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch


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
    """LPIPS(alex) through ``train/lpips.py`` on ``device`` (default the
    card): ``available()`` gates use; ``update`` loads the weight file
    the first time, and raises with the export recipe without one."""

    def __init__(self, device=None):
        from pienerf_tpu_torch.device import resolve_device

        super().__init__()
        self.device = resolve_device(device)
        self._w = None

    @staticmethod
    def available() -> bool:
        from pienerf_tpu_torch.train import lpips as lp
        return lp.available()

    def update(self, pred, gt):
        from pienerf_tpu_torch.train import lpips as lp
        from pienerf_tpu_torch.weights import lpips_to_torch

        if self._w is None:
            self._w = lpips_to_torch(lp.load_weights(), self.device)

        def t(img):
            return torch.as_tensor(np.asarray(img, np.float32),
                                   device=self.device)[None]

        with torch.no_grad():
            v = lp.lpips(t(pred), t(gt), self._w)
        self.vals.append(float(v[0]))

    def report(self) -> str:
        return f"LPIPS = {self.measure():.6f}"
