"""Adaptive uniform sampling: trained field -> physics point cloud (port of
``pienerf_tpu.sample``).

A regular sub_res^3 lattice over the scene (or the clamped cut_bounds), the
density queried as the occupancy 1 - exp(-sigma / 128) on the device,
density-gradient-driven boundary refinement, thresholding, and per-point
volumes vp = hgs^3 / points-in-cell. The host arithmetic is the JAX
package's, in numpy and float64, with the same ``np.random.RandomState``
draws, so a shared density function gives bit-equal points; the per-cell
fill that JAX runs as a Python loop over cells is one vectorised gather
(``_fill_cells``) with the same multiply and add per value.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from pienerf_tpu_torch.config import PieNeRFConfig
from pienerf_tpu_torch.io.ply import write_ply
from pienerf_tpu_torch.models import network


def _fill_cells(mins: np.ndarray, counts: np.ndarray, block: np.ndarray,
                step: np.ndarray) -> np.ndarray:
    """Cell i gets ``mins[i] + block[:counts[i]] * step``, cells in order:
    [sum(counts), 3]."""
    total = int(counts.sum())
    cell = np.repeat(np.arange(len(counts)), counts)
    first = np.repeat(np.cumsum(counts) - counts, counts)
    return mins[cell] + block[np.arange(total) - first] * step


class AdaptiveUniformSampling:
    def __init__(self, cfg: PieNeRFConfig, field: network.FieldMLP,
                 spec: network.NetworkSpec):
        self.cfg = cfg
        self.field = field
        self.spec = spec
        self.bound = cfg.bound
        self.threshold = cfg.density_threshold
        self.res = cfg.sub_res
        self.grid_size = 2 * self.bound / self.res
        self.device = field.sigma_net[0].device

        def occupancy(x: torch.Tensor) -> torch.Tensor:
            with torch.no_grad():
                return 1.0 - torch.exp(-field.density(x)[0] / 128.0)

        self._density = occupancy

    def get_density(self, x: np.ndarray, chunk: int = 2**18) -> np.ndarray:
        """The occupancy at x [N, 3] (cast to float32), ``chunk`` points at
        a time on the field's device: [N] float32."""
        x = np.asarray(x, np.float32)
        out = []
        for s in range(0, x.shape[0], chunk):
            xs = torch.as_tensor(x[s:s + chunk], device=self.device)
            out.append(self._density(xs).float().cpu().numpy())
        return (np.concatenate(out) if out
                else np.zeros((0,), np.float32))

    def get_point_volumes(self, pts: np.ndarray) -> np.ndarray:
        """vp = hgs^3 / points-in-cell (main_sample.py:181-200)."""
        hgs = self.cfg.hash_grid_size
        bbmin = pts.min(0) - 1e-3
        bbmax = pts.max(0) + 1e-3
        res = np.ceil((bbmax - bbmin) / hgs).astype(np.int64)
        g = np.floor((pts - bbmin) / hgs).astype(np.int64)
        gid = g[:, 2] * res[1] * res[0] + g[:, 1] * res[0] + g[:, 0]
        counts = np.bincount(gid, minlength=int(res.prod()))
        return (hgs**3 / counts[gid]).astype(np.float64)

    def lattice(self):
        """(xs, ys, zs): the lattice's axes, the scene's or the cut box
        clamped to it (main_sample.py:202-223)."""
        cfg, res = self.cfg, self.res
        if cfg.cut:
            cb = list(cfg.cut_bounds)
            for i in (0, 2, 4):
                cb[i] = max(cb[i], -cfg.bound)
            for i in (1, 3, 5):
                cb[i] = min(cb[i], cfg.bound)
            return (np.linspace(cb[0], cb[1], res),
                    np.linspace(cb[2], cb[3], res),
                    np.linspace(cb[4], cb[5], res))
        xs = np.linspace(-cfg.bound, cfg.bound, res)
        return xs, xs, xs

    def sub_dims(self, grid_density: np.ndarray) -> np.ndarray:
        """Subdivisions of each of the [res-1]^3 cells from the density
        gradient across its 8 corners (main_sample.py:100-140); 0 where the
        gradient is 0."""
        d = grid_density
        c000 = d[:-1, :-1, :-1]
        c001 = d[:-1, :-1, 1:]
        c010 = d[:-1, 1:, :-1]
        c011 = d[:-1, 1:, 1:]
        c100 = d[1:, :-1, :-1]
        c101 = d[1:, :-1, 1:]
        c110 = d[1:, 1:, :-1]
        c111 = d[1:, 1:, 1:]
        grad_x = (c100 + c101 + c110 + c111) - (c000 + c001 + c010 + c011)
        grad_y = (c010 + c011 + c110 + c111) - (c000 + c001 + c100 + c101)
        grad_z = (c001 + c011 + c101 + c111) - (c000 + c010 + c100 + c110)
        grad_norm = np.sqrt(grad_x**2 + grad_y**2 + grad_z**2)
        sub_dims = (self.grid_size * self.cfg.sub_coeff * self.res
                    * grad_norm).astype(np.int64)
        sub_dims[grad_norm == 0] = 0
        return sub_dims

    def sample(self, write_path: Optional[str] = None, seed: int = 0
               ) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        res = self.res
        rng = np.random.RandomState(seed)

        xs, ys, zs = self.lattice()
        gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
        grid_pts = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], -1)
        grid_density = self.get_density(grid_pts).reshape(res, res, res)
        sub_dims = self.sub_dims(grid_density)

        # boundary cells get sub_dim^3 points of one shared random block,
        # scaled into the cell (main_sample.py:71-97)
        cells = np.argwhere(sub_dims > 0)
        dims = sub_dims[cells[:, 0], cells[:, 1], cells[:, 2]]
        counts = dims**3
        if int(counts.sum()) > 0:
            max_dim = int(dims.max())
            shared_block = rng.rand(max_dim**3, 3)
            mins = np.stack([xs[cells[:, 0]], ys[cells[:, 1]],
                             zs[cells[:, 2]]], -1)
            step = np.array([xs[1] - xs[0], ys[1] - ys[0], zs[1] - zs[0]])
            pnts_add = _fill_cells(mins, counts, shared_block, step)
        else:
            pnts_add = np.zeros((0, 3))

        # the union with the half-cell-shifted lattice, thresholded
        pts = np.concatenate(
            [pnts_add, grid_pts + 0.5 * 2 * cfg.bound / res], axis=0)
        density = self.get_density(pts)
        pts = pts[density > self.threshold]
        if pts.shape[0] == 0:
            raise ValueError("no points sampled: the field has no density "
                             "above --density_threshold on this lattice")

        vols = self.get_point_volumes(pts)
        if write_path:
            write_ply(write_path, pts.astype(np.float64), vp=vols)
        return {"points": pts, "volumes": vols}
