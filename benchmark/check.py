"""Whether what the timed path produced is correct: the plain reference
(``reference/``) rebuilt from the same inputs, and each number compared
with its limit.

The numbers, each larger when worse:

- ``image_rmse``: the largest, over the sampled frames, root-mean-square
  gap between a fetched image and the reference's frame at its pose,
  leaving out the frame's ``TRIM_PIXELS`` pixels of largest gap: a
  sample whose transmittance sits at ``T_thresh``, or whose bend sits at
  a reject boundary or a nearest-row tie, goes one way in the kernel and
  the other in the reference on f32 rounding alone and moves its pixel
  by up to the sample's weight (``image_rmse_all`` keeps every pixel and
  is reported, not compared);
- ``flip_pixels``: the most pixels of one sampled frame whose gap
  exceeds 1e-3, so a fault confined to more pixels than the trim leaves
  out fails here whatever its size;
- ``counters_diff``: the summed absolute gap of the frame counters that
  the field cannot move (n_active, dropped_beam, n_tile_overflow) over
  the sampled frames;
- ``window_drop_diff``: the same of dropped_window, which the tile pass
  counts only in the segments it runs, so the field's early exit moves it;
- ``ddof_rel``: the set-up drag's state, max |program - reference| over
  the reference's max |ddof|;
- ``pack_rel``: the per-IP pack the frames read, likewise.

A number that is not finite fails its limit.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.cell import Inputs, material
from benchmark.reference import hashgrid
from benchmark.reference import render as ref_render
from benchmark.reference import sim as ref_sim

# pixels of a frame left out of ``image_rmse``: rounding flips a handful
# of discrete decisions a frame (at most 3 pixels in any sampled frame of
# the two cells on the card); a fault that alters more pixels than this
# shows in ``image_rmse``, one that alters more than ``flip_pixels``'s
# limit fails that too
TRIM_PIXELS = 8


@contextmanager
def matmul_precision(tf32: bool):
    """f32 products in true f32 (``tf32`` False) or in TF32, restored
    after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def settings(inp: Inputs) -> ref_render.Settings:
    rd, fc = inp.cfg["render"], inp.cfg["field"]
    backbone = fc.get("backbone", "mlp")
    mlp = backbone == "mlp"
    return ref_render.Settings(
        samples=rd["K"], num_seek=rd["num_seek"],
        ip_dx=rd["ip_dx_factor"] * inp.cfg["scene"]["lattice"],
        ips_per_tile=rd["ips_per_tile"], bend_window=rd["bend_window"],
        active_frac=rd["active_frac"], tile_chunk=rd["tile_chunk"],
        min_near=rd["min_near"], T_thresh=rd["T_thresh"],
        tighten=rd["tighten"], cut=rd["cut"], bound=rd["bound"],
        cut_static_frac=rd["cut_static_frac"],
        n_freqs=fc["n_freqs"] if mlp else 0, dtype=inp.cfg["dtype"],
        backbone=backbone,
        grid=None if mlp else hashgrid.layout(**fc["grid"]))


class Reference:
    """The reference's scene after the same set-up drag, ready to render
    any pose of the cell. ``tf32_sim`` and ``tf32_render`` run the drag's
    and the frames' f32 products in TF32: the control's lower precision."""

    def __init__(self, inp: Inputs, device, tf32_sim: bool = False,
                 tf32_render: bool = False):
        self.inp, self.dev, self.tf32 = inp, device, tf32_render
        with matmul_precision(tf32_sim):
            mass, mu, lam = material(inp)
            sc, st = ref_sim.scene_init(inp.points, mass, mu, lam, inp.pin,
                                        device=device, **inp.sim_kw)
            vid = int(torch.argmax(sc.ip_pos[:, 2]))
            for fi in range(inp.traffic["drag_frames"]):
                f = ref_sim.spring_force(sc.ip_pos, sc.IP_kernel, sc.IP_Nx,
                                         st.ddof, vid, fi, inp.spring)
                st = ref_sim.step(sc, ref_sim.apply_force(sc, st, vid, f))
            self.ddof = st.ddof
            self.p_def, F, _ = ref_sim.ip_info(sc, st)
            self.pack = ref_render.pack_ips(self.p_def, sc.ip_pos, F)
        self.st = settings(inp)
        self.layers = tuple([torch.as_tensor(w, device=device)
                             for w in inp.layers[k]]
                            for k in ("sigma_net", "color_net"))
        self.table = (torch.as_tensor(inp.layers["encoder"][0], device=device)
                      if "encoder" in inp.layers else None)
        self.cut_box = (None if inp.cut_bounds is None else torch.tensor(
            inp.cut_bounds, dtype=torch.float32, device=device))
        self._frames: Dict[int, tuple] = {}

    def frame(self, pose_idx: int, passes: Optional[list] = None):
        """(image [n_tiles, 256, 3] numpy, counters [4] numpy) at pose
        ``pose_idx``, rendered once a pose; the first render appends its
        passes' work to ``passes``."""
        if pose_idx in self._frames:
            return self._frames[pose_idx]
        rd = self.inp.cfg["render"]
        pose = torch.as_tensor(self.inp.poses[pose_idx], device=self.dev)
        with matmul_precision(self.tf32), torch.no_grad():
            img, ctr = ref_render.render_frame(
                self.st, self.layers, self.pack, self.p_def, pose,
                self.inp.intr, rd["H"], rd["W"], 1.0, self.cut_box, passes,
                self.table)
        self._frames[pose_idx] = (img.cpu().numpy(), ctr.cpu().numpy())
        return self._frames[pose_idx]


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    scale = float(np.max(np.abs(b)))
    return float(np.max(np.abs(a - b)) / max(scale, 1e-30))


def compare(ref: Reference, ddof: np.ndarray, pack: np.ndarray,
            samples: List[tuple]) -> Dict[str, float]:
    """The numbers for the program's set-up state, its pack and the
    sampled frames ``(pose index, image, counters)``."""
    rmse, rmse_all, cdiff, wdiff, flips = 0.0, 0.0, 0, 0, 0
    for pose_idx, img, ctr in samples:
        rimg, rctr = ref.frame(pose_idx)
        err = np.asarray(img, np.float64) - rimg.astype(np.float64)
        per_px = np.sort((err * err).reshape(-1, 3).sum(axis=1))
        flips = max(flips, int((per_px > 1e-6).sum()))
        total = float(per_px.sum())
        kept = float(per_px[:-TRIM_PIXELS].sum())
        for name, sq, n in (("all", total, per_px.size),
                            ("trim", kept, per_px.size - TRIM_PIXELS)):
            e = math.sqrt(sq / (3 * n)) if math.isfinite(sq) else math.inf
            if name == "all":
                rmse_all = max(rmse_all, e)
            else:
                rmse = max(rmse, e)
        gap = np.abs(np.asarray(ctr, np.int64) - rctr.astype(np.int64))
        cdiff += int(gap[[0, 1, 3]].sum())
        wdiff += int(gap[2])
    return {"image_rmse": rmse, "image_rmse_all": rmse_all,
            "flip_pixels": float(flips), "counters_diff": float(cdiff),
            "window_drop_diff": float(wdiff),
            "ddof_rel": _rel(ddof, ref.ddof.cpu().numpy()),
            "pack_rel": _rel(pack, ref.pack.cpu().numpy())}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> dict:
    """{name: {"value", "limit"}} for every limit, and whether each holds
    (a number that is not finite never does, and reads as None)."""
    out, ok = {}, True
    for name, lim in limits.items():
        v = numbers.get(name, math.inf)
        fin = math.isfinite(v)
        ok = ok and fin and v <= lim
        out[name] = {"value": v if fin else None, "limit": lim}
    return {"correct": ok, "checks": out}
