"""Offline deformed rendering of dumped sim state (port of main_render.py).

Renders one frame from ``{dump_dir}/ip_pos_{i}.npy``, ``ip_F_{i}.npy``,
``ip_dF_{i}.npy`` (and ``ip_rest.npy`` when present, else the dumped
positions stand for the rest ones) through ``interactive.render_frame``,
whose field runs through the field kernel, and writes a PNG:

    python -m pienerf_tpu_torch.main_render --workspace runs/quality_mlp_800 \\
        --backbone mlp --dump_dir debug --frame 0 --out render_out.png

The field loads as ``main_gui`` loads it (``--ckpt`` / ``--ckpt_path``, the
reference trainer's rule; the mlp backbone). The pose comes from
``--pose_json`` (a transforms file; ``--pose_name`` picks a frame by its
file_path) or is the camera at (0, 0, -2.5). Runs on the card;
``--device cpu`` is the only way onto the CPU.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def load_dump(dump_dir: str, i: int):
    """(p_def, p_ori, F [n, 3, 3], dF [n, 3, 3, 3]) of dumped frame i;
    flattened reference-style F / dF dumps are reshaped."""
    p_def = np.load(os.path.join(dump_dir, f"ip_pos_{i}.npy"))
    F = np.load(os.path.join(dump_dir, f"ip_F_{i}.npy"))
    dF = np.load(os.path.join(dump_dir, f"ip_dF_{i}.npy"))
    rest = os.path.join(dump_dir, "ip_rest.npy")
    p_ori = np.load(rest) if os.path.exists(rest) else p_def
    return p_def, p_ori, F.reshape(-1, 3, 3), dF.reshape(-1, 3, 3, 3)


def pose_of(cfg, pose_json, pose_name) -> np.ndarray:
    """The render pose (reference main_render.py:28-45)."""
    from pienerf_tpu_torch.data.provider import nerf_matrix_to_ngp

    if not pose_json:
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = (0, 0, -2.5)
        return pose
    with open(pose_json) as f:
        frames = json.load(f)["frames"]
    fr = frames[0]
    if pose_name:
        fr = next((c for c in frames if pose_name in c["file_path"]), fr)
    return nerf_matrix_to_ngp(np.array(fr["transform_matrix"], np.float32),
                              scale=cfg.scale, offset=cfg.offset)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dump_dir", type=str, default="debug")
    parser.add_argument("--frame", type=int, default=0)
    parser.add_argument("--pose_json", type=str, default=None)
    parser.add_argument("--pose_name", type=str, default=None,
                        help="substring of the frame file_path to render")
    parser.add_argument("--out", type=str, default="render_out.png")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    from pienerf_tpu_torch.config import get_shared_opts
    cfg = get_shared_opts(parser, argv)
    ns, _ = parser.parse_known_args(argv)

    import torch

    from pienerf_tpu_torch.device import resolve_device
    from pienerf_tpu_torch.io.framesink import write_png
    from pienerf_tpu_torch.kernels import field as field_kernel
    from pienerf_tpu_torch.main_gui import _load_field
    from pienerf_tpu_torch.ops import beam_bend
    from pienerf_tpu_torch.render import interactive

    device = resolve_device(ns.device)
    spec, pw = _load_field(cfg, device)
    p_def, p_ori, F, dF = (torch.as_tensor(np.asarray(a, np.float32),
                                           device=device)
                           for a in load_dump(ns.dump_dir, ns.frame))
    pose = torch.as_tensor(pose_of(cfg, ns.pose_json, ns.pose_name),
                           device=device)
    H = (cfg.H // 16) * 16
    W = (cfg.W // 16) * 16
    focal = H / (2 * np.tan(np.radians(cfg.fovy) / 2))
    intr = (focal, focal, W / 2, H / 2)
    bst = beam_bend.BeamBendSettings(
        num_seek_ip=cfg.num_seek_IP, max_iter_num=cfg.max_iter_num,
        ip_dx=1.05 * cfg.sim_dx)
    ist = interactive.InteractiveSettings(
        spec=spec, bend=bst, samples=96, min_near=cfg.min_near,
        T_thresh=cfg.T_thresh, cut=cfg.cut, bound=cfg.bound)
    cut_bounds = (torch.tensor(cfg.cut_bounds, dtype=torch.float32,
                               device=device) if cfg.cut else None)
    before = dict(field_kernel.field_eval.launches)
    pack = beam_bend.pack_for(bst, p_def, p_ori, F, dF)
    out = interactive.render_frame(ist, pw, pack, p_def, pose, intr, H, W,
                                   1.0, cut_bounds)
    img = interactive.tiles_to_image(out["tiles_image"], H, W, ist.tile)
    write_png(ns.out, (np.clip(img, 0, 1) * 255).astype(np.uint8))
    launched = {f"w{w}_{t}": n - before[(w, t)]
                for (w, t), n in field_kernel.field_eval.launches.items()
                if n > before[(w, t)]}
    print(f"field kernel launches: {json.dumps(launched)}")
    print(f"wrote {ns.out}")


if __name__ == "__main__":
    main()
