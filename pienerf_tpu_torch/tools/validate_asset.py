"""One-command real-asset validation (port of tools/validate_asset.py).

Given a reference checkpoint (``ngp_ep*.pth``, reference format
nerf/trainer.py:794-854) and an annotated physics PLY (reference
README.md:98-108), this runs the whole chain:

  import .pth -> distill into the tile kernel's mlp student -> field and
  image-space teacher / student agreement (PSNR / SSIM at shared poses;
  the teacher through the occupancy renderer, the student through the tile
  kernel's static mode) -> the coupled sim + deformed-render frame on the
  PLY (``pipeline.interactive_frame_step``, the tile kernel)

and writes one JSON report in the JAX tool's schema:

    python -m pienerf_tpu_torch.tools.validate_asset --pth ngp_ep0300.pth \
        --ply chair.ply --out report.json

The frames are timed on the device: ``bench_frames`` chained frames, each
from the previous frame's state, between two CUDA events. Runs on the card;
``--device cpu`` is the only way onto the CPU (there the host clock times
the frames).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch


def orbit_pose(theta, phi, radius) -> np.ndarray:
    """A look-at pose on the sphere of ``radius`` (tools/validate_asset.py
    :35-46): [4, 4] float32, camera axes right, -up, forward."""
    eye = radius * np.array([
        np.sin(theta) * np.cos(phi), np.cos(theta),
        np.sin(theta) * np.sin(phi)])
    fwd = -eye / np.linalg.norm(eye)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, up)
    right /= max(np.linalg.norm(right), 1e-9)
    up2 = np.cross(right, fwd)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = right, -up2, fwd, eye
    return pose


def _time_frames(step, state, n: int, device) -> tuple:
    """Run ``n`` chained frames ``state -> step(state)`` and return (the
    last state and output, seconds a frame): between CUDA events on the
    card, on the host clock on the CPU."""
    if device.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            state, out = step(state)
        b.record()
        torch.cuda.synchronize(device)
        return state, out, a.elapsed_time(b) / 1e3 / n
    t0 = time.perf_counter()
    for _ in range(n):
        state, out = step(state)
    return state, out, (time.perf_counter() - t0) / n


def run(pth: str, ply: str, out_path: str, *, bound: float = 1.0,
        n_poses: int = 8, H: int = 256, W: int = 256,
        distill_steps: int = 4000, student_width: int = 128,
        sim_dx: float = 0.05, sim_dt: float = 1e-2, sim_iters: int = 10,
        sim_stiff: float = 1e5, kres: int = 7, bench_frames: int = 20,
        render_samples: int = 64, cache_dir: Optional[str] = None,
        n_grid_updates: int = 6, teacher_spec=None, device=None) -> dict:
    """The chain on ``device`` (default the card); the report, also
    written to ``out_path``. ``teacher_spec``: the hash grid the ``.pth``
    was trained with (default: the reference's, ``network.make_spec``)."""
    from pienerf_tpu_torch.device import resolve_device
    from pienerf_tpu_torch.io import checkpoint as ckpt_io
    from pienerf_tpu_torch.io.ply import read_physics_ply
    from pienerf_tpu_torch.kernels import field as field_kernel
    from pienerf_tpu_torch.models import network
    from pienerf_tpu_torch.ops import beam_bend
    from pienerf_tpu_torch.render import interactive, pipeline
    from pienerf_tpu_torch.sim import solver as sim
    from pienerf_tpu_torch.train import distill
    from pienerf_tpu_torch.weights import field_from_numpy

    dev = resolve_device(device)
    report: dict = {"pth": pth, "ply": ply, "bound": bound}

    # 1 -- import the reference checkpoint (bit-exact hashgrid teacher)
    t0 = time.time()
    t_params, extra = ckpt_io.load_torch_ngp(pth)
    t_spec = teacher_spec or network.make_spec(bound=bound,
                                               backbone="hashgrid")
    teacher = field_from_numpy(t_params, t_spec, dev)
    report["import"] = {"ok": True, "seconds": time.time() - t0,
                        "extra_keys": sorted(extra.keys())}

    poses = [orbit_pose(np.pi / 3 + 0.2 * (i % 3), 2 * np.pi * i / n_poses,
                        2.5 * bound) for i in range(n_poses)]
    focal = 0.9 * H
    intr = (focal, focal, W / 2.0, H / 2.0)

    # 2+3 -- distill, then field- and image-space agreement (the latter
    # renders the teacher offline, bit-exact, for its reference)
    t0 = time.time()
    student, s_spec, loss = distill.distill(
        teacher, t_spec, steps=distill_steps, student_width=student_width,
        log_fn=lambda m: print(m, flush=True))
    report["distill"] = {"steps": distill_steps, "width": student_width,
                         "final_loss": float(loss),
                         "seconds": time.time() - t0}
    report["field_agreement"] = distill.field_agreement(
        teacher, t_spec, student, s_spec)

    t0 = time.time()
    agree = distill.image_agreement(
        teacher, t_spec, student, s_spec, poses, intr, H, W,
        student_samples=render_samples, n_grid_updates=n_grid_updates)
    agree.pop("images")
    agree["seconds"] = time.time() - t0
    report["image_agreement"] = agree
    del teacher

    # 4 -- the coupled interactive frame on the annotated PLY
    d = read_physics_ply(ply)
    init_kw = dict(dt=sim_dt, iters=sim_iters,
                   bbox=np.array([2.0 * bound] * 3), kres=kres, dx=sim_dx,
                   stiff=sim_stiff, base=np.array([-bound] * 3), device=dev)
    t0 = time.time()
    if cache_dir:
        consts, state, aux = sim.sim_init_cached(
            d["pos"], d["mass"], d["mu"], d["lam"], d["pin"],
            cache_dir=cache_dir, **init_kw)
    else:
        consts, state, aux = sim.sim_init(
            d["pos"], d["mass"], d["mu"], d["lam"], d["pin"], **init_kw)
    report["sim_init"] = {"n_ip": int(aux["n_ip"]), "n_k": int(aux["n_k"]),
                          "seconds": time.time() - t0}

    pw = field_kernel.pack_weights(student, s_spec, dev)
    bst = beam_bend.BeamBendSettings(num_seek_ip=3, max_iter_num=1,
                                     ip_dx=1.05 * sim_dx)
    ist = interactive.InteractiveSettings(
        spec=s_spec, bend=bst, tile=16, samples=render_samples,
        min_near=0.05, bound=bound)
    Hb = (H // 16) * 16
    Wb = (W // 16) * 16
    pose_t = torch.as_tensor(poses[0], device=dev)
    fvec = torch.zeros(3, device=dev)

    def step(st):
        return pipeline.interactive_frame_step(
            ist, consts, st, pw, pose_t, intr, Hb, Wb, 1.0, 0, fvec)

    with torch.no_grad():
        state, out = step(state)                # warm-up
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        state, out, dt_f = _time_frames(step, state, bench_frames, dev)
    if not bool(torch.isfinite(out["tiles_image"]).all()):
        raise RuntimeError("the coupled frame is not finite")
    report["interactive"] = {"fps": 1.0 / dt_f, "ms_per_frame": dt_f * 1e3,
                             "H": Hb, "W": Wb, "frames": bench_frames,
                             "samples": render_samples,
                             "device": (torch.cuda.get_device_name(dev)
                                        if dev.type == "cuda" else "cpu")}

    report["verdict"] = {
        "image_psnr_ge_30": agree["psnr_mean"] >= 30.0,
        "interactive_fps_ge_30": report["interactive"]["fps"] >= 30.0,
    }
    with open(out_path, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"summary": {
        "image_psnr": agree["psnr_mean"], "ssim": agree["ssim_mean"],
        "fps": report["interactive"]["fps"]}}), flush=True)
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pth", required=True)
    ap.add_argument("--ply", required=True)
    ap.add_argument("--out", default="asset_report.json")
    ap.add_argument("--bound", type=float, default=1.0)
    ap.add_argument("--H", type=int, default=256)
    ap.add_argument("--W", type=int, default=256)
    ap.add_argument("--n_poses", type=int, default=8)
    ap.add_argument("--distill_steps", type=int, default=4000)
    ap.add_argument("--student_width", type=int, default=128)
    ap.add_argument("--sim_dx", type=float, default=0.05)
    ap.add_argument("--sim_dt", type=float, default=1e-2)
    ap.add_argument("--sim_iters", type=int, default=10)
    ap.add_argument("--sim_stiff", type=float, default=1e5)
    ap.add_argument("--kres", type=int, default=7)
    ap.add_argument("--bench_frames", type=int, default=20)
    ap.add_argument("--render_samples", type=int, default=64)
    ap.add_argument("--cache_dir", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    return run(a.pth, a.ply, a.out, bound=a.bound, n_poses=a.n_poses, H=a.H,
               W=a.W, distill_steps=a.distill_steps,
               student_width=a.student_width, sim_dx=a.sim_dx,
               sim_dt=a.sim_dt, sim_iters=a.sim_iters,
               sim_stiff=a.sim_stiff, kres=a.kres,
               bench_frames=a.bench_frames,
               render_samples=a.render_samples, cache_dir=a.cache_dir,
               device=a.device)


if __name__ == "__main__":
    main()
