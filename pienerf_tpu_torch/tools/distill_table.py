"""Distillation fidelity table: student width x {image PSNR / SSIM, FPS}
(port of tools/distill_table.py).

Teacher: the default hash-grid field fitted to the analytic sphere scene by
direct field-space regression (``fit_hashgrid_teacher``). Students: the
64-wide and the 128-wide Fourier-MLP students distilled with
``train/distill.py``. Measured per width:

  - field agreement (sigma log-MSE, weighted rgb MSE, occupancy IoU);
  - image agreement: the teacher through the occupancy renderer against
    the student through the tile kernel's static mode, same poses
    (``distill.image_agreement``);
  - the fused deformed frame's rate at 800x800 (K 128, tightened spans, 3
    seeks, against a rest-pose IP cloud of the object: the interactive
    render cost; the sim's cost does not depend on the width).

The defaults are the JAX package's protocol (teacher 2,000 steps, distill
4,000, 256x256, 8 poses). Writes the table as JSON (default
``runs/torch_distill_table.json``), caches the fitted teacher beside it,
and prints the markdown rows:

    python -m pienerf_tpu_torch.tools.distill_table

Runs on the card; ``--device cpu`` is the only way onto the CPU.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from pienerf_tpu_torch.data import synthetic
from pienerf_tpu_torch.device import resolve_device
from pienerf_tpu_torch.models import network
from pienerf_tpu_torch.train import distill
from pienerf_tpu_torch.train.optim import Adam, apply_updates


def make_fit_step(optimizer: Adam):
    """``step(field, opt_state, x, d, sig_gt, rgb_gt) -> (opt_state,
    loss)``: one field-space regression update, in place: log1p-space
    sigma error plus 4x the alpha-weighted rgb error
    (tools/distill_table.py:56-67)."""

    def step(field, opt_state, x, d, sig_gt, rgb_gt):
        alpha = 1.0 - torch.exp(-torch.clamp(sig_gt, 0.0, 1e4) * 0.01)
        sig, rgb = field(x, d)
        l_sig = ((torch.log1p(sig) - torch.log1p(sig_gt)) ** 2).mean()
        l_rgb = (alpha[:, None] * (rgb - rgb_gt) ** 2).mean()
        loss = l_sig + 4.0 * l_rgb
        leaves = field.leaves()
        grads = torch.autograd.grad(loss, leaves)
        updates, opt_state = optimizer.update(list(grads), opt_state)
        apply_updates(leaves, updates)
        return opt_state, loss.detach()

    return step


@functools.lru_cache(maxsize=4)
def _occ_pts(scene: str) -> np.ndarray:
    return synthetic.scene_points(scene, dx=0.04).astype(np.float32)


def fit_batch(gen: torch.Generator, batch: int, bound: float, scene: str,
              device):
    """One batch of the fit: half uniform in the box, half at the sphere
    shell (radius 0.5 + 0.1 N(0, 1)) or, for another scene, 0.05 from its
    occupied lattice; direction +z; the analytic (sigma, rgb) there."""
    n_u = batch // 2
    n_s = batch - n_u
    xu = (torch.rand((n_u, 3), generator=gen, device=device) * 2.0
          - 1.0) * bound
    sh = torch.randn((n_s, 3), generator=gen, device=device)
    sh = sh / torch.linalg.norm(sh, dim=1, keepdim=True)
    if scene == "sphere":
        rad = 0.5 + 0.1 * torch.randn((n_s, 1), generator=gen,
                                      device=device)
        xs = sh * rad
    else:
        occ = torch.as_tensor(_occ_pts(scene), device=device)
        pick = torch.randint(0, occ.shape[0], (n_s,), generator=gen,
                             device=device)
        xs = occ[pick] + 0.05 * sh
    x = torch.cat([xu, xs], dim=0)
    d = torch.zeros((batch, 3), device=device)
    d[:, 2] = 1.0
    sig_gt, rgb_gt = synthetic.scene_field(scene, x, xp=torch)
    return x, d, sig_gt, rgb_gt


def fit_hashgrid_teacher(steps: int = 2000, batch: int = 8192,
                         lr: float = 1e-2, bound: float = 1.0, seed: int = 0,
                         scene: str = "sphere", device=None, log_fn=print):
    """Field-space fit of the default hash grid to the analytic scene
    (sigma and a direction-independent albedo) under optax's
    adam(exponential_decay(lr, steps, 0.1), 0.9, 0.99, eps 1e-15): (field,
    spec), the field frozen."""
    dev = resolve_device(device)
    spec = network.make_spec(bound=bound, backbone="hashgrid")
    field = network.FieldMLP(spec, generator=torch.Generator().manual_seed(
        seed), device=dev, trainable=True)
    opt = Adam(lr, steps, 0.1, b1=0.9, b2=0.99, eps=1e-15,
               max_consecutive_errors=None)
    opt_state = opt.init(field.leaves())
    step = make_fit_step(opt)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    t0 = time.time()
    for i in range(steps):
        x, d, sig_gt, rgb_gt = fit_batch(gen, batch, bound, scene, dev)
        opt_state, loss = step(field, opt_state, x, d, sig_gt, rgb_gt)
        if (i + 1) % 500 == 0:
            log_fn(f"[teacher] {i + 1}/{steps} loss={float(loss):.5f} "
                   f"({time.time() - t0:.0f}s)")
    field.set_trainable(False)
    return field, spec


def fused_frame_fps(student: network.FieldMLP, s_spec: network.NetworkSpec,
                    H: int = 800, W: int = 800, samples: int = 128,
                    reps: int = 8, scene: str = "sphere") -> float:
    """The deformed fused frame's rate against an identity-deformation IP
    cloud of the scene (3-seek bend, K 128, tightened spans: the bench
    render protocol without the sim), timed over ``reps`` frames that end
    in a device sync."""
    from pienerf_tpu_torch.kernels import field as field_kernel
    from pienerf_tpu_torch.ops import beam_bend
    from pienerf_tpu_torch.render import interactive

    dev = student.sigma_net[0].device
    dx = 0.05
    p = torch.as_tensor(synthetic.scene_points(scene, dx=dx).astype(
        np.float32), device=dev)
    n = p.shape[0]
    F = torch.eye(3, device=dev).expand(n, 3, 3).contiguous()
    dF = torch.zeros((n, 3, 3, 3), device=dev)
    pack = beam_bend.pack_ip_data_fast(p, p, F, dF)
    bst = beam_bend.BeamBendSettings(num_seek_ip=3, max_iter_num=1,
                                     ip_dx=1.05 * dx, ips_per_tile=256)
    ist = interactive.InteractiveSettings(
        spec=s_spec, bend=bst, tile=16, samples=samples, min_near=0.05,
        tighten_sampling=True)
    pw = field_kernel.pack_weights(student, s_spec, dev)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (0.0, 0.0, -2.5)
    pose_t = torch.as_tensor(pose, device=dev)
    intr = (0.9 * H, 0.9 * H, W / 2.0, H / 2.0)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with torch.no_grad():
        interactive.render_frame_fused(ist, pw, pack, p, pose_t, intr, H, W,
                                       1.0, t_jitter=0.5)     # warm-up
        sync()
        t0 = time.perf_counter()
        for r in range(reps):
            interactive.render_frame_fused(
                ist, pw, pack, p, pose_t, intr, H, W, 1.0,
                t_jitter=float(0.3 + 0.4 * (r % 2)))
        sync()
    return reps / (time.perf_counter() - t0)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="runs/torch_distill_table.json")
    ap.add_argument("--teacher_steps", type=int, default=2000)
    ap.add_argument("--distill_steps", type=int, default=4000)
    ap.add_argument("--H", type=int, default=256)
    ap.add_argument("--n_poses", type=int, default=8)
    ap.add_argument("--fps_reps", type=int, default=8)
    ap.add_argument("--scene", default="sphere")
    ap.add_argument("--widths", type=int, nargs="+", default=[64, 128],
                    choices=(64, 128))
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if (args.scene != "sphere"
            and args.out == "runs/torch_distill_table.json"):
        args.out = f"runs/torch_distill_table_{args.scene}.json"

    # the fitted teacher is cached beside the table: a rerun does not pay
    # for the fit again
    from pienerf_tpu_torch.io import checkpoint as ckpt_io
    from pienerf_tpu_torch.weights import field_from_numpy, field_to_numpy

    out_dir = os.path.dirname(args.out) or "."
    os.makedirs(out_dir, exist_ok=True)
    tag = "" if args.scene == "sphere" else f"_{args.scene}"
    cache = os.path.join(
        out_dir, f"torch_distill_teacher{tag}_s{args.teacher_steps}.npz")
    t_spec = network.make_spec(bound=1.0, backbone="hashgrid")
    t0 = time.time()
    if os.path.exists(cache):
        print(f"[teacher] cached: {cache}", flush=True)
        teacher = field_from_numpy(ckpt_io.load_native(cache)[0], t_spec,
                                   dev)
        fit_s: Optional[float] = None
    else:
        teacher, t_spec = fit_hashgrid_teacher(
            steps=args.teacher_steps, scene=args.scene, device=dev,
            log_fn=lambda m: print(m, flush=True))
        fit_s = time.time() - t0
        ckpt_io.save_native(cache, field_to_numpy(teacher))

    H = W = args.H
    focal = 0.9 * H
    intr = (focal, focal, W / 2.0, H / 2.0)
    poses = list(synthetic.orbit_poses(args.n_poses, seed=123))

    rows = []
    for width in args.widths:
        t0 = time.time()
        student, s_spec, loss = distill.distill(
            teacher, t_spec, steps=args.distill_steps, student_width=width,
            log_fn=lambda m: print(m, flush=True))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.time() - t0
        fa = distill.field_agreement(teacher, t_spec, student, s_spec)
        ia = distill.image_agreement(teacher, t_spec, student, s_spec,
                                     poses, intr, H, W)
        fps = fused_frame_fps(student, s_spec, reps=args.fps_reps,
                              scene=args.scene)
        rows.append({
            "width": width, "distill_seconds": wall,
            "final_loss": float(loss), "field": fa,
            "image_psnr": ia["psnr_mean"], "image_ssim": ia["ssim_mean"],
            "image_psnr_per_view": ia["psnr_per_view"],
            "fps_800": fps,
        })
        print(f"[row] width={width} image_psnr={ia['psnr_mean']:.2f} "
              f"ssim={ia['ssim_mean']:.4f} fps={fps:.1f}", flush=True)

    table = {"scene": args.scene, "teacher_steps": args.teacher_steps,
             "teacher_fit_seconds": fit_s,
             "distill_steps": args.distill_steps, "H": H,
             "device": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
             "rows": rows}
    with open(args.out, "w") as f:
        json.dump(table, f, indent=1)
    print("| student width | image PSNR vs teacher | SSIM | FPS @800x800 |")
    print("|---|---|---|---|")
    for r in rows:
        print(f"| {r['width']} | {r['image_psnr']:.2f} dB | "
              f"{r['image_ssim']:.4f} | {r['fps_800']:.1f} |")
    return table


if __name__ == "__main__":
    main()
