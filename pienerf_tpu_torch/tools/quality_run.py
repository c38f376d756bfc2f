"""Full-budget quality training run (port of tools/quality_run.py).

Trains the mlp backbone on the analytic synthetic scene at 800x800 under
the protocol of the JAX package's ``runs/quality_mlp_800/summary.json``
(bf16, 40 + 8 views, 4,096 rays a step, 256 samples, lr 1e-2 decayed to
1e-7 over 30,000 steps) and records the held-out PSNR curve every
``--eval_every`` steps.

The ground-truth views are a dense 400-step uniform quadrature of the
analytic field (``data/synthetic.render_gt``), computed on the device;
before any full-size view is made, the device's quadrature is held to the
numpy oracle at 64x64. The ground truth stays independent of the renderer
under test (the trainer renders hierarchically with importance sampling).

Outputs under ``--workspace`` (default ``runs/torch_quality_mlp_800``), in
the JAX tool's schema:
  dataset_<H>x<W>_<n>v_s<seed>.npz   cached ground-truth views
  curve.json                         [{step, loss, psnr, wall_s}, ...]
  summary.json                       final metrics and configuration
  checkpoints/, validation/          the trainer's

A run resumes from the workspace's newest checkpoint and its curve.json:

    python -m pienerf_tpu_torch.tools.quality_run --iters 30000

Runs on the card; ``--device cpu`` is the only way onto the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from pienerf_tpu_torch.config import PieNeRFConfig
from pienerf_tpu_torch.data import synthetic
from pienerf_tpu_torch.device import resolve_device
from pienerf_tpu_torch.train.metrics import psnr as psnr_fn


def validate_device_gt(device, scene: str = "sphere") -> float:
    """The device's quadrature against the numpy oracle at 64x64: its
    PSNR, which must clear 55 dB (sphere) or 52 dB (the hard scene), the
    JAX tool's gates."""
    intr = (0.9 * 64, 0.9 * 64, 32.0, 32.0)
    pose = synthetic.orbit_poses(1, seed=3)[0]
    ref = synthetic.render_gt(pose, intr, 64, 64, scene=scene)
    dev = synthetic.render_gt(pose, intr, 64, 64, scene=scene,
                              device=device)
    p = psnr_fn(dev, ref)
    floor = 55.0 if scene == "sphere" else 52.0
    if not p > floor:
        raise RuntimeError(f"device GT diverges from the numpy oracle: "
                           f"{p:.2f} dB (gate {floor} dB)")
    return p


def make_dataset_cached(workspace: str, n_views: int, H: int, W: int,
                        seed: int, device, scene: str = "sphere"
                        ) -> synthetic.SyntheticDataset:
    tag = "" if scene == "sphere" else f"_{scene}"
    path = os.path.join(workspace,
                        f"dataset{tag}_{H}x{W}_{n_views}v_s{seed}.npz")
    focal = 0.9 * H
    intr = (focal, focal, W / 2.0, H / 2.0)
    if os.path.exists(path):
        z = np.load(path)
        return synthetic.SyntheticDataset(
            poses=z["poses"], images=z["images"], intrinsics=intr, H=H, W=W)
    poses = synthetic.orbit_poses(n_views, seed=seed)
    t0 = time.time()
    images = np.stack([synthetic.render_gt(p, intr, H, W, scene=scene,
                                           device=device) for p in poses])
    if not np.isfinite(images).all():
        raise RuntimeError("GT render produced non-finite pixels")
    print(f"[gt] {n_views} views {H}x{W} in {time.time() - t0:.1f}s",
          flush=True)
    np.savez_compressed(path, poses=poses.astype(np.float32), images=images)
    return synthetic.SyntheticDataset(
        poses=poses.astype(np.float32), images=images, intrinsics=intr,
        H=H, W=W)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workspace", default="runs/torch_quality_mlp_800")
    ap.add_argument("--iters", type=int, default=30000)
    ap.add_argument("--eval_every", type=int, default=2000)
    ap.add_argument("--H", type=int, default=800)
    ap.add_argument("--W", type=int, default=800)
    ap.add_argument("--n_train", type=int, default=40)
    ap.add_argument("--n_test", type=int, default=8)
    ap.add_argument("--eval_views", type=int, default=2,
                    help="held-out views scored at each interim eval")
    ap.add_argument("--num_rays", type=int, default=4096)
    ap.add_argument("--train_max_samples", type=int, default=256)
    ap.add_argument("--backbone", default="mlp")
    ap.add_argument("--compute_dtype", default="bfloat16")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scene", default="sphere",
                    help="analytic scene (sphere | hard)")
    ap.add_argument("--lr_decay_rate", type=float, default=1e-5,
                    help="final-lr fraction")
    ap.add_argument("--precision_tail_start", type=int, default=None,
                    help="global step from which training switches to "
                    "float32")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    os.makedirs(args.workspace, exist_ok=True)
    p = validate_device_gt(dev, args.scene)
    print(f"[gt] device-vs-numpy oracle: {p:.1f} dB", flush=True)

    train_ds = make_dataset_cached(args.workspace, args.n_train, args.H,
                                   args.W, seed=args.seed, device=dev,
                                   scene=args.scene)
    test_ds = make_dataset_cached(args.workspace, args.n_test, args.H,
                                  args.W, seed=99, device=dev,
                                  scene=args.scene)

    cfg = PieNeRFConfig(
        bound=1.0, dt_gamma=0.0, iters=args.iters, num_rays=args.num_rays,
        min_near=0.05, workspace=args.workspace, seed=args.seed,
        train_max_samples=args.train_max_samples, backbone=args.backbone,
        compute_dtype=args.compute_dtype, lr_decay_rate=args.lr_decay_rate,
        precision_tail_start=args.precision_tail_start,
    ).finalize()
    cfg.backbone = args.backbone
    cfg.compute_dtype = args.compute_dtype

    from pienerf_tpu_torch.train.trainer import Trainer

    trainer = Trainer("ngp", cfg, use_checkpoint="latest", seed=args.seed,
                      device=dev)
    trainer.mark_untrained_grid(train_ds.poses, train_ds.intrinsics)

    curve_path = os.path.join(args.workspace, "curve.json")
    curve = []
    if os.path.exists(curve_path):
        with open(curve_path) as f:
            curve = json.load(f)
    t0 = time.time() - (curve[-1]["wall_s"] if curve else 0.0)

    while trainer.global_step < args.iters:
        n = min(args.eval_every, args.iters - trainer.global_step)
        loss = trainer.train_iterations(train_ds, n)
        psnr = trainer.evaluate(test_ds, n_views=args.eval_views,
                                save_images=False)
        if not np.isfinite(psnr):
            raise RuntimeError(
                f"non-finite eval at step {trainer.global_step}; aborting "
                "instead of burning the remaining budget")
        entry = {"step": trainer.global_step, "loss": loss,
                 "psnr": float(psnr), "wall_s": time.time() - t0}
        curve.append(entry)
        with open(curve_path, "w") as f:
            json.dump(curve, f, indent=1)
        print(f"[curve] {entry}", flush=True)
        trainer.save_checkpoint()

    # final: every test view, with PNG and depth dumps
    final_psnr = trainer.evaluate(test_ds, save_images=True)
    summary = {
        "final_psnr": float(final_psnr),
        "iters": trainer.global_step,
        "wall_s": time.time() - t0,
        "H": args.H, "W": args.W,
        "n_train": args.n_train, "n_test": args.n_test,
        "backbone": args.backbone, "compute_dtype": args.compute_dtype,
        "num_rays": args.num_rays,
        "scene": args.scene,
        "lr_decay_rate": args.lr_decay_rate,
        "precision_tail_start": args.precision_tail_start,
        "train_max_samples": args.train_max_samples,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "curve": curve,
    }
    with open(os.path.join(args.workspace, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(f"[summary] final held-out PSNR={final_psnr:.2f} dB after "
          f"{trainer.global_step} iters ({summary['wall_s'] / 60:.1f} min)",
          flush=True)
    return summary


if __name__ == "__main__":
    main()
