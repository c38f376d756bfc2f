"""Headless interactive physics demo on the card (port of main_gui.py).

Loads the newest trained field ``{workspace}/checkpoints/ngp_ep*.npz``
(``ema_params``; the mlp architecture is read from the weight shapes) and
the annotated physics PLY ``assets/{exp_name}.ply``, builds the simulator,
and runs the coupled sim + render loop, writing PNG frames:

    python -m pienerf_tpu_torch.main_gui --workspace runs/quality_mlp_800 \\
        --exp_name cube --backbone mlp --sim_dx 0.2 --bound 0.5 \\
        --W 400 --H 400 --radius 2.5 --kres 4 --frames 5 --out_dir gui_frames

At the default ``--max_iter_num`` (100, the reference's full Newton
"quadratic ray bending") each frame runs the sim step and then
``interactive.render_frame``, whose field goes through the field kernel;
``--max_iter_num 1`` takes the fused tile kernel instead
(``pipeline.interactive_frame_step``). The 64-wide net and the 128-wide
distilled student both run, at the width of the checkpoint's weights.
``--cut --cut_bounds xmin xmax ymin ymax zmin zmax`` bends only inside the
box and renders the rest of the scene (``--bound``) as a static background.
Runs on the card; ``--device cpu`` is the only way onto the CPU.
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np


def _load_field(cfg, device):
    """(spec, packed weights) from the newest native checkpoint, or a
    seeded random field when the workspace has none."""
    import torch

    from pienerf_tpu_torch.io.checkpoint import load_native
    from pienerf_tpu_torch.kernels import field as field_kernel
    from pienerf_tpu_torch.models import network
    from pienerf_tpu_torch.weights import field_from_numpy

    if cfg.backbone != "mlp":
        raise NotImplementedError(
            f"backbone {cfg.backbone!r}: only the mlp backbone is ported "
            f"(hashgrid: ROADMAP.md queue 1 item 10); pass --backbone mlp")
    spec = network.make_spec(bound=cfg.bound,
                             compute_dtype=cfg.compute_dtype)
    ckdir = os.path.join(cfg.workspace, "checkpoints")
    npz = sorted(glob.glob(os.path.join(ckdir, "ngp_ep*.npz")))
    if cfg.ckpt_path or (not npz and glob.glob(os.path.join(ckdir, "*.pth"))):
        raise NotImplementedError(
            "only native ngp_ep*.npz checkpoints load; the .pth import is "
            "ROADMAP.md queue 1 item 10")
    if npz:
        tree, _ = load_native(npz[-1])
        params = tree.get("ema_params", tree.get("params", tree))
        sn, cn = params["sigma_net"], params["color_net"]
        spec = spec._replace(
            n_freqs=(sn[0].shape[0] // 3 - 1) // 2, hidden_dim=sn[0].shape[1],
            hidden_dim_color=cn[0].shape[1], num_layers=len(sn),
            num_layers_color=len(cn))
        field = field_from_numpy(params, spec, device)
        print(f"[ckpt] loaded {npz[-1]}")
    else:
        gen = torch.Generator().manual_seed(cfg.seed)
        field = network.FieldMLP(spec, generator=gen, device=device)
        print("[ckpt] no checkpoint: random field from --seed")
    return spec, field_kernel.pack_weights(field, spec, device)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--frames", type=int, default=60,
                        help="headless mode: frames to write")
    parser.add_argument("--out_dir", type=str, default="gui_frames")
    parser.add_argument("--force_ip", type=int, default=-1,
                        help="apply a constant force at this IP id")
    parser.add_argument("--force", nargs=3, type=float,
                        default=[0.0, 0.0, 0.0])
    parser.add_argument("--gravity", nargs=3, type=float,
                        default=[0.0, -9.8, 0.0])
    parser.add_argument("--kres", type=int, default=7,
                        help="kernel-node grid resolution (stability knob)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    from pienerf_tpu_torch.config import get_shared_opts
    cfg = get_shared_opts(parser, argv)
    ns, _ = parser.parse_known_args(argv)

    import torch

    from pienerf_tpu_torch.device import resolve_device
    from pienerf_tpu_torch.io.framesink import FrameSink
    from pienerf_tpu_torch.io.ply import read_physics_ply
    from pienerf_tpu_torch.ops import beam_bend
    from pienerf_tpu_torch.render import interactive, pipeline
    from pienerf_tpu_torch.sim import solver as sim
    from pienerf_tpu_torch.utils.camera import OrbitCamera

    device = resolve_device(ns.device)
    if cfg.sim_bf16_b:
        raise NotImplementedError("--sim_bf16_b is not ported yet "
                                  "(ROADMAP.md queue 1 item 3)")

    spec, pw = _load_field(cfg, device)

    ply_path = os.path.join("assets", f"{cfg.exp_name}.ply")
    if not os.path.exists(ply_path):
        raise SystemExit(f"annotated physics PLY not found: {ply_path}")
    d = read_physics_ply(ply_path)
    consts, state, aux = sim.sim_init(
        d["pos"], d["mass"], d["mu"], d["lam"], d["pin"],
        dt=cfg.sim_dt / cfg.sim_substeps, iters=cfg.sim_iters,
        bbox=np.array([2.0 * cfg.bound] * 3), kres=ns.kres, dx=cfg.sim_dx,
        gravity=tuple(ns.gravity), stiff=cfg.sim_stiff,
        base=np.array([-cfg.bound] * 3), device=device)
    print(f"[sim] {aux['n_ip']} IPs, {aux['n_k']} kernel nodes")

    bst = beam_bend.BeamBendSettings(
        num_seek_ip=cfg.num_seek_IP, max_iter_num=cfg.max_iter_num,
        ip_dx=1.05 * cfg.sim_dx)
    ist = interactive.InteractiveSettings(
        spec=spec, bend=bst, tile=16, samples=cfg.render_samples,
        min_near=cfg.min_near, T_thresh=cfg.T_thresh, cut=cfg.cut,
        bound=cfg.bound, tighten_sampling=cfg.tighten_sampling)
    cut_bounds = (torch.tensor(cfg.cut_bounds, dtype=torch.float32,
                               device=device) if cfg.cut else None)

    H = W = 800 if cfg.dataset_type == "synthetic" else min(cfg.H, 800)
    H = (H // 16) * 16
    W = (W // 16) * 16
    cam = OrbitCamera(W, H, r=cfg.radius, fovy=cfg.fovy)
    pose = torch.as_tensor(cam.pose, device=device)
    fvec = torch.tensor(ns.force, dtype=torch.float32, device=device)
    fused = cfg.max_iter_num == 1   # fast-Newton pack -> fused tile kernel

    os.makedirs(ns.out_dir, exist_ok=True)
    with FrameSink() as sink:
        t_prev = time.perf_counter()
        for i in range(ns.frames):
            if fused:
                state, out = pipeline.interactive_frame_step(
                    ist, consts, state, pw, pose, cam.intrinsics, H, W, 1.0,
                    ns.force_ip, fvec, cut_bounds, substeps=cfg.sim_substeps)
                if (i % 10 == 0 or cfg.timing_on) and not bool(
                        torch.isfinite(out["tiles_ws"]).all()):
                    raise SystemExit(
                        f"simulation diverged at frame {i}; tune --sim_dt / "
                        "--kres / mass / lam,mu (the local-global scheme is "
                        "conditionally stable, matching the CUDA reference)")
            else:
                state = (sim.update_force(consts, state, ns.force_ip, fvec)
                         if ns.force_ip >= 0 else sim.clear_force(state))
                state = sim.sim_step(consts, state)
                p_def, F, dF = sim.get_ip_info(consts, state)
                if not bool(torch.isfinite(p_def).all()):
                    raise SystemExit(
                        f"simulation diverged at frame {i} (NaN IP "
                        "positions); tune --sim_dt / --kres / mass / lam,mu "
                        "(the local-global scheme is conditionally stable, "
                        "matching the CUDA reference)")
                pack = beam_bend.pack_for(bst, p_def, consts.ip_pos.float(),
                                          F, dF)
                out = interactive.render_frame(
                    ist, pw, pack, p_def, pose, cam.intrinsics, H, W, 1.0,
                    cut_bounds)
            img = interactive.tiles_to_image(out["tiles_image"], H, W,
                                             ist.tile)
            sink.push(os.path.join(ns.out_dir, f"frame_{i:04d}.png"), img)
            if cfg.timing_on:
                now = time.perf_counter()
                print(f"timing: frame {i}: {(now - t_prev) * 1000:.1f} ms "
                      f"(active tiles: {int(out['n_active'])})")
                t_prev = now
            if i % 10 == 0:
                print(f"frame {i}/{ns.frames}")
    print(f"wrote {ns.frames} frames to {ns.out_dir}/")


if __name__ == "__main__":
    main()
