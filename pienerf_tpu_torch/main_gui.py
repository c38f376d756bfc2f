"""Headless interactive physics demo on the card (port of main_gui.py).

Loads a trained field as the reference's trainer picks it (``--ckpt latest``,
the default: the newest ``{workspace}/checkpoints/ngp_ep*.npz``; ``--ckpt
scratch``: a random field from ``--seed``; ``--ckpt <file>``: that
``.npz``; ``--ckpt_path <file>`` wins over any ``--ckpt`` but ``latest``,
which does not read it; its ``ema_params`` render, and a checkpoint whose
``params`` are not finite is refused) and
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
``--backbone hashgrid`` serves torch-ngp's hash-grid field (the field
upstream trains) on the fused frame alone: the port's native checkpoint
(``main_train --backbone hashgrid``), a reference ``.pth``
(``io.checkpoint.load_torch_ngp``) or a seeded random field; it needs
``--max_iter_num 1``, f32 and no background net (``--bg_radius``).
``--cut --cut_bounds xmin xmax ymin ymax zmin zmax`` bends only inside the
box and renders the rest of the scene (``--bound``) as a static background.
Runs on the card; ``--device cpu`` is the only way onto the CPU.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time

import numpy as np


def _params_finite(tree) -> bool:
    """True iff every float leaf of a params tree (nested dicts and lists of
    arrays) is finite everywhere (pienerf_tpu/train/trainer.py:42-48)."""
    if isinstance(tree, dict):
        return all(_params_finite(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(_params_finite(v) for v in tree)
    a = np.asarray(tree)
    return not np.issubdtype(a.dtype, np.floating) or bool(
        np.isfinite(a).all())


def _checkpoint_path(cfg):
    """The checkpoint the reference's trainer would load, or None for a
    fresh field (trainer.py:371-374, :920-931): ``--ckpt latest`` the
    newest ``ngp_ep*.npz`` of the workspace, else its newest
    ``ngp_ep*.pth``, and ``--ckpt_path`` is not read; otherwise
    ``--ckpt_path`` if given, else ``--ckpt <file>``; ``--ckpt scratch``
    with no ``--ckpt_path`` none."""
    if cfg.ckpt == "latest":
        ckdir = os.path.join(cfg.workspace, "checkpoints")
        found = (sorted(glob.glob(os.path.join(ckdir, "ngp_ep*.npz")))
                 or sorted(glob.glob(os.path.join(ckdir, "ngp_ep*.pth"))))
        return found[-1] if found else None
    if cfg.ckpt_path:
        return cfg.ckpt_path
    return None if cfg.ckpt in ("scratch", None) else cfg.ckpt


def _load_field(cfg, device):
    """(spec, packed weights) of the checkpoint ``_checkpoint_path`` names
    (its ``ema_params``, or a reference ``.pth``'s weights for the hashgrid
    backbone; the nets' architecture read from the weight shapes), or of a
    seeded random field when there is none, the file is missing, or its
    ``params`` hold a non-finite value (refused with a log line, as
    trainer.py:932-948 refuses it)."""
    import torch

    from pienerf_tpu_torch.io.checkpoint import load_native, load_torch_ngp
    from pienerf_tpu_torch.kernels import field as field_kernel
    from pienerf_tpu_torch.models import network
    from pienerf_tpu_torch.weights import field_from_numpy

    if cfg.backbone not in ("mlp", "hashgrid"):
        raise NotImplementedError(
            f"backbone {cfg.backbone!r}: the interactive frames serve the "
            f"mlp and hashgrid backbones")
    grid = cfg.backbone == "hashgrid"
    spec = (network.make_spec(bound=cfg.bound,
                              compute_dtype=cfg.compute_dtype,
                              backbone="hashgrid", bg_radius=cfg.bg_radius)
            if grid else network.make_spec(bound=cfg.bound,
                                           compute_dtype=cfg.compute_dtype))
    path = _checkpoint_path(cfg)
    ema = None
    if path is not None and os.path.exists(path):
        if path.endswith(".pth"):
            if not grid:
                raise NotImplementedError(
                    f"{path}: a reference .pth holds a hashgrid field, "
                    "which io.checkpoint.load_torch_ngp imports: pass "
                    "--backbone hashgrid")
            params, _ = load_torch_ngp(path)
            tree = {"params": params}
        else:
            tree, _ = load_native(path)
        params = tree.get("params", tree)
        if _params_finite(params):
            ema = tree.get("ema_params", params)
        else:
            print(f"[ckpt] REFUSING to load {path}: params contain "
                  "non-finite values (corrupt checkpoint)")
    if ema is not None:
        sn, cn = ema["sigma_net"], ema["color_net"]
        spec = spec._replace(
            hidden_dim=sn[0].shape[1], hidden_dim_color=cn[0].shape[1],
            num_layers=len(sn), num_layers_color=len(cn))
        if not grid:
            spec = spec._replace(n_freqs=(sn[0].shape[0] // 3 - 1) // 2)
        field = field_from_numpy(ema, spec, device)
        print(f"[ckpt] loaded {path}")
    else:
        gen = torch.Generator().manual_seed(cfg.seed)
        field = network.FieldMLP(spec, generator=gen, device=device)
        print("[ckpt] no checkpoint loaded: random field from --seed")
    return spec, field_kernel.pack_weights(field, spec, device)


def setup(argv=None):
    """Parse main_gui's flags and build what its frames need: the field
    (``_load_field``), the simulator on ``assets/{exp_name}.ply``, the
    settings and the camera. Returns a namespace; ``newton_sim`` and
    ``newton_render`` make one Newton frame from it."""
    import types

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
    from pienerf_tpu_torch.io.ply import read_physics_ply
    from pienerf_tpu_torch.ops import beam_bend
    from pienerf_tpu_torch.render import interactive
    from pienerf_tpu_torch.sim import solver as sim
    from pienerf_tpu_torch.utils.camera import OrbitCamera

    device = resolve_device(ns.device)

    if cfg.backbone == "hashgrid" and cfg.max_iter_num != 1:
        raise NotImplementedError(
            "--backbone hashgrid renders through the fused frame "
            "(interactive.render_frame_fused, the tile kernel): pass "
            "--max_iter_num 1; the Newton frame's field kernel takes the "
            "Fourier MLP alone")
    spec, pw = _load_field(cfg, device)
    if cfg.max_iter_num == 1:
        interactive.check_fused_spec(spec)

    ply_path = os.path.join("assets", f"{cfg.exp_name}.ply")
    if not os.path.exists(ply_path):
        raise SystemExit(f"annotated physics PLY not found: {ply_path}")
    d = read_physics_ply(ply_path)
    init_kw = dict(
        dt=cfg.sim_dt / cfg.sim_substeps, iters=cfg.sim_iters,
        bbox=np.array([2.0 * cfg.bound] * 3), kres=ns.kres, dx=cfg.sim_dx,
        gravity=tuple(ns.gravity), stiff=cfg.sim_stiff,
        base=np.array([-cfg.bound] * 3), device=device)
    if cfg.sim_cache:
        consts, state, aux = sim.sim_init_cached(
            d["pos"], d["mass"], d["mu"], d["lam"], d["pin"],
            cache_dir=os.path.join(cfg.workspace, "sim_cache"), **init_kw)
    else:
        consts, state, aux = sim.sim_init(
            d["pos"], d["mass"], d["mu"], d["lam"], d["pin"], **init_kw)
    if cfg.sim_bf16_b:
        consts = sim.cast_B_bf16(consts)
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
    return types.SimpleNamespace(
        cfg=cfg, ns=ns, device=device, spec=spec, pw=pw, consts=consts,
        state=state, bst=bst, ist=ist, cut_bounds=cut_bounds, H=H, W=W,
        cam=cam, pose=torch.as_tensor(cam.pose, device=device),
        fvec=torch.tensor(ns.force, dtype=torch.float32, device=device),
        fused=cfg.max_iter_num == 1)   # fast-Newton pack -> fused tile kernel


def newton_sim(app, state, i):
    """One sim step of a Newton frame: (new state, bend pack, IP
    positions). Exits on a diverged sim."""
    import torch

    from pienerf_tpu_torch.ops import beam_bend
    from pienerf_tpu_torch.sim import solver as sim

    state = (sim.update_force(app.consts, state, app.ns.force_ip, app.fvec)
             if app.ns.force_ip >= 0 else sim.clear_force(state))
    state = sim.sim_step(app.consts, state)
    p_def, F, dF = sim.get_ip_info(app.consts, state)
    if not bool(torch.isfinite(p_def).all()):
        raise SystemExit(
            f"simulation diverged at frame {i} (NaN IP "
            "positions); tune --sim_dt / --kres / mass / lam,mu "
            "(the local-global scheme is conditionally stable, "
            "matching the CUDA reference)")
    pack = beam_bend.pack_for(app.bst, p_def, app.consts.ip_pos.float(), F,
                              dF)
    return state, pack, p_def


def newton_render(app, pack, p_def):
    """The Newton frame's render (``interactive.render_frame``, its field
    through the field kernel) of one sim step's pack."""
    from pienerf_tpu_torch.render import interactive

    return interactive.render_frame(
        app.ist, app.pw, pack, p_def, app.pose, app.cam.intrinsics, app.H,
        app.W, 1.0, app.cut_bounds)


def main(argv=None):
    app = setup(argv)
    cfg, ns = app.cfg, app.ns

    import torch

    from pienerf_tpu_torch.io.framesink import FrameSink
    from pienerf_tpu_torch.kernels import field as field_kernel
    from pienerf_tpu_torch.kernels import tile as tile_kernel
    from pienerf_tpu_torch.render import interactive, pipeline

    state = app.state
    os.makedirs(ns.out_dir, exist_ok=True)
    with FrameSink() as sink:
        t_prev = time.perf_counter()
        for i in range(ns.frames):
            if app.fused:
                state, out = pipeline.interactive_frame_step(
                    app.ist, app.consts, state, app.pw, app.pose,
                    app.cam.intrinsics, app.H, app.W, 1.0, ns.force_ip,
                    app.fvec, app.cut_bounds, substeps=cfg.sim_substeps)
                if (i % 10 == 0 or cfg.timing_on) and not bool(
                        torch.isfinite(out["tiles_ws"]).all()):
                    raise SystemExit(
                        f"simulation diverged at frame {i}; tune --sim_dt / "
                        "--kres / mass / lam,mu (the local-global scheme is "
                        "conditionally stable, matching the CUDA reference)")
            else:
                state, pack, p_def = newton_sim(app, state, i)
                out = newton_render(app, pack, p_def)
            img = interactive.tiles_to_image(out["tiles_image"], app.H,
                                             app.W, app.ist.tile)
            sink.push(os.path.join(ns.out_dir, f"frame_{i:04d}.png"), img)
            if cfg.timing_on:
                now = time.perf_counter()
                print(f"timing: frame {i}: {(now - t_prev) * 1000:.1f} ms "
                      f"(active tiles: {int(out['n_active'])})")
                t_prev = now
            if i % 10 == 0:
                print(f"frame {i}/{ns.frames}")
    print(f"wrote {ns.frames} frames to {ns.out_dir}/")
    launched = {f"field_w{w}_{t}": n for (w, t), n
                in field_kernel.field_eval.launches.items() if n}
    launched.update({f"tile_{m}_{tile_kernel.net_label(w)}_{s}_{t}": n
                     for (m, w, s, t), n
                     in tile_kernel.render_tiles.launches.items() if n})
    print(f"kernel launches: {json.dumps(launched)}")


if __name__ == "__main__":
    main()
