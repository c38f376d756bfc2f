"""Live web viewer entry point (port of main_viewer.py: the counterpart of
the dearpygui windows of the reference's main_gui.py / main_train.py
--gui, nerf/gui.py:61-952, as a browser page served over stdlib HTTP).

Sim mode (default), the coupled interactive physics demo on the fused
tile kernel:

    python -m pienerf_tpu_torch.main_viewer --workspace model/chair \\
        --exp_name chair --backbone mlp --sim_dx 0.05 --num_seek_IP 3 \\
        --max_iter_num 1

Train mode, train-while-render with spp accumulation:

    python -m pienerf_tpu_torch.main_viewer --mode train --path data/lego \\
        --backbone mlp

Then open http://127.0.0.1:7007/ (drag = orbit, ctrl+drag = pick and pull
an IP, space = pause, [ ] = dataset poses in train mode). ``--frames N``
stops after N frames (scripted runs). The field is the workspace's, as the
trainer picks it (``--ckpt``): the mlp backbone, or ``--backbone
hashgrid`` (torch-ngp's field: a native checkpoint, a reference ``.pth`` or
a seeded random field; f32, no background net). Sim mode reads the
annotated ``assets/<exp_name>.ply`` and needs ``--max_iter_num 1``; ``--cut
--cut_bounds ...`` bends inside the box only. Runs on the card; ``--device
cpu`` is the only way onto the CPU.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def parse(argv=None):
    """(cfg, the viewer's own flags)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--mode", choices=("sim", "train"), default="sim")
    parser.add_argument("--port", type=int, default=7007)
    parser.add_argument("--frames", type=int, default=None,
                        help="stop after N frames (scripted runs)")
    parser.add_argument("--gravity", nargs=3, type=float,
                        default=[0.0, -9.8, 0.0])
    parser.add_argument("--kres", type=int, default=7)
    parser.add_argument("--target_ms", type=float, default=80.0,
                        help="sim-mode dynamic-resolution frame budget")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    from pienerf_tpu_torch.config import get_shared_opts
    cfg = get_shared_opts(parser, argv)
    ns, _ = parser.parse_known_args(argv)
    return cfg, ns


def load_trainer(cfg, ns):
    """The workspace's field in a trainer (``--ckpt``): mlp or hashgrid,
    with no background net (the fused frame renders none)."""
    from pienerf_tpu_torch.render import interactive
    from pienerf_tpu_torch.train.trainer import Trainer

    trainer = Trainer("ngp", cfg, workspace=cfg.workspace,
                      use_checkpoint=cfg.ckpt, device=ns.device)
    interactive.check_fused_spec(trainer.spec)
    return trainer


def setup_sim(cfg, ns, trainer):
    """The sim mode's inputs: (consts, state, settings, packed weights,
    cut_bounds) from ``assets/<exp_name>.ply`` and the trainer's EMA
    field."""
    import torch

    from pienerf_tpu_torch.io.ply import read_physics_ply
    from pienerf_tpu_torch.kernels import field as field_kernel
    from pienerf_tpu_torch.ops import beam_bend
    from pienerf_tpu_torch.render import interactive
    from pienerf_tpu_torch.sim import solver as sim

    if cfg.max_iter_num != 1:
        raise SystemExit("the live viewer runs the fused max_iter_num=1 "
                         "path (chair demo config); use main_gui for "
                         "deeper Newton")
    dev = trainer.device
    ply_path = os.path.join("assets", f"{cfg.exp_name}.ply")
    if not os.path.exists(ply_path):
        raise SystemExit(f"annotated physics PLY not found: {ply_path}")
    d = read_physics_ply(ply_path)
    init_kw = dict(
        dt=cfg.sim_dt / cfg.sim_substeps, iters=cfg.sim_iters,
        bbox=np.array([2.0 * cfg.bound] * 3), kres=ns.kres, dx=cfg.sim_dx,
        gravity=tuple(ns.gravity), stiff=cfg.sim_stiff,
        base=np.array([-cfg.bound] * 3), device=dev)
    if cfg.sim_cache:
        consts, state, aux = sim.sim_init_cached(
            d["pos"], d["mass"], d["mu"], d["lam"], d["pin"],
            cache_dir=os.path.join(cfg.workspace, "sim_cache"), **init_kw)
    else:
        consts, state, aux = sim.sim_init(
            d["pos"], d["mass"], d["mu"], d["lam"], d["pin"], **init_kw)
    if cfg.sim_bf16_b:
        consts = sim.cast_B_bf16(consts)
    print(f"[sim] {aux['n_ip']} IPs, {aux['n_k']} kernel nodes", flush=True)

    pw = field_kernel.pack_weights(trainer.state.ema_params, trainer.spec,
                                   dev)
    bst = beam_bend.BeamBendSettings(
        num_seek_ip=cfg.num_seek_IP, max_iter_num=1,
        ip_dx=1.05 * cfg.sim_dx, ips_per_tile=256)
    ist = interactive.InteractiveSettings(
        spec=trainer.spec, bend=bst, tile=16, samples=cfg.render_samples,
        min_near=cfg.min_near, T_thresh=cfg.T_thresh,
        cut=cfg.cut, bound=cfg.bound,
        tighten_sampling=cfg.tighten_sampling)
    cut_bounds = (torch.tensor(cfg.cut_bounds, dtype=torch.float32,
                               device=dev) if cfg.cut else None)
    return consts, state, ist, pw, cut_bounds


def main(argv=None):
    cfg, ns = parse(argv)

    from pienerf_tpu_torch import web_viewer
    from pienerf_tpu_torch.kernels import tile as tile_kernel

    trainer = load_trainer(cfg, ns)
    if ns.mode == "train":
        from pienerf_tpu_torch.data.provider import NeRFDataset
        ds = NeRFDataset(cfg, type="train")
        web_viewer.run_train_viewer(trainer, ds, port=ns.port,
                                    max_frames=ns.frames)
    else:
        consts, state, ist, pw, cut_bounds = setup_sim(cfg, ns, trainer)
        web_viewer.run_sim_viewer(cfg, consts, state, ist, pw,
                                  cut_bounds=cut_bounds, port=ns.port,
                                  max_frames=ns.frames,
                                  target_ms=ns.target_ms)
    launched = {f"tile_{m}_{tile_kernel.net_label(w)}_{s}_{t}": n
                for (m, w, s, t), n
                in tile_kernel.render_tiles.launches.items() if n}
    print(f"kernel launches: {json.dumps(launched)}", flush=True)


if __name__ == "__main__":
    main()
