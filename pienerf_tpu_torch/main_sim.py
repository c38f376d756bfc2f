"""Headless simulation on the card (port of main_sim.py): step an annotated
physics PLY and write per-frame point clouds.

    python -m pienerf_tpu_torch.main_sim --ply assets/chair.ply \\
        --steps 1000 --out_dir sim_out

Scenes above ``sim.solver.DENSE_IP_THRESHOLD`` IPs run the cell-chunked
operator, smaller ones the dense one. Runs on the card; ``--device cpu`` is
the only way onto the CPU.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--ply", type=str, required=True)
    parser.add_argument("--steps", type=int, default=1000)
    parser.add_argument("--out_dir", type=str, default="sim_out")
    parser.add_argument("--out_every", type=int, default=10)
    parser.add_argument("--sim_dt", type=float, default=1e-2)
    parser.add_argument("--sim_dx", type=float, default=0.05)
    parser.add_argument("--sim_iters", type=int, default=10)
    parser.add_argument("--sim_stiff", type=float, default=1e5)
    parser.add_argument("--bound", type=float, default=1.0)
    parser.add_argument("--kres", type=int, default=7)
    parser.add_argument("--gravity", nargs=3, type=float,
                        default=[0.0, -9.8, 0.0])
    parser.add_argument("--sim_substeps", type=int, default=1,
                        help="inner steps of dt/substeps per output step "
                             "(stabilizes stiff scenes; 1 = reference)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    ns = parser.parse_args(argv)

    import torch

    from pienerf_tpu_torch.device import resolve_device
    from pienerf_tpu_torch.io.ply import read_physics_ply, write_ply
    from pienerf_tpu_torch.sim import solver as sim

    device = resolve_device(ns.device)
    d = read_physics_ply(ns.ply)
    consts, state, aux = sim.sim_init(
        d["pos"], d["mass"], d["mu"], d["lam"], d["pin"],
        dt=ns.sim_dt / ns.sim_substeps, iters=ns.sim_iters,
        bbox=np.array([2.0 * ns.bound] * 3), kres=ns.kres, dx=ns.sim_dx,
        gravity=tuple(ns.gravity), stiff=ns.sim_stiff,
        base=np.array([-ns.bound] * 3), device=device)
    print(f"[sim] {d['pos'].shape[0]} points, {aux['n_ip']} IPs, "
          f"{aux['n_k']} kernel nodes, "
          f"{'dense' if consts.B is not None else 'chunked'} operator")

    os.makedirs(ns.out_dir, exist_ok=True)
    t0 = time.time()
    for i in range(ns.steps):
        for _ in range(ns.sim_substeps):
            state = sim.sim_step(consts, state)
        if i % ns.out_every == 0:
            pos = sim.point_positions(consts, state).cpu().numpy()
            if not np.isfinite(pos).all():
                raise SystemExit(
                    f"simulation diverged at step {i} (NaN positions). "
                    "The local-global iteration is only conditionally "
                    "stable (the CUDA reference has the same behavior): "
                    "raise --sim_substeps (runs dt/substeps inner steps), "
                    "increase point mass, or reduce lam/mu stiffness.")
            write_ply(os.path.join(ns.out_dir, f"pnt_{i:05d}.ply"), pos)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    print(f"{ns.steps} steps in {dt:.2f}s -> {ns.steps / dt:.1f} steps/s")


if __name__ == "__main__":
    main()
