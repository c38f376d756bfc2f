"""Multi-rank parity dryrun of ``parallel.sharding`` (the counterpart of
``__graft_entry__.py:71`` ``dryrun_multichip``).

Spawns ``world`` ranks (``torch.multiprocessing``, a ``file://``
rendezvous in a temporary directory) and holds each sharded path to the
same work done by one process, on every rank:

- ``train``: the data-parallel train step (the default hash grid, the
  occupancy march, an all-occupied grid): loss within 1e-5 relative;
- ``sim``: the IP-sharded simulator against the single-process trajectory
  (the dense operator where the scene has one): the largest ddof error
  within 1e-3 of the trajectory's scale;
- ``frame``: the band-sharded frame against the whole frame, through the
  fused tile kernel (one Newton step) or ``render_frame`` (more): within
  2e-3.

Toy shapes always; unless ``fast``, the production shapes too: the train
step at 4,096 rays, the sim on the 3,053-IP bench scene and the fused
frame at 896x800 at the bench's operating point (K 128, tightened spans),
also through the paired kernel. ``production`` picks a subset. The JAX
package's dryrun also row-shards the hash table over its mesh, a GSPMD
placement that the port does not make (ROADMAP).

    python -m pienerf_tpu_torch.parallel.dryrun --world 2 --fast \
        --device cpu

On the card every rank uses ``cuda:0`` with gloo (NCCL refuses two ranks
on one card); with a card a rank, pass ``--backend nccl``.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch

TOY = {"train": dict(rays=256, samples=16, max_steps=128, iters=100),
       "sim": dict(scene="cube", steps=4),
       "frame": dict(scene="toy", hw=(64, 64))}
PRODUCTION = {"train": dict(rays=4096, samples=32, max_steps=256, iters=10),
              "sim": dict(scene="sphere", steps=2),
              "frame": dict(scene="bench", hw=(896, 800))}
G_FLOOR = 1e-6   # |g| / max|g| of its leaf above which params compare


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def check_train(mesh, rays: int, samples: int, max_steps: int, iters: int,
                params=None, batch=None, seed: int = 0) -> tuple:
    """One data-parallel step from a replicated state against the same
    step on the whole batch in this process. ``params`` (a tree) and
    ``batch`` ({rays_o, rays_d, pixels [N, 3], noise}) default to seeded
    ones. Returns (metrics, arrays)."""
    from pienerf_tpu_torch.models import network
    from pienerf_tpu_torch.ops import grid as gridlib
    from pienerf_tpu_torch.parallel import sharding
    from pienerf_tpu_torch.render import renderer
    from pienerf_tpu_torch.train import trainer as tr
    from pienerf_tpu_torch.weights import field_from_numpy, field_to_numpy

    dev = mesh.device
    spec = network.make_spec(bound=1.0, backbone="hashgrid")
    if params is None:
        params = field_to_numpy(network.FieldMLP(
            spec, generator=torch.Generator().manual_seed(seed)))
    if batch is None:
        g = torch.Generator().manual_seed(seed + 1)
        d = torch.randn((rays, 3), generator=g) * 0.1 + torch.tensor(
            [0.0, 0.0, 1.0])
        batch = {"rays_o": torch.tensor([[0.0, 0.0, -2.5]]).repeat(rays, 1),
                 "rays_d": d / torch.linalg.norm(d, dim=-1, keepdim=True),
                 "pixels": torch.rand((rays, 3), generator=g),
                 "noise": torch.rand((rays,), generator=g)}
    batch = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32,
                                device=dev) for k, v in batch.items()}
    draws = {"noise": batch.pop("noise")}
    st = renderer.RenderSettings(bound=1.0, cascade=1, max_samples=samples,
                                 max_steps=max_steps)
    opt = tr.make_optimizer(1e-2, iters)
    bitfield = gridlib.packbits(torch.full((1, 128 ** 3), 20.0, device=dev),
                                10.0)

    def state():
        return tr.init_state(field_from_numpy(params, spec, dev,
                                              trainable=True), opt)

    step = sharding.make_sharded_train_step(mesh, spec, st, opt)
    s_sh, m_sh = step(sharding.replicate(mesh, state()), bitfield, batch,
                      draws=draws)
    s_1, m_1 = tr.make_train_step(spec, st, opt)(state(), bitfield, batch,
                                                 draws=draws)
    _sync(dev)
    l_sh, l_1 = float(m_sh["loss"]), float(m_1["loss"])
    p_sh = [p.detach().cpu().numpy() for p in s_sh.params.leaves()]
    p_1 = [p.detach().cpu().numpy() for p in s_1.params.leaves()]
    err = 0.0
    for a, b, gg in zip(p_sh, p_1, m_1["grads"]):
        big = (gg.abs() > G_FLOOR * gg.abs().max()).cpu().numpy()
        if big.any():
            err = max(err, float(np.abs(a - b)[big].max()))
    rel = abs(l_sh - l_1) / max(1.0, abs(l_1))
    if not (np.isfinite(l_sh) and rel <= 1e-5):
        raise AssertionError(f"sharded loss {l_sh} != single {l_1}")
    arrays = {f"param{i}": a for i, a in enumerate(p_sh)}
    arrays["loss"] = np.float32(l_sh)
    return ({"rays": rays, "samples": samples, "loss": l_sh,
             "loss_single": l_1, "loss_rel": rel,
             "param_max_abs_above_floor": err}, arrays)


def _sim_scene(scene: str, dev):
    from pienerf_tpu_torch.sim import solver as sim

    if scene == "cube":      # tests/test_sharding.py's: 27 chunks, odd
        g = np.linspace(0.3, 0.7, 8) - 0.5
        x, y, z = np.meshgrid(g, g, g, indexing="ij")
        pos = np.stack([x.ravel(), y.ravel(), z.ravel()], 1)
        n = pos.shape[0]
        consts, state, _ = sim.sim_init(
            pos, np.full(n, 0.1), np.full(n, 1e4), np.full(n, 1e4),
            pos[:, 1] > 0.15, dt=1e-2, iters=5,
            bbox=np.array([1.0, 1.0, 1.0]), kres=4, dx=0.2,
            gravity=(0.0, -9.8, 0.0), stiff=1e5,
            base=np.array([-0.5, -0.5, -0.5]), device=dev)
        return consts, state
    from pienerf_tpu_torch.data import synthetic

    pts = synthetic.scene_points("sphere", dx=0.05, bound=0.7)
    n = pts.shape[0]
    consts, state, _ = sim.sim_init(
        pts, np.full(n, 0.1), np.full(n, 1e5), np.full(n, 1e5),
        pts[:, 2] < -0.3, dt=1e-2, iters=10, bbox=np.array([2.0] * 3),
        kres=7, dx=0.05, gravity=(0.0, 0.0, 0.0), stiff=1e5,
        base=np.array([-1.0] * 3), device=dev)
    # a kick, so that the trajectory is not identically zero
    return consts, state._replace(dof_f=state.dof_f + 1e-3)


def check_sim(mesh, scene: str, steps: int) -> tuple:
    """``steps`` IP-sharded steps against the single-process trajectory
    from the same state. Returns (metrics, arrays)."""
    from pienerf_tpu_torch.parallel import sharding
    from pienerf_tpu_torch.sim import solver as sim

    consts, state = _sim_scene(scene, mesh.device)
    local, step = sharding.make_sharded_sim_step(mesh, consts)
    ref, got = state, state
    for _ in range(steps):
        ref = sim.sim_step(consts, ref)
        got = step(local, got)
    _sync(mesh.device)
    scale = float(ref.ddof.abs().max())
    err = float((got.ddof - ref.ddof).abs().max())
    if not (scale > 0.0 and np.isfinite(err)
            and err < 1e-3 * max(scale, 1e-3)):
        raise AssertionError(f"sharded sim: {err} (scale {scale})")
    return ({"scene": scene, "n_ip": int(consts.ip_pos.shape[0]),
             "chunks": int(consts.Dc.shape[0]),
             "chunks_local": int(local.Dc.shape[0]), "steps": steps,
             "ddof_max_abs": err, "scale": scale},
            {"ddof": got.ddof.cpu().numpy(),
             "dof_vel": got.dof_vel.cpu().numpy()})


def _frame_scene(scene: str, max_iter_num: int, dev, params=None):
    """(settings, the mlp's params tree, pack, p_def, pose, intrinsics,
    H, W) of the toy scene (tests/test_sharded_render.py's) or the bench
    scene at 896x800."""
    from pienerf_tpu_torch.data import synthetic
    from pienerf_tpu_torch.models import network
    from pienerf_tpu_torch.ops import beam_bend
    from pienerf_tpu_torch.render import interactive
    from pienerf_tpu_torch.weights import field_to_numpy

    spec = network.make_spec(bound=1.0, backbone="mlp")
    if params is None:
        params = field_to_numpy(network.FieldMLP(
            spec, generator=torch.Generator().manual_seed(3)))
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (0.0, 0.0, -2.5)
    if scene == "toy":
        g = np.arange(-0.4, 0.41, 0.1, dtype=np.float32)
        xx, yy, zz = np.meshgrid(g, g, g, indexing="ij")
        p = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], 1)
        p = p[np.linalg.norm(p, axis=1) <= 0.42]
        bst = beam_bend.BeamBendSettings(num_seek_ip=2,
                                         max_iter_num=max_iter_num,
                                         ip_dx=0.105, bin_capacity=12)
        ist = interactive.InteractiveSettings(
            spec=spec, bend=bst, tile=16, samples=24, active_frac=1.0,
            tile_chunk=4, min_near=0.05)
        H, W = TOY["frame"]["hw"]
        intr = (64.0, 64.0, 32.0, 32.0)
    else:
        p = synthetic.scene_points("sphere", dx=0.05,
                                   bound=0.7).astype(np.float32)
        bst = beam_bend.BeamBendSettings(num_seek_ip=3, max_iter_num=1,
                                         ip_dx=0.0525, ips_per_tile=256,
                                         bin_capacity=8)
        ist = interactive.InteractiveSettings(
            spec=spec, bend=bst, tile=16, samples=128, active_frac=0.5,
            tile_chunk=32, min_near=0.05, tighten_sampling=True)
        H, W = PRODUCTION["frame"]["hw"]
        intr = (1.2 * H, 1.2 * H, W / 2.0, H / 2.0)
    n = p.shape[0]
    pt = torch.as_tensor(p, device=dev)
    F = torch.eye(3, device=dev).expand(n, 3, 3).contiguous()
    dF = torch.zeros((n, 3, 3, 3), device=dev)
    pack = (beam_bend.pack_ip_data_fast(pt, pt, F, dF) if scene == "bench"
            else beam_bend.pack_for(bst, pt, pt, F, dF))
    return (ist, params, pack, pt, torch.as_tensor(pose, device=dev), intr,
            H, W)


def check_frame(mesh, scene: str, max_iter_num: int = 1, params=None,
                paired: bool = False) -> tuple:
    """The band-sharded frame against the whole frame rendered in this
    process. Returns (metrics, arrays)."""
    from pienerf_tpu_torch.kernels import field as field_kernel
    from pienerf_tpu_torch.parallel import sharding
    from pienerf_tpu_torch.render import interactive
    from pienerf_tpu_torch.weights import field_from_numpy

    dev = mesh.device
    ist, params, pack, p, pose, intr, H, W = _frame_scene(
        scene, max_iter_num, dev, params)
    field = field_from_numpy(params, ist.spec, dev)
    pw = field_kernel.pack_weights(field, ist.spec, dev)
    render = (interactive.render_frame_fused if max_iter_num == 1
              else interactive.render_frame)
    with torch.no_grad():
        out = render(ist, pw, pack, p, pose, intr, H, W, 1.0)
    single = interactive.tiles_to_image(out["tiles_image"], H, W, 16)
    if paired:
        pw = field_kernel.pack_weights_paired(field, ist.spec, dev)
    img, drops = sharding.render_frame_sharded(mesh, ist, pw, pack, p, pose,
                                               intr, H, W, 1.0)
    _sync(dev)
    err = float(np.abs(img - single).max())
    obj = float(np.mean(np.abs(single - 1.0) > 0.01))
    if not (img.shape == (H, W, 3) and drops["n_tile_overflow"] == 0
            and int(out["n_tile_overflow"]) == 0 and obj > 0.01
            and np.isfinite(err) and err < 2e-3):
        raise AssertionError(f"band-sharded frame: {err} {drops} {obj}")
    return ({"scene": scene, "hw": [H, W], "max_iter_num": max_iter_num,
             "paired": paired, "max_abs": err,
             "bit_equal": bool(np.array_equal(img, single)),
             "object_fraction": obj, "drops": drops},
            {"image": img, "single": single})


def _checks(mesh, cfg: dict) -> list:
    """(name, thunk) of every check of the run, in order."""
    from pienerf_tpu_torch.io.checkpoint import load_native

    inp = cfg["inputs"]

    def path(name):
        p = os.path.join(inp, name) if inp else None
        return p if p and os.path.exists(p) else None

    train_params = path("train_params.npz")
    train_params = load_native(train_params)[0] if train_params else None
    frame_params = path("frame_params.npz")
    frame_params = load_native(frame_params)[0] if frame_params else None
    batch = None
    if path("train_batch.npz"):
        with np.load(path("train_batch.npz")) as z:
            batch = {k: z[k] for k in z.files}
    prod = cfg["production"]
    out = [("train_toy", lambda: check_train(
               mesh, **TOY["train"], params=train_params, batch=batch)),
           ("sim_toy", lambda: check_sim(mesh, **TOY["sim"])),
           ("frame_toy", lambda: check_frame(mesh, "toy", 1,
                                             frame_params)),
           ("frame_toy_newton", lambda: check_frame(mesh, "toy", 2,
                                                    frame_params))]
    if "train" in prod:
        out.append(("train_production", lambda: check_train(
            mesh, **PRODUCTION["train"])))
    if "sim" in prod:
        out.append(("sim_production", lambda: check_sim(
            mesh, **PRODUCTION["sim"])))
    if "frame" in prod:
        out += [("frame_production", lambda: check_frame(mesh, "bench")),
                ("frame_production_paired", lambda: check_frame(
                    mesh, "bench", paired=True))]
    return out


def _launches() -> dict:
    """The kernels' launch counts since the last reset, named as the
    entry points print them; resets them."""
    from pienerf_tpu_torch.kernels import field as fk
    from pienerf_tpu_torch.kernels import tile as tk

    out = {f"field_w{w}_{t}": n for (w, t), n
           in fk.field_eval.launches.items() if n}
    out.update({f"tile_{m}_w{w}_{s}_{t}": n for (m, w, s, t), n
                in tk.render_tiles.launches.items() if n})
    fk.field_eval.launches = dict.fromkeys(fk.field_eval.launches, 0)
    tk.render_tiles.launches = dict.fromkeys(tk.render_tiles.launches, 0)
    return out


def _worker(rank: int, world: int, tmp: str, cfg: dict) -> None:
    from pienerf_tpu_torch.parallel import sharding

    torch.set_num_threads(cfg["threads"])
    mesh = sharding.make_mesh(f"file://{os.path.join(tmp, 'rendezvous')}",
                              world, rank, cfg["backend"], cfg["device"])
    try:
        report, arrays = {}, {}
        for name, thunk in _checks(mesh, cfg):
            _launches()
            t0 = time.perf_counter()
            report[name], a = thunk()
            report[name]["seconds"] = time.perf_counter() - t0
            report[name]["launches"] = _launches()
            arrays.update({f"{name}/{k}": v for k, v in a.items()})
        if rank == 0:
            np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
            with open(os.path.join(tmp, "report.json"), "w") as f:
                json.dump(report, f)
    finally:
        sharding.close(mesh)


def run(world: int = 2, fast: bool = True,
        production: Optional[Sequence[str]] = None, device="cpu",
        backend: str = "gloo", inputs: Optional[str] = None,
        arrays_out: Optional[str] = None, threads: int = 1) -> dict:
    """Spawn ``world`` ranks and run the checks (toy shapes, and the
    ``production`` ones: default all three unless ``fast``); the report of
    rank 0. ``inputs``: a directory whose ``train_params.npz`` /
    ``frame_params.npz`` (native checkpoints) and ``train_batch.npz``
    stand in for the toy checks' seeded ones (the tests pass JAX's);
    ``arrays_out``: where rank 0's outputs go (an npz). ``threads``: torch
    threads a rank."""
    import shutil

    import torch.multiprocessing as mp

    if production is None:
        production = () if fast else tuple(PRODUCTION)
    cfg = {"device": str(device), "backend": backend, "threads": threads,
           "inputs": inputs, "production": list(production)}
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_worker, args=(world, tmp, cfg), nprocs=world, join=True)
        with open(os.path.join(tmp, "report.json")) as f:
            report = json.load(f)
        if arrays_out:
            shutil.copy(os.path.join(tmp, "arrays.npz"), arrays_out)
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--fast", action="store_true",
                    help="toy shapes only")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--backend", default="gloo", help="gloo or nccl")
    a = ap.parse_args(argv)
    report = run(a.world, a.fast, device=a.device, backend=a.backend)
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
