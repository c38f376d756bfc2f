"""The product path end to end on a hash grid trained by the port (port of
tools/hashgrid_chain.py).

Input: a workspace where ``tools/quality_run.py --backbone hashgrid``
trained past its plateau (curve.json + native npz checkpoints). The chain
walks the reference user workflow (reference README.md:91-134) without an
external asset:

  1. export the newest native checkpoint to the reference's ``ngp_ep*.pth``
     format (``io/checkpoint.save_torch_ngp``) and re-import it, asserting
     that the round trip is bit-exact on every tensor;
  2. sample a physics point cloud from the re-imported field
     (``sample.AdaptiveUniformSampling``, the reference's main_sample.py)
     and annotate it as a user would by hand: the bottom 12% by z pinned,
     lam = mu = 1e5, mass 0.1;
  3. hand the .pth and the annotated PLY to ``validate_asset.run``:
     distill into the mlp student, image-space agreement, the coupled
     frame's rate.

One JSON report (train curve summary, round trip, sampling, annotation,
the asset report) and one ``chain_summary`` line:

    python -m pienerf_tpu_torch.tools.hashgrid_chain \
        --workspace runs/torch_quality_hashgrid_r4

Runs on the card; ``--device cpu`` is the only way onto the CPU.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time
from typing import Optional

import numpy as np

PIN_QUANTILE = 0.12      # the bottom share of the cloud by z that is pinned


def flatten(prefix: str, node, out: dict) -> dict:
    """A params tree's leaves as numpy arrays under slash-joined keys."""
    if isinstance(node, dict):
        for k, v in node.items():
            flatten(f"{prefix}/{k}", v, out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            flatten(f"{prefix}/{i}", v, out)
    else:
        out[prefix] = np.asarray(node)
    return out


def roundtrip(native: str) -> tuple:
    """Export the native checkpoint's EMA params (else its params) to a
    ``.pth`` beside it and re-import it: (re-imported params, report).
    Raises unless every tensor comes back bit for bit."""
    from pienerf_tpu_torch.io import checkpoint as ckpt_io

    tree, _ = ckpt_io.load_native(native)
    params = tree.get("ema_params", tree.get("params", tree))
    pth = native[:-len(".npz")] + ".pth"
    t0 = time.time()
    ckpt_io.save_torch_ngp(pth, params)
    re_params, _ = ckpt_io.load_torch_ngp(pth)
    a = flatten("", params, {})
    b = flatten("", re_params, {})
    if set(a) != set(b):
        raise RuntimeError(f"roundtrip key mismatch: {set(a) ^ set(b)}")
    max_err = max(float(np.max(np.abs(a[k].astype(np.float64)
                                      - b[k].astype(np.float64))))
                  if a[k].size else 0.0 for k in a)
    if max_err != 0.0:
        raise RuntimeError(f"pth roundtrip not bit-exact: {max_err}")
    return re_params, {"native": native, "pth": pth, "n_tensors": len(a),
                       "bit_exact": True, "max_abs_err": max_err,
                       "seconds": time.time() - t0}


def annotate(ply_path: str) -> int:
    """Rewrite a sampled cloud as an annotated physics PLY
    (tools/hashgrid_chain.py:137-145): the bottom ``PIN_QUANTILE`` by z
    pinned, rubber-like moduli, uniform mass. Returns the pinned count."""
    from pienerf_tpu_torch.io.ply import read_physics_ply, write_ply

    d = read_physics_ply(ply_path)
    n = d["pos"].shape[0]
    pin = (d["pos"][:, 2] < np.quantile(d["pos"][:, 2],
                                        PIN_QUANTILE)).astype(np.float64)
    write_ply(ply_path, d["pos"], vp=d["vp"], pin=pin,
              lam=np.full(n, 1e5), mu=np.full(n, 1e5), mass=np.full(n, 0.1))
    return int(pin.sum())


def run(workspace: str, out: Optional[str] = None, *, bound: float = 1.0,
        sub_res: int = 64, density_threshold: float = 0.02,
        sim_dx: float = 0.05, distill_steps: int = 4000,
        student_width: int = 64, H: int = 256, W: int = 256,
        n_poses: int = 8, teacher_spec=None, device=None) -> dict:
    """The chain on ``workspace``'s newest native checkpoint, on
    ``device`` (default the card); the report, also written to ``out``
    (default ``<workspace>/hashgrid_chain_report.json``).
    ``teacher_spec``: the hash grid the workspace trained (default: the
    reference's, ``network.make_spec``)."""
    from pienerf_tpu_torch.config import PieNeRFConfig
    from pienerf_tpu_torch.device import resolve_device
    from pienerf_tpu_torch.models import network
    from pienerf_tpu_torch.sample import AdaptiveUniformSampling
    from pienerf_tpu_torch.tools import validate_asset
    from pienerf_tpu_torch.weights import field_from_numpy

    dev = resolve_device(device)
    out = out or os.path.join(workspace, "hashgrid_chain_report.json")
    report: dict = {"workspace": workspace}

    # --- the training summary quality_run recorded
    curve_path = os.path.join(workspace, "curve.json")
    if os.path.exists(curve_path):
        with open(curve_path) as f:
            curve = json.load(f)
        report["train"] = {
            "final_step": curve[-1]["step"],
            "final_eval_psnr": curve[-1]["psnr"],
            "peak_eval_psnr": max(c["psnr"] for c in curve),
            "wall_s": curve[-1]["wall_s"],
        }

    # --- 1: export -> re-import, bit-exact
    cands = sorted(glob.glob(
        os.path.join(workspace, "checkpoints", "ngp_ep*.npz")))
    if not cands:
        raise FileNotFoundError(f"no native checkpoints under {workspace}")
    re_params, report["pth_roundtrip"] = roundtrip(cands[-1])
    pth = report["pth_roundtrip"]["pth"]

    # --- 2: the physics cloud from the re-imported params (the path a
    # reference user's checkpoint takes), then the user's annotation
    cfg = PieNeRFConfig(
        bound=bound, sub_res=sub_res, density_threshold=density_threshold,
        sim_dx=sim_dx, workspace=workspace, backbone="hashgrid").finalize()
    spec = teacher_spec or network.make_spec(bound=bound,
                                             backbone="hashgrid")
    t0 = time.time()
    sampler = AdaptiveUniformSampling(
        cfg, field_from_numpy(re_params, spec, dev), spec)
    ply_path = os.path.join(workspace, "physics.ply")
    pts = sampler.sample(write_path=ply_path)["points"]
    del sampler
    report["sampling"] = {
        "n_points": int(pts.shape[0]),
        "bbox_min": [float(v) for v in pts.min(0)],
        "bbox_max": [float(v) for v in pts.max(0)],
        "seconds": time.time() - t0,
    }
    if pts.shape[0] <= 200:
        raise RuntimeError("sampling produced a degenerate cloud")
    report["annotation"] = {"n_pinned": annotate(ply_path)}

    # --- 3: the asset-validation chain
    report["asset"] = validate_asset.run(
        pth, ply_path, out + ".asset.json", bound=bound, n_poses=n_poses,
        H=H, W=W, distill_steps=distill_steps, student_width=student_width,
        sim_dx=sim_dx, teacher_spec=spec, device=dev)

    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"chain_summary": {
        "train_final_psnr": report.get("train", {}).get("final_eval_psnr"),
        "roundtrip_bit_exact": report["pth_roundtrip"]["bit_exact"],
        "n_physics_points": report["sampling"]["n_points"],
        "distill_image_psnr": report["asset"]["image_agreement"][
            "psnr_mean"],
        "interactive_fps": report["asset"]["interactive"]["fps"],
    }}), flush=True)
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workspace", default="runs/torch_quality_hashgrid_r4")
    ap.add_argument("--out", default=None,
                    help="default: <workspace>/hashgrid_chain_report.json")
    ap.add_argument("--bound", type=float, default=1.0)
    ap.add_argument("--sub_res", type=int, default=64)
    ap.add_argument("--density_threshold", type=float, default=0.02)
    ap.add_argument("--sim_dx", type=float, default=0.05)
    ap.add_argument("--distill_steps", type=int, default=4000)
    ap.add_argument("--student_width", type=int, default=64)
    ap.add_argument("--H", type=int, default=256)
    ap.add_argument("--W", type=int, default=256)
    ap.add_argument("--n_poses", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    return run(a.workspace, a.out, bound=a.bound, sub_res=a.sub_res,
               density_threshold=a.density_threshold, sim_dx=a.sim_dx,
               distill_steps=a.distill_steps, student_width=a.student_width,
               H=a.H, W=a.W, n_poses=a.n_poses, device=a.device)


if __name__ == "__main__":
    main()
