"""Readings the correctness limits of a cell are set from, on the card.

    python3 benchmark/calibrate.py --workload <name> --seeds 1 2 3 ...

For each seed, in one process: the program set up as a run sets it up
renders one whole orbit loop, and a seeded sample of as many frames as a
run compares is judged against the plain reference (``sound``); then the
controls, judged the same way against that reference: the reference in the
program's place with its f32 products in TF32, the nearest precision below
the configuration's true f32, in the drag and the frames (``tf32``) or in
the frames alone from the f32 state (``tf32_render``); and the program's
own bf16 field path (``bf16``), which exists for the Fourier-MLP field
alone: for any other backbone it is skipped and named on standard error.
One JSON line a seed on standard output, then the largest sound reading
and the smallest control reading of each number. ``--control_seeds N``
reads the controls on the first N seeds only.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _program_sample(cellmod, inp, dev, seed, dtype=None, poses_idx=None):
    """(ddof, pack, sampled frames) of the program: one loop over the
    orbit, the run's reservoir sample (or the frames at ``poses_idx``)."""
    import torch
    prog = cellmod.Program(inp, dev, dtype=dtype)
    sample = cellmod.Reservoir(inp.traffic["check_frames"], seed)
    frames = {}
    for k in range(len(inp.poses)):
        img, ctr, _ = prog.frame(k)
        frames[k] = (k, img, ctr)
        sample.offer(frames[k])
    items = (sample.items if poses_idx is None
             else [frames[k] for k in poses_idx])
    out = (prog.state.ddof.cpu().numpy(), prog.pack.cpu().numpy(), items)
    del prog
    torch.cuda.empty_cache()
    return out


def main() -> None:
    import argparse

    import torch

    import pienerf_tpu_torch  # noqa: F401
    from benchmark import cell as cellmod
    from benchmark import check

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control_seeds", type=int, default=None,
                    help="read the controls on the first N seeds only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("calibrate: no CUDA device")
    dev = torch.device("cuda:0")
    wl = cellmod.workload(args.workload)
    rows = []
    n_ctl = len(args.seeds) if args.control_seeds is None else \
        args.control_seeds
    bf16 = cellmod.load("configs", wl["config"])["field"].get(
        "backbone", "mlp") == "mlp"
    if not bf16:
        print(f"calibrate: control bf16 skipped for {wl['config']}: the "
              "program's bf16 path runs the Fourier-MLP field alone",
              file=sys.stderr)
    for i, seed in enumerate(args.seeds):
        inp = cellmod.make_inputs(wl["config"], wl["traffic"], seed)
        ddof, pack, items = _program_sample(cellmod, inp, dev, seed)
        poses_idx = [k for k, _, _ in items]
        ref = check.Reference(inp, dev)
        row = {"seed": seed, "poses": poses_idx,
               "sound": check.compare(ref, ddof, pack, items)}
        if i >= n_ctl:
            rows.append(row)
            print(json.dumps(row), flush=True)
            continue
        ctl = {"tf32": check.Reference(inp, dev, tf32_sim=True,
                                       tf32_render=True),
               "tf32_render": check.Reference(inp, dev, tf32_render=True)}
        for name, c in ctl.items():
            c_items = [(k,) + c.frame(k) for k in poses_idx]
            row[name] = check.compare(ref, c.ddof.cpu().numpy(),
                                      c.pack.cpu().numpy(), c_items)
        del ctl, c
        if bf16:
            b_ddof, b_pack, b_items = _program_sample(
                cellmod, inp, dev, seed, dtype="bfloat16",
                poses_idx=poses_idx)
            row["bf16"] = check.compare(ref, b_ddof, b_pack, b_items)
        del ref
        torch.cuda.empty_cache()
        rows.append(row)
        print(json.dumps(row), flush=True)
    names = rows[0]["sound"].keys()
    print(json.dumps({
        "workload": args.workload, "seeds": len(rows),
        "sound_max": {n: max(r["sound"][n] for r in rows) for n in names},
        **{f"{c}_min": {n: min(r[c][n] for r in rows if c in r)
                        for n in names}
           for c in ("tf32", "tf32_render", "bf16")
           if any(c in r for r in rows)}}), flush=True)


if __name__ == "__main__":
    main()
