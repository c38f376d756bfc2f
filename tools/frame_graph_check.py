"""The fused frame as a CUDA graph against the same frame op by op, on the
card, in each benchmark cell's scene (``benchmark/cell.py``'s program).

``render_frame_fused`` replays a captured graph from its second call with
the same settings on, copying the frame's pack, deformed IPs, pose and
cut box into the graph's inputs; the first call after
``drop_frame_graphs`` runs op by op. This holds every replay bit for bit
against a fresh op-by-op frame on the same inputs: the first inputs three
times (op by op, captured, replayed), then the drag continued for
``--steps`` sim steps, each step's pack and deformed IPs at another pose
of the orbit. It also holds the tile-kernel launches a replay counts to
the op-by-op frame's, asserts that the steps changed the
image (so the comparison is not of one frame with itself), and times both
frames on the host's clock to a sync, in turns (op by op, graph, graph,
op by op). One JSON line a cell; exit 1 if any output differs.

    python tools/frame_graph_check.py [--cells a,b] [--seed n] [--steps 3]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CELLS = ("ngp_hashgrid_f32.orbit", "bench_w128_f32.orbit",
         "trex_w64_f32.cut_orbit")


def check_cell(name: str, seed: int, steps: int, reps: int = 20) -> dict:
    import torch

    from benchmark import cell as cellmod
    from benchmark.reference.sim import spring_force
    from pienerf_tpu_torch.kernels import tile as tile_kernel
    from pienerf_tpu_torch.render import interactive

    dev = torch.device("cuda", 0)
    wl = cellmod.workload(name)
    inp = cellmod.make_inputs(wl["config"], wl["traffic"], seed)
    prog = cellmod.Program(inp, dev)
    sim, bb, consts = prog.sim, prog.bb, prog.consts
    vid = int(torch.argmax(consts.ip_pos[:, 2]))
    state, n_drag = prog.state, inp.traffic["drag_frames"]
    frames = []                  # (pack, p_def, pose) a step of the drag
    for i in range(steps + 1):
        if i:
            f = spring_force(consts.ip_pos, consts.IP_kernel, consts.IP_Nx,
                             state.ddof, vid, n_drag + i, inp.spring)
            state = sim.sim_step(consts, sim.update_force(consts, state, vid,
                                                          f))
        p_def, F, dF = sim.get_ip_info(consts, state)
        pack = bb.pack_ip_data_fast(p_def, consts.ip_pos.float(), F, dF)
        pose = torch.as_tensor(inp.poses[(5 * i) % len(inp.poses)],
                               device=dev)
        frames.append((pack, p_def, pose))

    def call(k):
        pack, p_def, pose = frames[k]
        return interactive.render_frame_fused(
            prog.ist, prog.pw, pack, p_def, pose, prog.intr, prog.H, prog.W,
            1.0, prog.cut_bounds)

    def op_by_op(k):
        interactive.drop_frame_graphs()      # a first call runs op by op
        return call(k)

    def counted(fn, k):
        before = dict(tile_kernel.render_tiles.launches)
        out = fn(k)
        made = {key: n - before.get(key, 0)
                for key, n in tile_kernel.render_tiles.launches.items()}
        return out, {key: n for key, n in made.items() if n}

    order = [0, 0, 0] + list(range(1, steps + 1))
    refs = [counted(op_by_op, k) for k in order]
    interactive.drop_frame_graphs()
    outs = [counted(call, k) for k in order]
    torch.cuda.synchronize()
    equal = [all(torch.equal(out[key], ref[key]) for key in ref)
             for (out, _), (ref, _) in zip(outs, refs)]
    launch_equal = all(m == mr for (_, m), (_, mr) in zip(outs, refs))
    moved = not torch.equal(outs[0][0]["tiles_image"],
                            outs[-1][0]["tiles_image"])

    def ms(fn):
        fn(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(reps):
            fn(i % (steps + 1))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    eager = [ms(op_by_op)]
    graph = [ms(call), ms(call)]
    eager.append(ms(op_by_op))
    interactive.drop_frame_graphs()
    return {"cell": name, "seed": seed, "calls": len(order),
            "equal": equal, "launches_equal": launch_equal,
            "steps_moved_image": moved, "op_by_op_ms": eager,
            "graph_ms": graph,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--seed", type=int, default=2 ** 31 + 77)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    ok = True
    for name in args.cells.split(","):
        row = check_cell(name, args.seed, args.steps)
        print(json.dumps(row), flush=True)
        ok &= (all(row["equal"]) and row["launches_equal"]
               and row["steps_moved_image"])
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
