"""The benchmark of the PyTorch / CUDA port (``pienerf_tpu_torch``): one run
of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) is the live
viewer paused while the user orbits the camera: set-up builds the
simulator's constants (cached under ``benchmark/.cache``), drags the scene
from rest for the traffic's drag frames, packs the field and renders one
whole orbit loop to warm every shape. The window then renders paused
frames (``cell.Program.frame``), the camera walking the orbit's poses in
turn, for ``--seconds`` rounded up to whole loops.

``--trace 0`` prints the end-to-end metrics: ``frame_ms`` (the window's
wall time over its frames), ``frame_p95_ms`` (of the per-frame wall
times) and ``setup_s`` (process start to the window). ``--trace 1`` times
the traffic's ``trace_loops`` loops untraced, then as many under
``torch.profiler``, and prints the per-layer metrics (``metrics/<name>.py``)
with the breakdown.

After the window the plain reference (``reference/``) rebuilds the scene
from the same inputs and renders a seeded sample of the window's frames
(in a traced run, every pose of the loop, which also counts the work);
``correct`` is whether every number held its limit (``limits/<cell>.json``,
``check.py``). The result is the last line of standard output; the
numbers and their limits are the last lines of standard error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the top-level modules no run may hold once its window has closed: JAX
# and the JAX package (compared whole: the port's name begins with it)
FORBIDDEN = ("jax", "jaxlib", "flax", "pienerf_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def read_metric(name: str, ctx: dict):
    """Load ``metrics/<name>.py`` and read the metric from ``ctx``."""
    path = os.path.join(ROOT, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def _quantile(values, q: float) -> float:
    """The q-quantile by linear interpolation between order statistics."""
    v = sorted(values)
    pos = q * (len(v) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (pos - lo) * (v[hi] - v[lo])


def run(workload: str, seed: int, seconds: float, trace: bool, device: str,
        overrides=None, cache_dir=None) -> dict:
    """One run of ``workload`` on ``device``; returns the result line's
    object. ``overrides`` (configuration groups) and ``cache_dir`` (the
    sim-init cache) serve the CPU tests, which shrink a cell and drive it
    without a card."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    import pienerf_tpu_torch  # noqa: F401  (true f32 products)
    from benchmark import cell as cellmod
    from benchmark import check, work
    from benchmark.trace import reduce as reduce_trace

    spec = cellmod.benchmark_spec()
    wl = cellmod.workload(workload, spec)
    inp = cellmod.make_inputs(wl["config"], wl["traffic"], seed, overrides)
    limits = cellmod.load("limits", workload)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    prog = cellmod.Program(inp, dev, cache_dir=cache_dir or cellmod.SIM_CACHE)
    n_poses = len(inp.poses)
    for i in range(n_poses):                  # every pose: every shape
        prog.frame(i)
    sync()
    sample = cellmod.Reservoir(inp.traffic["check_frames"], seed)

    def loop(n_min_frames, until, span=None):
        """Frames in whole loops until ``until`` (perf_counter) has passed
        and at least ``n_min_frames`` ran: (wall s, frame s, host s)."""
        times, hosts = [], []
        t_begin = t_prev = time.perf_counter()
        n = 0
        while True:
            k = n % n_poses
            img, ctr, host_s = prog.frame(k, span)
            t = time.perf_counter()
            times.append(t - t_prev)
            hosts.append(host_s)
            t_prev = t
            sample.offer((k, img, ctr))
            n += 1
            if n % n_poses == 0 and n >= n_min_frames and t >= until:
                return t - t_begin, times, hosts

    result = {"attempted": 0, "failed": 0, "metrics": {}}
    if not trace:
        t_window = time.perf_counter()
        setup_s = t_window - T_START
        wall, times, _ = loop(n_poses, t_window + seconds)
        n_frames = len(times)
        result["metrics"] = {
            "frame_ms": {"value": 1e3 * wall / n_frames, "unit": "ms"},
            "frame_p95_ms": {"value": 1e3 * _quantile(times, 0.95),
                             "unit": "ms"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    else:
        n_trace = inp.traffic["trace_loops"] * n_poses
        wall, times, hosts = loop(n_trace, 0.0)
        frame_ms = 1e3 * wall / len(times)
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            loop(n_trace, 0.0, span=record_function)
            sync()
            traced_s = time.perf_counter() - t0
        ctx = reduce_trace(prof, n_trace, traced_s)
        ctx.update(host_ms=[1e3 * h for h in hosts], frame_ms=frame_ms)
        n_frames = len(times) + n_trace
    sync()
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of JAX or the JAX package were loaded: "
                           f"{found}")
    result["attempted"] = n_frames
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    # the program's state to judge, then nothing of it on the device
    ddof = prog.state.ddof.cpu().numpy()
    pack = prog.pack.cpu().numpy()
    del prog
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ref = check.Reference(inp, dev)
    if trace:
        passes = []
        for i in range(n_poses):
            ref.frame(i, passes)
        macs = check.ref_render.macs_per_sample(ref.layers)
        dtype = inp.cfg["dtype"]
        ctx.update(
            least_ms=1e3 * work.least_seconds(
                passes, macs, inp.cfg["render"]["num_seek"], dtype)
            / n_poses,
            mlp_flops=work.mlp_flops(passes, macs) / n_poses,
            peak_flops=work.mlp_peak(dtype))
        for name in cellmod.per_layer_names(spec, workload):
            v = read_metric(name, ctx)
            if v is not None:
                unit = next(m["unit"] for m in spec["per_layer"]
                            if m["name"] == name)
                result["metrics"][name] = {"value": v, "unit": unit}
    numbers = check.compare(ref, ddof, pack, sample.items)
    v = check.verdict(numbers, limits)
    result["correct"] = v["correct"]
    result["device"] = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        result["device"].update(busy_s=ctx["busy_s"],
                                window_s=ctx["window_s"])
        result["breakdown"] = ctx["breakdown"]
    result["checks"] = v["checks"]
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import torch
    from benchmark.cell import benchmark_spec, workload

    chips = workload(args.workload, benchmark_spec())["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        sys.exit(2)
    res = run(args.workload, args.seed, args.seconds, bool(args.trace),
              "cuda:0")
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
