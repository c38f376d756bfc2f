"""The host's blocking syncs and the device's idle time of a profiled run,
each attributed to the innermost span open at the time: the program's
``frame.*`` spans (``pienerf_tpu_torch/utils/trace.py``) or the
benchmark's ``bench.*`` ranges (``cell.Program.frame``), ``between``
where none is open. Read from the same ``torch.profiler`` run as
``trace.py``; the three readers ``metrics/host_syncs.py``,
``sync_wait_ms.py`` and ``render_issue_ms.py`` read it.

A sync is a host call into the CUDA runtime that waits for the device
(``SYNC_CALLS``): an upload from pageable host memory
(``torch.tensor(x, device=cuda)``) and a ``.cpu()`` fetch both end in a
stream synchronize. A sync belongs to the span open at its start; the
run's closing synchronize, after every span has closed, is left out. An
idle gap between two of the device's merged spans (merged as ``trace.py``
merges them) belongs to the span open at its middle.

``run.py`` hands a reader the reduced trace (``trace.reduce``), which
holds neither the runtime calls nor the program's spans, so ``attach``
takes the profile from the run that is reading its metrics (a
``torch.profiler.profile`` among its callers' locals) and labels the
breakdown's ten longest idle gaps with the innermost span, in place.

    python3 -m benchmark.spans --workload <cell> --seed <n>

profiles a cell's traced loops alone and prints the syncs and the idle
time a frame by span, with the runtime calls by name (CUDA only).
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional

from benchmark.trace import _union

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")
PREFIXES = ("frame.", "bench.")
FRAME_RENDER = "frame.render"
FRAME_FETCH = "frame.fetch"
OUTSIDE = "between"


def _open_at(spans: List[tuple], times: List[float]) -> List[list]:
    """For each time, the names of the spans (start, end, name) open at it,
    outermost first: one sweep over the sorted ends."""
    marks = [(s, 0, i) for i, (s, _, _) in enumerate(spans)]
    marks += [(t, 2, i) for i, (_, t, _) in enumerate(spans)]
    marks += [(x, 1, j) for j, x in enumerate(times)]
    marks.sort()
    now, out = [], [None] * len(times)
    for _, kind, i in marks:
        if kind == 0:
            now.append(i)
        elif kind == 2:
            now.remove(i)
        else:
            out[i] = [spans[k][2] for k in now]
    return out


def _add(table: dict, key: str, n: int, us: float) -> None:
    c = table.setdefault(key, [0, 0.0])
    c[0] += n
    c[1] += us


def reduce(events, n_frames: int) -> Optional[Dict]:
    """Per-frame readings of ``n_frames`` profiled frames from the
    profiler's ``events``; None where no sync call was traced (a CPU run).
    ``host_syncs`` (calls a frame), ``sync_wait_ms`` (host ms a frame in
    them, those in ``frame.fetch`` left out) and ``render_issue_ms`` (host
    ms a frame in ``frame.render`` less its syncs) are None, but the first,
    where the program opened no ``frame.*`` span. ``syncs`` ([calls, ms] a
    frame), ``idle_ms`` (ms a frame) and ``idle_gaps`` (the ten longest,
    [label, s], as ``trace.reduce`` orders them) go by innermost span;
    ``runtime`` holds every CUDA runtime call's [calls, ms] a frame."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    spans, syncs, device, runtime = [], [], [], {}
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            if not e.name.startswith(PREFIXES):
                device.append((s, t))
        elif e.name.startswith(PREFIXES):
            spans.append((s, t, e.name))
        elif e.name.startswith("cuda"):
            _add(runtime, e.name, 1, t - s)
            if e.name in SYNC_CALLS:
                syncs.append((s, t))
    end = max((t for _, t, _ in spans), default=float("-inf"))
    syncs = [(s, t) for s, t in syncs if s <= end]   # not the closing one
    if not syncs:
        return None
    by_span, wait_us, render_sync_us = {}, 0.0, 0.0
    for (s, t), names in zip(syncs, _open_at(spans, [s for s, _ in syncs])):
        _add(by_span, names[-1] if names else OUTSIDE, 1, t - s)
        if FRAME_FETCH not in names:
            wait_us += t - s
        if FRAME_RENDER in names:
            render_sync_us += t - s
    _, merged = _union(device)
    gaps = [(a, b) for (_, a), (b, _) in zip(merged, merged[1:])]
    idle, labelled = {}, []
    for (a, b), names in zip(gaps, _open_at(
            spans, [0.5 * (a + b) for a, b in gaps])):
        label = names[-1] if names else OUTSIDE
        idle[label] = idle.get(label, 0.0) + (b - a)
        labelled.append((label, (b - a) * 1e-6))
    labelled.sort(key=lambda g: -g[1])
    per = 1e3 * n_frames
    programmed = any(name.startswith("frame.") for _, _, name in spans)
    render_us = sum(t - s for s, t, name in spans if name == FRAME_RENDER)
    return {
        "host_syncs": len(syncs) / n_frames,
        "sync_wait_ms": wait_us / per if programmed else None,
        "render_issue_ms": ((render_us - render_sync_us) / per
                            if programmed else None),
        "syncs": {k: [n / n_frames, us / per]
                  for k, (n, us) in by_span.items()},
        "idle_ms": {k: us / per for k, us in idle.items()},
        "idle_gaps": [list(g) for g in labelled[:10]],
        "runtime": {k: [n / n_frames, us / per]
                    for k, (n, us) in runtime.items()},
    }


def _run_profile():
    """The ``torch.profiler.profile`` in a caller's locals, or None."""
    import torch
    f = sys._getframe(1)
    while f is not None:
        for v in list(f.f_locals.values()):
            if isinstance(v, torch.profiler.profile):
                return v
        f = f.f_back
    return None


def attach(ctx: dict) -> Optional[Dict]:
    """``reduce`` of the run whose reduced trace ``ctx`` is (once a
    context: kept under ``ctx["spans"]``); None without frames or a
    profile. Labels ``ctx["breakdown"]``'s idle gaps with the innermost
    span where they are the same ten gaps."""
    if "spans" not in ctx:
        prof = _run_profile() if ctx.get("frames") else None
        ctx["spans"] = r = (None if prof is None
                            else reduce(prof.events(), ctx["frames"]))
        old = (ctx.get("breakdown") or {}).get("idle_gaps")
        if r is not None and old is not None and [
                g[1] for g in old] == [g[1] for g in r["idle_gaps"]]:
            ctx["breakdown"]["idle_gaps"] = r["idle_gaps"]
    return ctx["spans"]


def main() -> None:
    import argparse
    import json
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    import pienerf_tpu_torch  # noqa: F401  (true f32 products)
    from benchmark import cell

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("spans: needs a CUDA device", file=sys.stderr)
        sys.exit(2)
    dev = torch.device("cuda:0")
    wl = cell.workload(args.workload)
    inp = cell.make_inputs(wl["config"], wl["traffic"], args.seed)
    prog = cell.Program(inp, dev)
    n = inp.traffic["trace_loops"] * len(inp.poses)

    def loop(span=None):
        """ms a frame over ``n`` frames and their host ms until the fetch,
        from a synchronized device to the last fetch."""
        hosts = []
        t0 = time.perf_counter()
        for i in range(n):
            hosts.append(prog.frame(i % len(inp.poses), span)[2])
        return 1e3 * (time.perf_counter() - t0) / n, 1e3 * sum(hosts) / n

    loop()                                          # every shape, warm
    torch.cuda.synchronize(dev)
    frame_ms, host_ms = loop()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced_ms, traced_host_ms = loop(record_function)
    r = reduce(prof.events(), n)
    print(json.dumps(dict(
        workload=args.workload, frames=n,
        device=torch.cuda.get_device_name(dev), frame_ms=frame_ms,
        host_ms=host_ms, traced_frame_ms=traced_ms,
        traced_host_ms=traced_host_ms, **(r or {}))), flush=True)


if __name__ == "__main__":
    main()
