"""Reduction of a ``torch.profiler`` run of whole frames to what the
per-layer readers (``metrics/<name>.py``) read.

Device spans are the profiler's device events (kernels, copies, sets)
except the device-side copies of the benchmark's own ``bench.*`` ranges.
A range's device time is that of the kernels linked to the ops inside it,
walked down its subtree; a kernel launched through ctypes, like the tile
kernel, may link to no op, so the tile kernel is always read by name from
the device events.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

TILE_KERNEL = "render_tiles_kernel"
SPAN_PREFIX = "bench."
NAME_CHARS = 120          # a kernel's name in the breakdown, cut to this


def _union(spans: List[Tuple[float, float]]) -> Tuple[float, list]:
    """(busy microseconds, merged intervals) of device spans."""
    busy, merged = 0.0, []
    for s, t in sorted(spans):
        if merged and s <= merged[-1][1]:
            if t > merged[-1][1]:
                busy += t - merged[-1][1]
                merged[-1][1] = t
        else:
            busy += t - s
            merged.append([s, t])
    return busy, merged


def _subtree_kernels(e, skip_tile: bool) -> float:
    """Microseconds of the device kernels linked to ``e`` and its
    descendants (the ``bench.*`` device ranges and, with ``skip_tile``,
    the tile kernel left out)."""
    total, stack = 0.0, [e]
    while stack:
        node = stack.pop()
        for k in getattr(node, "kernels", []):
            if k.name.startswith(SPAN_PREFIX):
                continue
            if skip_tile and TILE_KERNEL in k.name:
                continue
            total += k.duration
        stack.extend(node.cpu_children)
    return total


def reduce(prof, n_frames: int, window_s: float) -> Dict:
    """Per-frame readings of a profiled run of ``n_frames`` frames that
    took ``window_s`` of wall time: ``busy_s``, ``span_device_ms`` (each
    ``bench.*`` range, the tile kernel left out), ``span_host_ms``,
    ``kernel_ms`` (device ms a frame by kernel name), ``tile_kernel_ms``
    (None where no tile kernel ran), and the ``breakdown``: the ten device
    ops that took most time (seconds over the window, names cut to
    ``NAME_CHARS``) and the ten longest idle gaps, each labelled with the
    ``bench.*`` range the host was in at its middle (``between`` outside
    any)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    spans, by_name = [], {}
    host_ranges, span_dev, span_host = [], {}, {}
    for e in prof.events():
        if e.device_type == cuda:
            if e.name.startswith(SPAN_PREFIX):
                continue
            s, t = e.time_range.start, e.time_range.end
            spans.append((s, t))
            by_name[e.name] = by_name.get(e.name, 0.0) + (t - s)
        elif e.name.startswith(SPAN_PREFIX):
            host_ranges.append((e.time_range.start, e.time_range.end, e.name))
            span_host[e.name] = span_host.get(e.name, 0.0) + e.cpu_time_total
            span_dev[e.name] = span_dev.get(e.name, 0.0) + _subtree_kernels(
                e, skip_tile=True)
    busy_us, merged = _union(spans)
    gaps = []
    host_ranges.sort()
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid, label = 0.5 * (a + b), "between"
        for s, t, name in host_ranges:
            if s <= mid <= t:
                label = name
                break
            if s > mid:
                break
        gaps.append((label, (b - a) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    per = 1e3 * n_frames
    tile_us = sum(v for k, v in by_name.items() if TILE_KERNEL in k)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "frames": n_frames, "window_s": window_s, "busy_s": busy_us * 1e-6,
        "span_device_ms": {k: v / per for k, v in span_dev.items()},
        "span_host_ms": {k: v / per for k, v in span_host.items()},
        "kernel_ms": {k: v / per for k, v in by_name.items()},
        "tile_kernel_ms": tile_us / per if tile_us > 0 else None,
        "breakdown": {"device_ops": [[k[:NAME_CHARS], v * 1e-6]
                                     for k, v in ops],
                      "idle_gaps": [list(g) for g in gaps[:10]]},
    }
