"""Timing for the tools. On the card a call's time is the device's: the
calls are captured into one CUDA graph and the graph's replay is timed
with CUDA events, so the host's cost of launching (tens of microseconds a
call through Python, more than these kernels run) stays out of it;
``eager_ms_per_call`` gives the time with it. On the CPU both read the host
clock around the plain versions, which is no device metric."""

from __future__ import annotations

import time

import torch


def _host_ms(fn, reps: int) -> float:
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def _event_ms(run, device: torch.device) -> float:
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    run()
    b.record()
    torch.cuda.synchronize(device)
    return a.elapsed_time(b)


def ms_per_call(fn, device: torch.device, reps: int = 20) -> float:
    """Mean device ms of ``fn()`` over ``reps`` calls replayed from a CUDA
    graph, after a warm-up call and a warm-up replay."""
    fn()
    if device.type != "cuda":
        return _host_ms(fn, reps)
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize(device)
    return _event_ms(graph.replay, device) / reps


def eager_ms_per_call(fn, device: torch.device, reps: int = 20) -> float:
    """Mean ms of ``fn()`` over ``reps`` calls launched one by one from the
    host, between two CUDA events: the kernel and the wrapper's launch."""
    fn()
    if device.type != "cuda":
        return _host_ms(fn, reps)
    torch.cuda.synchronize(device)

    def run():
        for _ in range(reps):
            fn()
    return _event_ms(run, device) / reps


def device_label(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu (plain versions; no device metric)")
