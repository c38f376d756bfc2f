"""The syncs and idle gaps by span (``benchmark/spans.py``) and its three
readers, on a synthetic profile of one frame: what each sync and gap is
attributed to, what ``sync_wait_ms`` and ``render_issue_ms`` leave out,
and that the program's spans leave ``trace.reduce``'s readings as they
were."""

from types import SimpleNamespace

import pytest
import torch

from benchmark import spans, trace
from benchmark.run import read_metric

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
TILE = "void pienerf::render_tiles_kernel_f32<false>"
NEW = ("host_syncs", "sync_wait_ms", "render_issue_ms")
CPU_ACT = torch.profiler.ProfilerActivity.CPU


def ev(name, s, t, dev=CPU, children=(), kernels=()):
    return SimpleNamespace(
        name=name, device_type=dev,
        time_range=SimpleNamespace(start=float(s), end=float(t)),
        cpu_children=list(children), kernels=list(kernels),
        cpu_time_total=float(t - s), duration=float(t - s))


def frame(program_spans=True, frame_copies=False):
    """One frame in microseconds: the pose upload's sync outside any span,
    the pack, the render (activity, prep, the tile launch, the scatter
    that waits for the tile kernel), the fetch, then the window's closing
    synchronize. Without ``program_spans`` the ops sit right under the
    ``bench.*`` ranges, as at a program with no spans; ``frame_copies``
    adds device-side copies of the ``frame.*`` spans."""
    k = {n: ev(n, s, t, CUDA) for n, s, t in (
        ("k_pack", 15, 25), ("k_act", 41, 49), ("k_prep", 71, 79),
        (TILE, 105, 180), ("k_scat", 185, 188), ("Memcpy DtoH", 205, 249))}
    op = {n: ev("aten::" + n, s, t, kernels=[k[kn]]) for n, s, t, kn in (
        ("pack", 12, 20, "k_pack"), ("act", 34, 44, "k_act"),
        ("prep", 63, 72, "k_prep"), ("scat", 182, 186, "k_scat"),
        ("fetch", 203, 252, "Memcpy DtoH"))}
    sync = [ev("cudaStreamSynchronize", s, t) for s, t in (
        (0, 5), (55, 58), (90, 95), (115, 180), (210, 250))]
    close = ev("cudaDeviceSynchronize", 270, 275)
    launch = ev("cudaLaunchKernel", 101, 104)
    out = list(k.values()) + list(op.values()) + sync + [close, launch]
    if program_spans:
        act = ev("frame.render.activity", 32, 59, children=[op["act"]])
        prep = ev("frame.render.prep", 61, 99, children=[op["prep"]])
        tl = ev("frame.tile_launch", 100, 110, kernels=[k[TILE]])
        scat = ev("frame.render.scatter", 111, 190, children=[op["scat"]])
        render = ev("frame.render", 31, 199,
                    children=[act, prep, tl, scat])
        fetch = ev("frame.fetch", 201, 259, children=[op["fetch"]])
        under = {"bench.ip_pack": [op["pack"]], "bench.render": [render],
                 "bench.fetch": [fetch]}
        out += [act, prep, tl, scat, render, fetch]
        if frame_copies:
            out += [ev(e.name, s, t, CUDA) for e, s, t in (
                (act, 41, 49), (prep, 71, 79), (tl, 105, 180),
                (scat, 185, 188), (render, 41, 188), (fetch, 205, 249))]
    else:
        under = {"bench.ip_pack": [op["pack"]],
                 "bench.render": [op["act"], op["prep"], op["scat"]],
                 "bench.fetch": [op["fetch"]]}
    for name, s, t, ds, dt in (("bench.ip_pack", 10, 30, 15, 25),
                               ("bench.render", 30, 200, 41, 188),
                               ("bench.fetch", 200, 260, 205, 249)):
        out += [ev(name, s, t, children=under[name]), ev(name, ds, dt, CUDA)]
    return out


class Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_the_programs_spans_leave_the_reduced_trace_as_it_was():
    without = trace.reduce(Prof(frame(program_spans=False)), 1, 1.0)
    assert trace.reduce(Prof(frame()), 1, 1.0) == without
    assert without["span_device_ms"]["bench.render"] == pytest.approx(
        (8 + 8 + 3) * 1e-3)


def test_device_copies_of_frame_spans_are_left_out():
    a = spans.reduce(frame(), 1)
    b = spans.reduce(frame(frame_copies=True), 1)
    assert a == b
    assert sum(a["idle_ms"].values()) == pytest.approx(
        (16 + 22 + 26 + 5 + 17) * 1e-3)


def test_syncs_and_gaps_go_to_the_innermost_span():
    r = spans.reduce(frame(), 1)
    assert r["syncs"] == {
        "between": [1, 5e-3], "frame.render.activity": [1, 3e-3],
        "frame.render.prep": [1, 5e-3], "frame.render.scatter": [1, 65e-3],
        "frame.fetch": [1, 40e-3]}
    assert r["idle_ms"] == pytest.approx({
        "frame.render.activity": 16e-3, "frame.render": (22 + 17) * 1e-3,
        "frame.render.prep": 26e-3, "frame.render.scatter": 5e-3})
    assert r["idle_gaps"][0] == ["frame.render.prep", pytest.approx(26e-6)]
    assert r["runtime"]["cudaLaunchKernel"] == [1, 3e-3]
    assert r["runtime"]["cudaDeviceSynchronize"] == [1, 5e-3]


def test_fetch_and_closing_syncs_are_left_out():
    r = spans.reduce(frame(), 2)         # the same events as two frames
    assert r["host_syncs"] == 5 / 2      # the closing synchronize left out
    assert r["sync_wait_ms"] == pytest.approx((5 + 3 + 5 + 65) * 1e-3 / 2)
    assert r["render_issue_ms"] == pytest.approx(
        ((199 - 31) - (3 + 5 + 65)) * 1e-3 / 2)


def test_without_program_spans_only_the_count_reads():
    r = spans.reduce(frame(program_spans=False), 1)
    assert r["host_syncs"] == 5
    assert r["sync_wait_ms"] is None and r["render_issue_ms"] is None
    assert r["syncs"]["bench.render"] == [3, 73e-3]


def test_readers_find_the_runs_profile_and_label_the_breakdown():
    events = frame()
    ctx = trace.reduce(Prof(events), 1, 1.0)
    assert {g[0] for g in ctx["breakdown"]["idle_gaps"]} == {
        "bench.render"}
    lengths = [g[1] for g in ctx["breakdown"]["idle_gaps"]]

    def run(ctx):
        prof = torch.profiler.profile(activities=[CPU_ACT])
        prof.events = lambda: events
        return {name: read_metric(name, ctx) for name in NEW}
    got = run(ctx)
    assert got == {"host_syncs": 5, "sync_wait_ms": pytest.approx(78e-3),
                   "render_issue_ms": pytest.approx(95e-3)}
    gaps = ctx["breakdown"]["idle_gaps"]
    assert [g[1] for g in gaps] == lengths
    assert gaps[0][0] == "frame.render.prep"
    assert {g[0] for g in gaps} == {"frame.render.activity",
                                    "frame.render", "frame.render.prep",
                                    "frame.render.scatter"}


@pytest.mark.parametrize("name", NEW)
def test_a_reader_reads_nothing_without_syncs(name):
    no_syncs = [e for e in frame() if "Synchronize" not in e.name]
    ctx = trace.reduce(Prof(no_syncs), 1, 1.0)
    prof = torch.profiler.profile(activities=[CPU_ACT])
    prof.events = lambda: no_syncs
    assert read_metric(name, ctx) is None
    assert read_metric(name, {}) is None
