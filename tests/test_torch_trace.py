"""The port's frame spans (``pienerf_tpu_torch/utils/trace.py``), CPU: with
no profiler the helper is one shared no-op and the frame records nothing;
under ``torch.profiler`` the coupled fused frame (deformed, and cut with
the cut split) and the viewer's fetch record exactly the documented spans,
nested as documented, and the frame's tensors are the same bits either
way."""

import os
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pienerf_tpu_torch import web_viewer
from pienerf_tpu_torch.kernels import field as tfk
from pienerf_tpu_torch.kernels import tile as ttk
from pienerf_tpu_torch.models import network as tnet
from pienerf_tpu_torch.ops import beam_bend as tbb
from pienerf_tpu_torch.render import interactive as tint
from pienerf_tpu_torch.render import pipeline as tpipe
from pienerf_tpu_torch.sim import solver as tsim
from pienerf_tpu_torch.utils import trace
from pienerf_tpu_torch.weights import field_from_numpy

CPU = torch.device("cpu")
PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "pienerf_tpu_torch")
H = W = 32
INTR = (38.4, 38.4, W / 2, H / 2)
CB = (0.0, 0.5, -0.5, 0.5, -0.5, 0.5)
MODES = ("deformed", "cut")
# (span, the frame.* span it sits in), in the order a frame opens them;
# the tile kernel's span opens only on CUDA
SPANS = {
    "deformed": [("frame.sim", None), ("frame.ip_info", None),
                 ("frame.ip_pack", None), ("frame.render", None),
                 ("frame.render.activity", "frame.render"),
                 ("frame.render.prep", "frame.render"),
                 ("frame.render.scatter", "frame.render"),
                 ("frame.fetch", None)],
}
SPANS["cut"] = (SPANS["deformed"][:6] + [("frame.render.prep",
                                          "frame.render")]
                + SPANS["deformed"][6:])


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread a test: the tensors here are small, and the test
    workers share the machine's cores, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    """A pinned sphere of 108 IPs at rest and a random 64-wide field."""
    c = np.arange(-0.3, 0.3 + 1e-6, 0.1)
    xx, yy, zz = np.meshgrid(c, c, c, indexing="ij")
    pts = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], 1)
    pts = pts[np.linalg.norm(pts, axis=1) <= 0.3]
    n = pts.shape[0]
    consts, state, _ = tsim.sim_init(
        pts, np.full(n, 0.1), np.full(n, 1e5), np.full(n, 1e5),
        pts[:, 2] < -0.2, dt=1e-2, iters=4, bbox=np.array([2.0, 2.0, 2.0]),
        kres=7, dx=0.1, gravity=(0.0, 0.0, 0.0), stiff=1e5,
        base=np.array([-1.0, -1.0, -1.0]), device=CPU)
    rng = np.random.RandomState(0)

    def lay(dims):
        return [rng.uniform(-1, 1, (dims[i], dims[i + 1])).astype(np.float32)
                * np.float32(np.sqrt(3.0 / dims[i]))
                for i in range(len(dims) - 1)]
    spec = tnet.make_spec(bound=1.0)
    params = {"sigma_net": lay([51, 64, 64, 64, 16]),
              "color_net": lay([31, 64, 64, 3])}
    pw = tfk.pack_weights(field_from_numpy(params, spec, CPU), spec, CPU)
    pose = torch.eye(4)
    pose[2, 3] = -2.5
    return dict(consts=consts, state=state, spec=spec, pw=pw, pose=pose)


def _frame(scene, mode):
    """One coupled fused frame (a force on IP 3, one sim step) and the
    viewer's fetch: (state, frame outputs, fetched arrays)."""
    st = tint.InteractiveSettings(
        spec=scene["spec"], bend=tbb.BeamBendSettings(
            num_seek_ip=1, max_iter_num=1, ip_dx=0.105, ips_per_tile=64),
        samples=16, tile_chunk=2, bend_window=16, active_frac=1.0,
        tighten_sampling=True, cut=mode == "cut")
    state, out = tpipe.interactive_frame_step(
        st, scene["consts"], scene["state"], scene["pw"], scene["pose"],
        INTR, H, W, 1.0, 3, torch.tensor([1e3, 0.0, 0.0]),
        torch.tensor(CB) if mode == "cut" else None)
    return state, out, web_viewer._fetch_frame(out, (H // 16) * (W // 16),
                                               256)


def test_without_a_profiler_a_span_is_the_shared_no_op():
    assert not torch.autograd._profiler_enabled()
    offs = {id(trace.span(name)) for name in trace.NAMES}
    assert len(offs) == 1
    with trace.span(trace.FRAME_RENDER) as v:
        assert v is None


@pytest.mark.parametrize("mode", MODES)
def test_frame_records_the_documented_spans(scene, mode, monkeypatch):
    passes = []
    plain = ttk.render_tiles

    def counted(*a, **kw):
        passes.append(torch.autograd._profiler_enabled())
        return plain(*a, **kw)
    monkeypatch.setattr(tint.tile_kernel, "render_tiles", counted)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _frame(scene, mode)
    got = []
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if not e.name.startswith("frame."):
            continue
        assert e.name in trace.NAMES, e.name
        assert not e.is_user_annotation, e.name  # no device-side copy
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith("frame."):
            parent = parent.cpu_parent
        got.append((e.name, parent.name if parent else None))
    assert got == SPANS[mode]
    assert passes == [True] * (2 if mode == "cut" else 1)


@pytest.mark.parametrize("mode", MODES)
def test_frame_is_the_same_bits_with_spans_on_and_off(scene, mode):
    off = _frame(scene, mode)
    with profile(activities=[ProfilerActivity.CPU]):
        on = _frame(scene, mode)
    assert torch.equal(off[0].ddof, on[0].ddof)
    assert off[1].keys() == on[1].keys()
    for k in off[1]:
        assert torch.equal(off[1][k], on[1][k]), k
    for a, b in zip(off[2], on[2]):
        assert np.array_equal(a, b)
    assert int(on[1]["n_active"]) > 0


def test_only_the_helper_opens_a_profiler_range():
    """Every span the package opens is ``trace.span`` of a constant of the
    module; nothing else records a range."""
    opened = set()
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py") or f == "trace.py":
                continue
            src = open(os.path.join(dirpath, f)).read()
            assert "record_function" not in src, f
            assert "_RecordFunctionFast" not in src, f
            opened |= set(re.findall(r"\bspan\((\w+)\)", src))
    assert opened == {n for n in dir(trace) if n.startswith("FRAME_")}
    assert {getattr(trace, n) for n in opened} == set(trace.NAMES)
