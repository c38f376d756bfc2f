"""The port's live viewer (pienerf_tpu_torch/web_viewer.py, gui.py,
main_viewer.py) on the CPU: the GUI logic against the JAX package's
functions, exact; the PNG frame codec; the sim and train loops driven over
HTTP, every served frame held bit for bit to the same calls made directly;
main_viewer in both modes. The loops run on the test's own thread, the only
one that renders; a client thread speaks HTTP."""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from pienerf_tpu import gui as jgui
from pienerf_tpu_torch import gui as tgui
from pienerf_tpu_torch import main_viewer, web_viewer
from pienerf_tpu_torch.config import PieNeRFConfig as TCfg
from pienerf_tpu_torch.data import synthetic
from pienerf_tpu_torch.io.checkpoint import load_native
from pienerf_tpu_torch.io.framesink import decode_png, encode_png
from pienerf_tpu_torch.io.ply import write_ply
from pienerf_tpu_torch.kernels import field as field_kernel
from pienerf_tpu_torch.models import network
from pienerf_tpu_torch.ops import beam_bend
from pienerf_tpu_torch.render import interactive, pipeline
from pienerf_tpu_torch.sim import solver as sim
from pienerf_tpu_torch.train.trainer import Trainer
from pienerf_tpu_torch.weights import field_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "runs/quality_mlp_800/checkpoints/ngp_ep0015.npz")
TIMEOUT = 120


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread a test: the tensors here are small, and the test
    workers share the machine's cores, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- GUI logic, against JAX's functions ------------------------------------

def _pose(rs):
    q, _ = np.linalg.qr(rs.randn(3, 3))
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = q
    pose[:3, 3] = rs.randn(3) * 2.0
    return pose


def _case_screen_to_world(mod, rs):
    return [mod.screen_to_world(rs.uniform(0, 100), rs.uniform(0, 100),
                                rs.uniform(0.5, 4.0), _pose(rs),
                                tuple(rs.uniform(20, 120, 4)))
            for _ in range(20)]


def _case_pick_ip(mod, rs):
    ips = rs.uniform(-1, 1, (50, 3))
    return [mod.pick_ip(rs.uniform(-1.3, 1.3, 3), ips,
                        max_dist=rs.uniform(0.05, 0.3)) for _ in range(40)]


def _case_spring_force(mod, rs):
    return [mod.spring_force(rs.randn(3), rs.randn(3) * rs.choice(
        [1e-3, 1.0, 10.0]), scale=rs.uniform(0.1, 3.0)) for _ in range(30)]


def _case_dynamic_resolution(mod, rs):
    ctrl = mod.DynamicResolution(target_ms=80.0)
    return [ctrl.update(rs.uniform(5, 600) * ctrl.scale ** 2)
            for _ in range(40)]


def _case_interaction_state(mod, rs):
    st = mod.InteractionState()
    ips = rs.uniform(-0.3, 0.3, (30, 3))
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (0, 0, -2.0)
    intr = (100.0, 100.0, 50.0, 50.0)
    out = []
    for _ in range(10):
        st.toggle_pause()
        px, py = rs.uniform(30, 70, 2)
        out.append(st.start_drag(px, py, rs.uniform(1.7, 2.3), pose, intr,
                                 ips))
        out.append(st.drag_to(px + rs.uniform(-10, 10), py,
                              rs.uniform(1.7, 2.3), pose, intr, ips))
        st.wheel(rs.uniform(-3, 3))
        out.append((st.paused, st.force_ip, st.force_scale,
                    st.force.copy()))
        if rs.rand() < 0.5:
            st.release()
    return out


GUI_CASES = {"screen_to_world": _case_screen_to_world,
             "pick_ip": _case_pick_ip, "spring_force": _case_spring_force,
             "dynamic_resolution": _case_dynamic_resolution,
             "interaction_state": _case_interaction_state}


def _flat(x):
    if isinstance(x, (list, tuple)):
        return [y for v in x for y in _flat(v)]
    return [np.asarray(x)]


@pytest.mark.parametrize("case", sorted(GUI_CASES))
def test_gui_logic_equals_jax(case):
    """tests/test_gui_logic.py's five cases on seeded inputs: the port's
    copy gives exactly what pienerf_tpu.gui gives."""
    got = _flat(GUI_CASES[case](tgui, np.random.RandomState(7)))
    want = _flat(GUI_CASES[case](jgui, np.random.RandomState(7)))
    assert len(got) == len(want) > 10
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    if case == "pick_ip":
        assert {-1} < set(int(v) for v in got)     # misses and hits


# ---- the frame codec -------------------------------------------------------

@pytest.mark.parametrize("channels", [1, 3, 4])
def test_encode_png_decodes_to_the_frame(channels):
    """encode_png, at the viewer's zlib level and the default, decodes to
    the quantised frame bit for bit through the port's decoder and, where
    PIL is installed, through PIL; the viewer quantises as encode_jpeg
    does (clip(img * 255, 0, 255) to uint8)."""
    rs = np.random.RandomState(channels)
    shape = (37, 53) if channels == 1 else (37, 53, channels)
    img = rs.uniform(-0.2, 1.2, shape).astype(np.float32)
    q = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    for data in (encode_png(q, web_viewer.PNG_LEVEL), encode_png(q)):
        np.testing.assert_array_equal(decode_png(data), q)
        try:
            from PIL import Image
        except ImportError:
            continue
        import io
        np.testing.assert_array_equal(np.asarray(Image.open(
            io.BytesIO(data))), q)
    if channels == 3:
        np.testing.assert_array_equal(
            decode_png(web_viewer.encode_frame(img)), q)


# ---- the HTTP loops ---------------------------------------------------------

def _get(url, timeout=TIMEOUT):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read(), r.headers.get("Content-Type")


def _post(url, obj, timeout=10):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def _state(base):
    return json.loads(_get(base + "/state")[0] or b"{}")


def _wait(cond, what):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < TIMEOUT, what
        time.sleep(0.02)


class _Record:
    """Wraps module functions: each call's inputs (tensors cloned) and
    output, in call order; a call made inside another recorded call is
    not recorded."""

    def __init__(self, monkeypatch, targets):
        self.calls, self._depth = [], 0
        for mod, name in targets:
            monkeypatch.setattr(mod, name, self._wrap(name,
                                                      getattr(mod, name)))

    @staticmethod
    def _clone(v):
        if isinstance(v, torch.Tensor):
            return v.clone()
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            return type(v)(*[_Record._clone(x) for x in v])
        return v

    def _wrap(self, name, fn):
        def wrapped(*args, **kw):
            outer = self._depth == 0
            if outer:
                entry = (name, fn, [self._clone(a) for a in args],
                         {k: self._clone(v) for k, v in kw.items()})
            self._depth += 1
            try:
                out = fn(*args, **kw)
            finally:
                self._depth -= 1
            if outer:
                self.calls.append(entry)
            return out
        return wrapped


def _published(monkeypatch, shared, hold=None):
    """Record every published (png, stats); after publishing frame
    ``hold[0]``, wait until ``hold[1]`` events are queued."""
    out = []
    publish = shared.publish

    def rec(png, stats):
        publish(png, stats)
        out.append((png, stats))
        if hold is not None and stats["frame"] == hold[0]:
            _wait(lambda: len(shared.events) >= hold[1],
                  "client events never arrived")

    monkeypatch.setattr(shared, "publish", rec)
    return out


def _quantised(tiles, h, w):
    img = interactive.tiles_to_image(tiles, h, w, 16)
    return np.clip(img * 255.0, 0, 255).astype(np.uint8)


class _Cfg:
    H = W = 64
    radius = 2.5
    fovy = 60.0


def _sphere_scene():
    """A pinned-free sphere of IPs inside the committed trained field."""
    r0, dx = 0.45, 0.15
    c = np.arange(-r0, r0 + 1e-6, dx)
    xx, yy, zz = np.meshgrid(c, c, c, indexing="ij")
    pts = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], 1)
    pts = pts[np.linalg.norm(pts, axis=1) <= r0]
    n = pts.shape[0]
    consts, state, _ = sim.sim_init(
        pts, np.full(n, 0.1), np.full(n, 1e5), np.full(n, 1e5),
        np.zeros(n, bool), dt=1e-2, iters=3, bbox=np.array([2.0] * 3),
        kres=4, dx=dx, gravity=(0.0, 0.0, 0.0), stiff=1e5,
        base=np.array([-1.0] * 3))
    spec = network.make_spec(bound=1.0)
    field = field_from_numpy(load_native(CKPT)[0]["ema_params"], spec, "cpu")
    pw = field_kernel.pack_weights(field, spec, "cpu")
    bst = beam_bend.BeamBendSettings(num_seek_ip=2, max_iter_num=1,
                                     ip_dx=1.05 * dx, ips_per_tile=64)
    ist = interactive.InteractiveSettings(
        spec=spec, bend=bst, tile=16, samples=16, active_frac=1.0,
        tile_chunk=4, min_near=0.05)
    return consts, state, ist, pw


def test_sim_viewer_serves_the_direct_frames(monkeypatch):
    """Queued before the loop starts: orbit, drag_start, drag (the drags
    wait for the first depth buffer). The loop's frames 0-2 step the sim
    (1-2 under the picked IP's spring force); after frame 2 a client posts
    drag_end and pause, so frame 3 on are render-only, until the client
    posts /quit. Every frame served over HTTP is one the loop published,
    and every published PNG decodes to the quantised image of its call
    replayed directly, bit for bit. /state carries the pick, the pause and
    the drop counters."""
    consts, state, ist, pw = _sphere_scene()
    rec = _Record(monkeypatch, [(pipeline, "interactive_frame_step"),
                                (interactive, "render_frame_fused")])
    server = web_viewer.ViewerServer(64, 64, port=0).start()
    base = f"http://127.0.0.1:{server.port}"
    published = _published(monkeypatch, server.shared, hold=(2, 2))
    served, errors = [], []
    page, ctype = _get(base + "/")
    assert b"<canvas" in page and b"/frame.png" in page
    assert ctype == "text/html"
    for ev in ({"t": "orbit", "dx": 30, "dy": 5},
               {"t": "drag_start", "x": 0.5, "y": 0.5},
               {"t": "drag", "x": 0.56, "y": 0.5}):
        _post(base + "/event", ev)

    def client():
        try:
            body, ctype = _get(base + "/frame.png?s=0")
            served.append(body)
            assert ctype == "image/png"
            _wait(lambda: _state(base).get("frame", -1) >= 2, "frame 2")
            _post(base + "/event", {"t": "drag_end"})
            _post(base + "/event", {"t": "pause"})
            _wait(lambda: _state(base).get("paused"), "pause")
            served.append(_get(base + "/frame.png?s=0")[0])
            _post(base + "/quit", {})
        except Exception as e:       # reported by the main thread
            errors.append(e)
            server.shared.stop = True

    th = threading.Thread(target=client, daemon=True)
    th.start()
    try:
        web_viewer.run_sim_viewer(_Cfg(), consts, state, ist, pw,
                                  max_frames=40, server=server)
        th.join(timeout=TIMEOUT)
        assert not th.is_alive() and not errors, errors
        served.append(_get(base + "/frame.png?s=0")[0])
        st = _state(base)
    finally:
        server.close()

    assert server.shared.stop and 4 <= len(published) < 40
    pngs = [p for p, _ in published]
    assert all(s in pngs for s in served) and served[-1] == pngs[-1]
    stats = [s for _, s in published]
    assert [s["frame"] for s in stats] == list(range(len(published)))
    assert stats[0]["force_ip"] == -1 and not stats[0]["paused"]
    assert stats[1]["force_ip"] >= 0 and stats[2]["force_ip"] >= 0
    assert all(s["paused"] and s["force_ip"] == -1 for s in stats[3:])
    assert st == stats[-1] and set(st["drops"]) == {"beam", "window",
                                                   "tiles"}
    assert len(rec.calls) == len(published)
    names = [c[0] for c in rec.calls]
    assert names[:3] == ["interactive_frame_step"] * 3
    assert set(names[3:]) == {"render_frame_fused"}
    assert rec.calls[0][2][9] == -1 and rec.calls[1][2][9] >= 0
    assert float(rec.calls[1][2][10].abs().max()) > 0
    for (name, fn, args, kw), png in zip(rec.calls, pngs):
        out = fn(*args, **kw)
        if name == "interactive_frame_step":
            out = out[1]
        np.testing.assert_array_equal(
            decode_png(png), _quantised(out["tiles_image"], args[6],
                                        args[7]))
    assert decode_png(pngs[0]).std() > 0      # the sphere is in view


def _train_setup(tmp_path, n_views=3, hw=32):
    cfg = TCfg(bound=1.0, dt_gamma=0.0, iters=50, num_rays=128,
               max_steps=64, train_max_samples=16, backbone="mlp",
               workspace=str(tmp_path / "ws")).finalize()
    cfg.H = cfg.W = hw
    cfg.radius = 2.5
    cfg.fovy = 60.0
    trainer = Trainer("ngp", cfg, use_checkpoint="scratch", device="cpu")
    ds = synthetic.make_dataset(n_views=n_views, H=hw, W=hw, seed=0)
    return trainer, ds


def test_train_viewer_repacks_only_on_a_new_step(tmp_path, monkeypatch):
    """Train-while-render over HTTP: a dataset-pose jump queued first,
    training in frames 0-1, then a client's pause, so frames 2-5
    accumulate spp passes of one set of weights. The weights are packed
    once per new global step and never for a pure spp frame (the JAX
    test's pin, tests/test_viewer.py); every published PNG is the
    accumulation of the direct renders, bit for bit."""
    trainer, ds = _train_setup(tmp_path)
    packs = []
    pack = field_kernel.pack_weights

    def counting_pack(*a, **kw):
        packs.append(trainer.global_step)
        return pack(*a, **kw)

    monkeypatch.setattr(field_kernel, "pack_weights", counting_pack)
    rec = _Record(monkeypatch, [(interactive, "render_frame_fused")])
    steps_at_render = []
    rff = interactive.render_frame_fused

    def render(*a, **kw):
        steps_at_render.append(trainer.global_step)
        return rff(*a, **kw)

    monkeypatch.setattr(interactive, "render_frame_fused", render)
    server = web_viewer.ViewerServer(32, 32, port=0).start()
    base = f"http://127.0.0.1:{server.port}"
    published = _published(monkeypatch, server.shared, hold=(1, 1))
    _post(base + "/event", {"t": "pose_step", "d": 1})
    errors = []

    def client():
        try:
            _wait(lambda: _state(base).get("frame", -1) >= 1, "frame 1")
            _post(base + "/event", {"t": "pause"})
        except Exception as e:
            errors.append(e)

    th = threading.Thread(target=client, daemon=True)
    th.start()
    try:
        web_viewer.run_train_viewer(trainer, ds, max_frames=6,
                                    train_budget_ms=50.0, server=server)
        th.join(timeout=TIMEOUT)
        assert not th.is_alive() and not errors, errors
        body, ctype = _get(base + "/frame.png?s=0")
        st = _state(base)
    finally:
        server.close()

    assert ctype == "image/png" and body == published[-1][0]
    stats = [s for _, s in published]
    assert [s["training"] for s in stats] == [True, True] + [False] * 4
    assert [s["spp"] for s in stats] == [1, 2, 3, 4, 5, 6]
    assert st["mode"] == "train" and st["step"] == trainer.global_step > 0
    assert st["pose_idx"] == 1
    # one pack per new step: frames 0 and 1 trained, 2-5 did not
    assert packs == sorted(set(steps_at_render)) and len(packs) == 2
    accum = None
    for i, ((_, fn, args, kw), (png, _)) in enumerate(zip(rec.calls,
                                                         published)):
        out = fn(*args, **kw)
        img = interactive.tiles_to_image(out["tiles_image"], args[6],
                                         args[7], 16)
        accum = img if accum is None else (accum * i + img) / (i + 1)
        np.testing.assert_array_equal(
            decode_png(png), np.clip(accum * 255.0, 0, 255).astype(
                np.uint8))


def test_page_state_event_and_quit():
    """The HTTP surface alone: the page, an empty /state before the first
    frame, a bad event refused, unknown paths 404, /quit sets stop."""
    server = web_viewer.ViewerServer(32, 32, port=0).start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        assert b"pienerf-tpu viewer" in _get(base + "/")[0]
        assert _state(base) == {}
        _post(base + "/event", {"t": "orbit", "dx": 1, "dy": 2})
        assert server.shared.drain_events() == [{"t": "orbit", "dx": 1,
                                                 "dy": 2}]
        req = urllib.request.Request(base + "/event", data=b"{not json",
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError, match="400"):
            urllib.request.urlopen(req, timeout=10)
        with pytest.raises(urllib.error.HTTPError, match="404"):
            _get(base + "/nothing")
        _post(base + "/quit", {})
        assert server.shared.stop
    finally:
        server.close()


# ---- main_viewer -----------------------------------------------------------

def test_main_viewer_sim_mode(tmp_path, monkeypatch, capsys):
    """main_viewer --mode sim on the CPU: the workspace's checkpoint, the
    annotated assets/<exp_name>.ply, --frames 2; --max_iter_num other than
    1 is refused, as is a missing PLY."""
    ws = tmp_path / "ws"
    os.makedirs(ws / "checkpoints")
    for ext in ("", ".json"):
        with open(CKPT + ext, "rb") as f, open(
                ws / "checkpoints" / f"ngp_ep0015.npz{ext}", "wb") as g:
            g.write(f.read())
    os.makedirs(tmp_path / "assets")
    g = np.linspace(0.3, 0.7, 3) - 0.5
    p = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    n = len(p)
    write_ply(str(tmp_path / "assets" / "cube.ply"), p,
              vp=np.full(n, 1e-3), pin=(p[:, 1] > 0.15).astype(float),
              lam=np.full(n, 1e4), mu=np.full(n, 1e4), mass=np.full(n, 0.1))
    monkeypatch.chdir(tmp_path)
    args = ["--device", "cpu", "--workspace", str(ws), "--exp_name", "cube",
            "--backbone", "mlp", "--sim_dx", "0.2", "--bound", "0.5",
            "--W", "32", "--H", "32", "--radius", "2.5", "--kres", "4",
            "--port", "0", "--sim_cache", "0", "--frames", "2"]
    with pytest.raises(SystemExit, match="max_iter_num"):
        main_viewer.main(args)
    args += ["--max_iter_num", "1", "--num_seek_IP", "3"]
    main_viewer.main(args)
    out = capsys.readouterr().out
    assert "(sim mode)" in out and "kernel launches: {}" in out
    with pytest.raises(SystemExit, match="PLY not found"):
        main_viewer.main(args[:5] + ["nothing"] + args[6:])


def test_main_viewer_train_mode(tmp_path, capsys):
    """main_viewer --mode train on a blender-layout dataset: two frames of
    train-while-render, the trainer stepping; the hashgrid is refused."""
    data = str(tmp_path / "data")
    hw = 32
    f = 0.9 * hw
    intr = (f, f, hw / 2.0, hw / 2.0)
    poses = synthetic.orbit_poses(2, seed=0)
    imgs = [synthetic.render_gt(q, intr, hw, hw, alpha=True) for q in poses]
    synthetic.write_blender(data, {"train": (poses, imgs)}, intr, hw, hw)
    args = ["--device", "cpu", "--mode", "train", "--path", data,
            "--workspace", str(tmp_path / "ws"), "--bound", "1.0",
            "--scale", "1.0", "--dt_gamma", "0", "--num_rays", "64",
            "--train_max_samples", "16", "--H", "32", "--W", "32",
            "--port", "0", "--frames", "2"]
    with pytest.raises(SystemExit, match="mlp backbone"):
        main_viewer.main(args + ["--backbone", "hashgrid"])
    main_viewer.main(args + ["--backbone", "mlp"])
    assert "(train mode)" in capsys.readouterr().out
    assert os.path.isdir(tmp_path / "ws" / "checkpoints")
