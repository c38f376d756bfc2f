"""Live interactive viewer: stdlib HTTP + canvas streaming (port of
``pienerf_tpu.web_viewer``).

The counterpart of the reference's dearpygui viewers:

- Sim mode = NeRFSimGUI (reference nerf/gui.py:439-952): orbit/pan/zoom
  camera, ctrl+drag picks the nearest IP via depth-buffer unprojection and
  applies a spring force, wheel scales the force, space pauses, release on
  drag end, dynamic resolution targeting a frame budget, FPS readout,
  capacity-drop counters.
- Train mode = NeRFGUI (reference nerf/gui.py:61-438): train-while-render
  with a dynamic train-steps budget (500 ms per burst), 200 ms infer
  budget, spp accumulation with per-pass depth jitter when the camera is
  idle, loss/step readout, dataset-pose jumps (camera.pose_to_params).

A ThreadingHTTPServer serves one embedded HTML page and two endpoints
(``/frame.png``, ``/state``); the browser posts input events to
``/event``. The render loop runs on the calling thread, the only one that
touches the device; the HTTP threads handle bytes and JSON only. Frames go
out as PNG (``io.framesink.encode_png``, zlib level 1): the JAX package
serves JPEG through PIL, which the card's machine does not have.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from pienerf_tpu_torch.gui import DynamicResolution, InteractionState
from pienerf_tpu_torch.io.framesink import encode_png
from pienerf_tpu_torch.utils.camera import OrbitCamera
from pienerf_tpu_torch.utils.trace import FRAME_FETCH, span

PNG_LEVEL = 1       # zlib level of the served frames: the fastest


def _fetch_frame(out, n_tiles, T2):
    """One device-to-host copy a frame: image, depth, weight sum and the
    four counters packed on the device."""
    with span(FRAME_FETCH):
        packed = torch.cat([
            out["tiles_image"].reshape(-1).float(),
            out["tiles_depth"].reshape(-1).float(),
            out["tiles_ws"].reshape(-1).float(),
            torch.stack([out[k].reshape(()).float() for k in (
                "n_active", "dropped_beam", "dropped_window",
                "n_tile_overflow")]),
        ])
        host = packed.cpu().numpy()
    n_img = n_tiles * T2 * 3
    n_pix = n_tiles * T2
    img = host[:n_img].reshape(n_tiles, T2, 3)
    depth = host[n_img:n_img + n_pix].reshape(n_tiles, T2)
    ws = host[n_img + n_pix:n_img + 2 * n_pix].reshape(n_tiles, T2)
    counters = host[-4:].astype(np.int64)
    return img, depth, ws, counters


def encode_frame(img: np.ndarray) -> bytes:
    """A float image [H, W, 3] as served: quantised as the JAX package's
    ``encode_jpeg`` quantises, then PNG."""
    arr = np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8)
    return encode_png(arr, PNG_LEVEL)


_PAGE = """<!doctype html>
<html><head><title>pienerf-tpu viewer</title><style>
body{margin:0;background:#111;color:#ddd;font:13px monospace}
#hud{position:fixed;top:8px;left:8px;background:#000a;padding:6px 10px;
border-radius:4px;white-space:pre}
#help{position:fixed;bottom:8px;left:8px;color:#888}
canvas{display:block;margin:0 auto;image-rendering:auto}
</style></head><body>
<canvas id=c width=%W% height=%H%></canvas>
<div id=hud>connecting...</div>
<div id=help>drag: orbit | shift+drag: pan | wheel: zoom |
ctrl+drag: apply force | alt+wheel: force scale | space: pause | c: reset
camera | [ ]: dataset poses</div>
<script>
const c = document.getElementById('c'), ctx = c.getContext('2d');
const hud = document.getElementById('hud');
let seq = 0, dragging = false, mode = null, lx = 0, ly = 0;
function post(ev){fetch('/event', {method:'POST', body:JSON.stringify(ev)});}
function xy(e){const r = c.getBoundingClientRect();
  return [(e.clientX - r.left) / r.width, (e.clientY - r.top) / r.height];}
c.onmousedown = e => {dragging = true; [lx, ly] = [e.clientX, e.clientY];
  const [x, y] = xy(e);
  if (e.ctrlKey) {mode = 'force'; post({t: 'drag_start', x: x, y: y});}
  else if (e.shiftKey) mode = 'pan'; else mode = 'orbit';};
window.onmouseup = e => {if (mode === 'force') post({t: 'drag_end'});
  dragging = false; mode = null;};
window.onmousemove = e => {if (!dragging) return;
  const dx = e.clientX - lx, dy = e.clientY - ly;
  [lx, ly] = [e.clientX, e.clientY];
  if (mode === 'force') {const [x, y] = xy(e); post({t: 'drag', x: x, y: y});}
  else if (mode === 'pan') post({t: 'pan', dx: dx, dy: dy});
  else post({t: 'orbit', dx: dx, dy: dy});};
c.onwheel = e => {e.preventDefault();
  if (e.altKey) post({t: 'force_scale', d: e.deltaY > 0 ? -1 : 1});
  else post({t: 'zoom', d: e.deltaY > 0 ? -1 : 1});};
window.onkeydown = e => {
  if (e.code === 'Space') {e.preventDefault(); post({t: 'pause'});}
  else if (e.key === 'c') post({t: 'reset_cam'});
  else if (e.key === '[') post({t: 'pose_step', d: -1});
  else if (e.key === ']') post({t: 'pose_step', d: 1});};
async function frames(){
  while (true) {
    try {
      const r = await fetch('/frame.png?s=' + seq); seq += 1;
      const b = await r.blob();
      const img = await createImageBitmap(b);
      ctx.drawImage(img, 0, 0, c.width, c.height);
    } catch (err) {await new Promise(res => setTimeout(res, 200));}
  }
}
async function stats(){
  while (true) {
    try {const r = await fetch('/state'); hud.textContent = await r.text();}
    catch (err) {}
    await new Promise(res => setTimeout(res, 500));
  }
}
frames(); stats();
</script></body></html>
"""


class _Shared:
    """State shared between HTTP threads and the render loop."""

    def __init__(self):
        self.lock = threading.Lock()
        self.events: list = []
        self.frame_png: Optional[bytes] = None
        self.frame_cond = threading.Condition(self.lock)
        self.frame_seq = 0
        self.stats: dict = {}
        self.stop = False

    def push_event(self, ev: dict):
        with self.lock:
            self.events.append(ev)

    def drain_events(self) -> list:
        with self.lock:
            evs, self.events = self.events, []
            return evs

    def publish(self, png: bytes, stats: dict):
        with self.frame_cond:
            self.frame_png = png
            self.frame_seq += 1
            self.stats = stats
            self.frame_cond.notify_all()

    def wait_frame(self, last_seq: int, timeout: float = 2.0,
                   first_timeout: float = 300.0) -> bytes:
        """Long-poll for a frame newer than last_seq. The FIRST frame can
        take minutes (kernel build) — block until it exists."""
        deadline = time.monotonic() + timeout
        with self.frame_cond:
            while self.frame_png is None and not self.stop:
                if time.monotonic() > deadline + first_timeout:
                    return b""
                self.frame_cond.wait(1.0)
            while self.frame_seq <= last_seq and not self.stop:
                if time.monotonic() > deadline:
                    break
                self.frame_cond.wait(0.25)
            return self.frame_png or b""


def _make_handler(shared: _Shared, W: int, H: int):
    page = _PAGE.replace("%W%", str(W)).replace("%H%", str(H)).encode()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code, body, ctype):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/" or self.path.startswith("/index"):
                self._send(200, page, "text/html")
            elif self.path.startswith("/frame.png"):
                seq = 0
                if "s=" in self.path:
                    try:
                        seq = int(self.path.split("s=")[1].split("&")[0])
                    except ValueError:
                        pass
                body = shared.wait_frame(seq)
                self._send(200, body, "image/png")
            elif self.path.startswith("/state"):
                with shared.lock:
                    body = json.dumps(shared.stats, indent=0).encode()
                self._send(200, body, "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path.startswith("/event"):
                n = int(self.headers.get("Content-Length", 0))
                try:
                    ev = json.loads(self.rfile.read(n))
                    shared.push_event(ev)
                    self._send(200, b"ok", "text/plain")
                except (ValueError, KeyError):
                    self._send(400, b"bad event", "text/plain")
            elif self.path.startswith("/quit"):
                shared.stop = True
                self._send(200, b"bye", "text/plain")
            else:
                self._send(404, b"not found", "text/plain")

    return Handler


class ViewerServer:
    """HTTP front-end; `shared` carries events in and frames out."""

    def __init__(self, W: int, H: int, host: str = "127.0.0.1",
                 port: int = 7007):
        self.shared = _Shared()
        self.httpd = ThreadingHTTPServer(
            (host, port), _make_handler(self.shared, W, H))
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)

    def start(self):
        self._thread.start()
        return self

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


# ---------------------------------------------------------------------------
# sim-mode render loop (NeRFSimGUI parity)
# ---------------------------------------------------------------------------

def _scale_buckets(H, W, scales=(1.0, 0.5, 0.25)):
    """Quantized resolutions (16-divisible), one per dynamic-resolution
    step."""
    out = []
    for s in scales:
        h = max(16, int(H * s) // 16 * 16)
        w = max(16, int(W * s) // 16 * 16)
        out.append((s, h, w))
    return out


def run_sim_viewer(cfg, consts, state, ist, packed_w, cut_bounds=None,
                   port: int = 7007, max_frames: Optional[int] = None,
                   target_ms: float = 80.0, server: Optional[ViewerServer]
                   = None):
    """The coupled interactive loop behind the web page.

    Event -> InteractionState/OrbitCamera -> one fused frame
    (pipeline.interactive_frame_step; render_frame_fused on the current
    state when paused) -> PNG out. Dynamic resolution switches between
    scale buckets to hold `target_ms` (reference nerf/gui.py:606-611).
    `max_frames` bounds the loop for scripted runs; POST /quit ends it.
    Returns the last sim state.
    """
    from pienerf_tpu_torch.ops import beam_bend
    from pienerf_tpu_torch.render import interactive as ia
    from pienerf_tpu_torch.render import pipeline
    from pienerf_tpu_torch.sim import solver as sim

    dev = packed_w.device
    H = (cfg.H // 16) * 16
    W = (cfg.W // 16) * 16
    cam = OrbitCamera(W, H, r=cfg.radius, fovy=cfg.fovy)
    inter = InteractionState()
    dynres = DynamicResolution(target_ms=target_ms)
    buckets = _scale_buckets(H, W)

    srv = server or ViewerServer(W, H, port=port).start()
    shared = srv.shared
    print(f"[viewer] http://127.0.0.1:{srv.port}/  (sim mode)", flush=True)

    depth_img = None       # last frame's depth at last scale, for picking
    last_hw = (H, W)
    p_def_host = None
    fps_hist = []
    n_frames = 0
    t_frame = time.perf_counter()

    pending: list = []
    try:
        while not shared.stop:
            evs = pending + shared.drain_events()
            pending = []
            for ev in evs:
                t = ev.get("t")
                if t == "orbit":
                    cam.orbit(ev["dx"], ev["dy"])
                elif t == "pan":
                    cam.pan(ev["dx"], ev["dy"])
                elif t == "zoom":
                    cam.scale(ev["d"])
                elif t == "force_scale":
                    inter.wheel(ev["d"])
                elif t == "pause":
                    inter.toggle_pause()
                elif t == "reset_cam":
                    cam = OrbitCamera(W, H, r=cfg.radius, fovy=cfg.fovy)
                elif t in ("drag_start", "drag"):
                    if depth_img is None:
                        # no depth buffer yet (first frame still rendering):
                        # hold the event for the next loop pass
                        pending.append(ev)
                        continue
                    h, w = last_hw
                    px = min(max(ev["x"], 0.0), 1.0) * (w - 1)
                    py = min(max(ev["y"], 0.0), 1.0) * (h - 1)
                    d = float(depth_img[int(py), int(px)])
                    if d <= 0:
                        continue
                    scale_intr = (cam.intrinsics[0] * w / W,
                                  cam.intrinsics[1] * h / H, w / 2, h / 2)
                    if p_def_host is None:
                        p_def_host = sim.get_ip_info(
                            consts, state)[0].cpu().numpy()
                    if t == "drag_start":
                        inter.start_drag(px, py, d, cam.pose, scale_intr,
                                         p_def_host)
                    else:
                        inter.drag_to(px, py, d, cam.pose, scale_intr,
                                      p_def_host)
                elif t == "drag_end":
                    inter.release()

            # the resolution bucket closest to the controller's scale
            s_target = dynres.scale
            s, h, w = min(buckets, key=lambda b: abs(b[0] - s_target))
            intr = (cam.intrinsics[0] * w / W, cam.intrinsics[1] * h / H,
                    w / 2, h / 2)
            pose = torch.as_tensor(cam.pose, device=dev)

            if inter.paused:
                # render only: the current sim state
                p_def, F, dF = sim.get_ip_info(consts, state)
                pack = beam_bend.pack_ip_data_fast(
                    p_def, consts.ip_pos.float(), F, dF)
                out = ia.render_frame_fused(
                    ist, packed_w, pack, p_def, pose, intr, h, w, 1.0,
                    cut_bounds)
            else:
                fvec = torch.as_tensor(inter.force, dtype=torch.float32,
                                       device=dev)
                state, out = pipeline.interactive_frame_step(
                    ist, consts, state, packed_w, pose, intr, h, w, 1.0,
                    inter.force_ip, fvec, cut_bounds,
                    substeps=getattr(cfg, "sim_substeps", 1))
                p_def_host = None     # sim moved; re-fetch on next pick

            T2 = ist.tile * ist.tile
            timg, tdep, tws, counters = _fetch_frame(
                out, (h // ist.tile) * (w // ist.tile), T2)
            img = ia.tiles_to_image(timg, h, w, ist.tile)
            # tiles_depth accumulates sum(w * t); normalize by the weight
            # sum to get ray depth for unprojection-based picking
            dsum = ia.tiles_to_image(tdep, h, w, ist.tile)
            wsum = ia.tiles_to_image(tws, h, w, ist.tile)
            depth_img = np.where(wsum > 0.05, dsum / np.maximum(wsum, 1e-6),
                                 0.0)
            last_hw = (h, w)

            t_enc = time.perf_counter()
            png = encode_frame(img)
            now = time.perf_counter()
            encode_ms = (now - t_enc) * 1e3
            frame_ms = (now - t_frame) * 1e3
            t_frame = now
            dynres.scale = s           # controller tracks the applied bucket
            dynres.update(frame_ms)
            fps_hist.append(1e3 / max(frame_ms, 1e-3))
            fps_hist = fps_hist[-30:]

            shared.publish(png, {
                "mode": "sim",
                "frame": n_frames,
                "fps": round(float(np.mean(fps_hist)), 1),
                "frame_ms": round(frame_ms, 3),
                "encode_ms": round(encode_ms, 3),
                "res": f"{w}x{h} (x{s:g})",
                "paused": inter.paused,
                "force_ip": inter.force_ip,
                "force_scale": round(inter.force_scale, 3),
                "active_tiles": int(counters[0]),
                "drops": {
                    "beam": int(counters[1]),
                    "window": int(counters[2]),
                    "tiles": int(counters[3]),
                },
            })
            n_frames += 1
            if max_frames is not None and n_frames >= max_frames:
                break
    finally:
        if server is None:
            srv.close()
    return state


# ---------------------------------------------------------------------------
# train-mode render loop (NeRFGUI parity)
# ---------------------------------------------------------------------------

def run_train_viewer(trainer, train_loader, port: int = 7007,
                     max_frames: Optional[int] = None,
                     train_budget_ms: float = 500.0,
                     infer_budget_ms: float = 200.0,
                     max_spp: int = 64,
                     server: Optional[ViewerServer] = None):
    """Train-while-render (reference NeRFGUI, nerf/gui.py:61-438).

    Alternates training bursts (step count adapted to `train_budget_ms`,
    reference :116-120) with static fused renders (the tile kernel's
    static mode) at a dynamic resolution (`infer_budget_ms` target,
    :145-150). When the camera is idle the frame accumulates spp passes
    with per-pass depth jitter (:129-143); any input resets the
    accumulator. The weights are packed again only when training moved the
    step.
    """
    from pienerf_tpu_torch.kernels import field as field_kernel
    from pienerf_tpu_torch.ops import beam_bend
    from pienerf_tpu_torch.render import interactive as ia

    ia.check_fused_spec(trainer.spec)
    dev = trainer.device
    cfg = trainer.cfg
    H = (cfg.H // 16) * 16
    W = (cfg.W // 16) * 16
    cam = OrbitCamera(W, H, r=cfg.radius, fovy=cfg.fovy)
    dynres = DynamicResolution(target_ms=infer_budget_ms)
    buckets = _scale_buckets(H, W)

    srv = server or ViewerServer(W, H, port=port).start()
    shared = srv.shared
    print(f"[viewer] http://127.0.0.1:{srv.port}/  (train mode)",
          flush=True)

    bst = beam_bend.BeamBendSettings(num_seek_ip=1, max_iter_num=1)
    ist = ia.InteractiveSettings(
        spec=trainer.spec, bend=bst, tile=16, samples=cfg.render_samples,
        active_frac=1.0, tile_chunk=16, min_near=cfg.min_near,
        T_thresh=cfg.T_thresh, deformed=False, bound=cfg.bound)
    dummy_pack = torch.zeros((1, 16), device=dev)
    dummy_pdef = torch.zeros((1, 3), device=dev)

    train_steps = 16
    training = True
    spp = 0
    accum = None
    fps_hist = []
    pw = None
    pw_step = -1
    poses = getattr(train_loader, "poses", None)
    pose_idx = 0
    n_frames = 0
    loss_val = float("nan")

    try:
        while not shared.stop:
            moved = False
            for ev in shared.drain_events():
                t = ev.get("t")
                if t == "orbit":
                    cam.orbit(ev["dx"], ev["dy"])
                    moved = True
                elif t == "pan":
                    cam.pan(ev["dx"], ev["dy"])
                    moved = True
                elif t == "zoom":
                    cam.scale(ev["d"])
                    moved = True
                elif t == "pause":
                    training = not training
                elif t == "reset_cam":
                    cam = OrbitCamera(W, H, r=cfg.radius, fovy=cfg.fovy)
                    moved = True
                elif t == "pose_step" and poses is not None:
                    pose_idx = (pose_idx + int(ev["d"])) % len(poses)
                    cam.pose_to_params(np.asarray(poses[pose_idx]))
                    moved = True
            if moved:
                spp = 0
                accum = None

            if training:
                t0 = time.perf_counter()
                loss_val = trainer.train_iterations(train_loader, train_steps)
                dt_ms = (time.perf_counter() - t0) * 1e3
                # adapt the burst length toward the budget (reference
                # nerf/gui.py:116-120)
                per = dt_ms / max(train_steps, 1)
                train_steps = int(np.clip(train_budget_ms / max(per, 1e-3),
                                          1, 256))

            if spp < max_spp:
                s_target = dynres.scale if spp == 0 else 1.0
                s, h, w = min(buckets, key=lambda b: abs(b[0] - s_target))
                intr = (cam.intrinsics[0] * w / W,
                        cam.intrinsics[1] * h / H, w / 2, h / 2)
                # pack the MLP weights only when the params changed (one
                # training burst moves the step once)
                if pw is None or pw_step != trainer.global_step:
                    pw = field_kernel.pack_weights(trainer.state.ema_params,
                                                   trainer.spec, dev)
                    pw_step = trainer.global_step
                jit_t = 0.5 if spp == 0 else float(
                    np.random.default_rng(spp).uniform())
                t0 = time.perf_counter()
                out = ia.render_frame_fused(
                    ist, pw, dummy_pack, dummy_pdef,
                    torch.as_tensor(cam.pose, device=dev), intr, h, w, 1.0,
                    t_jitter=jit_t)
                img = ia.tiles_to_image(out["tiles_image"], h, w, ist.tile)
                frame_ms = (time.perf_counter() - t0) * 1e3
                dynres.scale = s
                dynres.update(frame_ms)
                if accum is None or accum.shape[:2] != img.shape[:2]:
                    accum = img
                    spp = 1
                else:
                    accum = (accum * spp + img) / (spp + 1)
                    spp += 1
                fps_hist.append(1e3 / max(frame_ms, 1e-3))
                fps_hist = fps_hist[-30:]

            shared.publish(encode_frame(accum), {
                "mode": "train",
                "frame": n_frames,
                "training": training,
                "step": int(trainer.global_step),
                "loss": round(float(loss_val), 5),
                "train_steps_per_burst": train_steps,
                "spp": spp,
                "fps": round(float(np.mean(fps_hist)), 1),
                "res": f"{accum.shape[1]}x{accum.shape[0]}",
                "pose_idx": pose_idx,
            })
            n_frames += 1
            if max_frames is not None and n_frames >= max_frames:
                break
    finally:
        if server is None:
            srv.close()
