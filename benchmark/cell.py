"""One benchmark cell: its configuration, traffic and limits, found by
name, the inputs the benchmark makes from the seed, and the program under
test set up and driven as the live viewer's paused branch drives it.

Everything a cell needs beyond this code is data: ``configs/<config>.json``
(scene, simulator, spring, field, render settings), ``traffic/<traffic>.json``
(the set-up drag, the camera orbit, the correctness sample) and
``limits/<workload>.json`` (the correctness limits). The program is
``pienerf_tpu_torch``; this module imports it only inside ``Program``.

The field's architecture is the configuration's ``field.backbone``:
``mlp`` (where absent) is the bias-free Fourier MLP, its weights the
committed checkpoint's (``checkpoint``, ``width``, ``n_freqs``);
``hashgrid`` is torch-ngp's hash-grid field (``grid``: num_levels,
level_dim, base_resolution, log2_hashmap_size, desired_resolution;
``width``, ``sigma_layers``, ``color_layers``), its weights fitted to the
committed field as ``fit`` says (``reference/fit.py``) and cached under
``.cache/fit``.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import subprocess
import sys
import time
from contextlib import nullcontext
from typing import Dict, List, NamedTuple, Optional

import numpy as np

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(BENCH_DIR)
SIM_CACHE = os.path.join(BENCH_DIR, ".cache", "sim_init")
FIT_CACHE = os.path.join(BENCH_DIR, ".cache", "fit")
FIT_CODE = ("fit.py", "hashgrid.py", "render.py")     # under reference/


def load(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` under the benchmark's folder."""
    with open(os.path.join(BENCH_DIR, kind, name + ".json")) as f:
        return json.load(f)


def benchmark_spec() -> dict:
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(name: str, spec: Optional[dict] = None) -> dict:
    spec = spec or benchmark_spec()
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _merge(base: dict, over: Optional[dict]) -> dict:
    """``base`` with ``over``'s keys replaced, one level into groups."""
    out = json.loads(json.dumps(base))
    for k, v in (over or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k].update(v)
        else:
            out[k] = v
    return out


class Inputs(NamedTuple):
    """What the benchmark makes and hands to both sides."""
    cfg: dict
    traffic: dict
    points: np.ndarray          # [n, 3] physics points
    pin: np.ndarray             # [n] bool
    sim_kw: dict                # sim_init's scalars (no device)
    spring: dict                # radius, gain, clamp, rate, phase (rad)
    layers: Dict[str, list]     # {"sigma_net", "color_net"}: [in, out] f32,
                                # and "encoder": [table [rows, C]] (hashgrid)
    poses: np.ndarray           # [n_poses, 4, 4] camera-to-world, in order
    intr: tuple                 # fx, fy, cx, cy
    cut_bounds: Optional[list]  # [6] in cut mode


def _rng(seed: int, stream: int) -> np.random.Generator:
    """An independent generator per use of the seed (any size of seed)."""
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), stream])


def _points(scene: dict, cut_bounds) -> tuple:
    r0, dx = scene["radius"], scene["lattice"]
    c = np.arange(-r0, r0 + 1e-6, dx)
    xx, yy, zz = np.meshgrid(c, c, c, indexing="ij")
    pts = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], 1)
    pts = pts[np.linalg.norm(pts, axis=1) <= r0]
    if scene.get("inside_cut_box"):
        box = np.asarray(cut_bounds)
        pts = pts[np.all((pts > box[0::2]) & (pts < box[1::2]), axis=1)]
    if "pin_below_z" in scene:
        pin = pts[:, 2] < scene["pin_below_z"]
    else:
        pin = pts[:, 2] < np.quantile(pts[:, 2], scene["pin_quantile_z"])
    return pts, pin


def _checkpoint(path: str) -> Dict[str, list]:
    """A committed checkpoint's 64-wide EMA Fourier MLP."""
    with np.load(os.path.join(REPO, path)) as z:
        return {k: [np.asarray(z[f"ema_params/{k}.{i}"], np.float32)
                    for i in range(n)]
                for k, n in (("sigma_net", 4), ("color_net", 3))}


def _layers(cfg: dict) -> Dict[str, list]:
    """The field's weights. Backbone mlp: the committed checkpoint's EMA
    field; at the 128-wide student's width it is embedded there (per axis
    the encoding rows [x, sin 0..7, cos 0..7] at their places in [x, sin
    0..9, cos 0..9]) and every weight the embedding leaves zero is drawn
    from the configuration's ``fill_seed`` at ``fill_scale`` of the
    Kaiming-uniform bound. Backbone hashgrid: ``fitted_field``."""
    fc = cfg["field"]
    if fc.get("backbone", "mlp") == "hashgrid":
        return fitted_field(fc, cfg["render"]["bound"])
    net = _checkpoint(fc["checkpoint"])
    if fc["width"] == 64:
        return net
    wd, nf = fc["width"], fc["n_freqs"]
    per_axis = 2 * nf + 1
    rows = np.concatenate([per_axis * a + np.r_[0, 1:9, nf + 1:nf + 9]
                           for a in range(3)])

    def pad(w, shape):
        out = np.zeros(shape, np.float32)
        out[:w.shape[0], :w.shape[1]] = w
        return out

    s0 = np.zeros((3 * per_axis, wd), np.float32)
    s0[rows, :64] = net["sigma_net"][0]
    emb = {"sigma_net": [s0] + [pad(w, (wd, wd if i < 2 else 16)) for i, w
                                in enumerate(net["sigma_net"][1:])],
           "color_net": [pad(net["color_net"][0], (31, wd)),
                         pad(net["color_net"][1], (wd, wd)),
                         pad(net["color_net"][2], (wd, 3))]}
    rng = np.random.default_rng(fc["fill_seed"])
    return {k: [np.where(w != 0.0, w, fc["fill_scale"] * np.sqrt(
        3.0 / w.shape[0]) * rng.uniform(-1.0, 1.0, w.shape)).astype(
            np.float32) for w in ws] for k, ws in emb.items()}


def _sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _fit_key(fc: dict, bound: float, kind: str) -> str:
    """The fit's cache key: the field entry, the bound, the device's name,
    the torch version, and the SHA-256 of the teacher and of the code that
    fits (``FIT_CODE``)."""
    import torch

    code = {f: _sha256(os.path.join(BENCH_DIR, "reference", f))
            for f in FIT_CODE}
    return hashlib.sha256(json.dumps(
        {"field": fc, "bound": bound, "device": kind,
         "torch": torch.__version__, "code": code,
         "teacher": _sha256(os.path.join(REPO, fc["fit"]["teacher"]))},
        sort_keys=True).encode()).hexdigest()[:32]


def fitted_field(fc: dict, bound: float, cache_dir: Optional[str] = None
                 ) -> Dict[str, list]:
    """The hash-grid field ``fc`` describes, fitted to its teacher
    (``fit.teacher``, a committed checkpoint) on the card where there is
    one, else on the CPU. Cached under ``_fit_key``: only the first run
    of a checkout pays for the fit. The fit runs in a child process that
    sets cuBLAS's deterministic workspace before its first product, as
    ``torch.use_deterministic_algorithms`` asks; the child prints the
    fit's seconds and the table's SHA-256."""
    import torch

    device = "cuda" if torch.cuda.is_available() else "cpu"
    kind = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    cache_dir = cache_dir or FIT_CACHE
    path = os.path.join(cache_dir, _fit_key(fc, bound, kind) + ".npz")
    if not os.path.exists(path):
        os.makedirs(cache_dir, exist_ok=True)
        subprocess.run(
            [sys.executable, "-m", "benchmark.cell", "fit",
             json.dumps({"field": fc, "bound": bound, "device": device}),
             path], cwd=REPO, check=True,
            env={**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"})
    with np.load(path) as z:
        return {k: [z[f"{k}.{i}"] for i in range(n)] for k, n in (
            ("encoder", 1), ("sigma_net", fc["sigma_layers"]),
            ("color_net", fc["color_layers"]))}


def _fit_main(spec_json: str, path: str) -> None:
    """The child of ``fitted_field``: fit, write ``path``, print the
    fit's seconds, its device memory peak and the table's SHA-256 on
    standard error."""
    import torch

    from benchmark.reference import fit, hashgrid

    spec = json.loads(spec_json)
    fc, dev = spec["field"], torch.device(spec["device"])
    teacher = _checkpoint(fc["fit"]["teacher"])
    t0 = time.perf_counter()
    out = fit.fit((teacher["sigma_net"], teacher["color_net"]),
                  spec["bound"], hashgrid.layout(**fc["grid"]), fc["width"],
                  fc["sigma_layers"], fc["color_layers"], fc["fit"], dev)
    arrays = {f"{k}.{i}": w.cpu().numpy() for k, ws in out.items()
              for i, w in enumerate(ws)}
    fit_s = time.perf_counter() - t0
    part = path[:-len(".npz")] + ".part.npz"
    with open(part, "wb") as f:
        np.savez(f, **arrays)
    os.replace(part, path)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    print(json.dumps({"fit_s": fit_s, "device": str(dev),
                      "memory_peak_bytes": peak, "table_sha256":
                      hashlib.sha256(arrays["encoder.0"].tobytes())
                      .hexdigest()}), file=sys.stderr, flush=True)


def orbit_poses(distance: float, elevation_deg: float, n: int,
                step_deg: float, start: int) -> np.ndarray:
    """``n`` camera-to-world poses ``step_deg`` apart in azimuth about the
    origin at ``distance`` and ``elevation_deg``, from pose ``start`` of
    the loop on. Camera axes: x right, y down, z forward (pose 0 at
    elevation 0 is the identity rotation at (0, 0, -distance))."""
    out = np.zeros((n, 4, 4), np.float32)
    el = math.radians(elevation_deg)
    for i in range(n):
        az = math.radians(step_deg * ((start + i) % n))
        fwd = np.array([math.sin(az) * math.cos(el), math.sin(el),
                        math.cos(az) * math.cos(el)])
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        out[i, :3, 0], out[i, :3, 1], out[i, :3, 2] = right, down, fwd
        out[i, :3, 3] = -distance * fwd
        out[i, 3, 3] = 1.0
    return out


def make_inputs(config: str, traffic: str, seed: int,
                overrides: Optional[dict] = None) -> Inputs:
    """The cell's inputs. The seed picks the orbit's first pose (and the
    run's correctness sample), so every seed renders the same frames of
    the same scene in another order: the work a run measures does not
    depend on it. ``overrides`` replaces groups of the configuration (the
    CPU tests shrink a cell with it)."""
    cfg = _merge(load("configs", config), overrides)
    tr = load("traffic", traffic)
    rd = cfg["render"]
    cut_bounds = rd.get("cut_bounds")
    pts, pin = _points(cfg["scene"], cut_bounds)
    sim = cfg["sim"]
    sim_kw = dict(dt=sim["dt"], iters=sim["iters"],
                  bbox=np.asarray(sim["bbox"], np.float64), kres=sim["kres"],
                  dx=cfg["scene"]["lattice"], gravity=tuple(sim["gravity"]),
                  stiff=sim["stiff"], base=np.asarray(sim["base"], np.float64))
    orbit = tr["orbit"]
    start = int(_rng(seed, 2).integers(0, orbit["poses"]))
    poses = orbit_poses(cfg["camera"]["distance"], orbit["elevation_deg"],
                        orbit["poses"], orbit["step_deg"], start)
    f = rd["focal"]
    intr = (f, f, rd["W"] / 2.0, rd["H"] / 2.0)
    return Inputs(cfg=cfg, traffic=tr, points=pts, pin=pin, sim_kw=sim_kw,
                  spring=cfg["spring"], layers=_layers(cfg), poses=poses,
                  intr=intr, cut_bounds=cut_bounds)


def material(inp: Inputs) -> tuple:
    """(mass, mu, lam) per point."""
    n = inp.points.shape[0]
    m = inp.cfg["scene"]["material"]
    return (np.full(n, m["mass"]), np.full(n, m["mu"]), np.full(n, m["lam"]))


class Program:
    """The program under test, set up as the viewer sets it up: the
    simulator's constants (``sim_init_cached``), the set-up drag, the
    packed field and the fused frame's settings. ``frame`` is one pass of
    the viewer's paused branch (``web_viewer.py``, ``inter.paused``):
    ``get_ip_info`` and ``pack_ip_data_fast`` on the current state,
    ``render_frame_fused``, and ``_fetch_frame``'s one device-to-host copy,
    the viewer's sync. ``dtype`` overrides the configuration's field dtype
    (the control's bf16 reading)."""

    def __init__(self, inp: Inputs, device, dtype: Optional[str] = None,
                 cache_dir: str = SIM_CACHE):
        import torch

        from pienerf_tpu_torch.kernels import field as field_kernel
        from pienerf_tpu_torch.models import hash_encoder, network
        from pienerf_tpu_torch.ops import beam_bend
        from pienerf_tpu_torch.render import interactive
        from pienerf_tpu_torch.sim import solver as sim
        from pienerf_tpu_torch import web_viewer
        from benchmark.reference.sim import spring_force

        self.torch, self.sim, self.bb = torch, sim, beam_bend
        self.ia, self.viewer = interactive, web_viewer
        self.dev = device
        cfg, rd = inp.cfg, inp.cfg["render"]
        mass, mu, lam = material(inp)
        consts, state, _ = sim.sim_init_cached(
            inp.points, mass, mu, lam, inp.pin, cache_dir=cache_dir,
            device=device, **inp.sim_kw)
        vid = int(torch.argmax(consts.ip_pos[:, 2]))
        for fi in range(inp.traffic["drag_frames"]):
            f = spring_force(consts.ip_pos, consts.IP_kernel, consts.IP_Nx,
                             state.ddof, vid, fi, inp.spring)
            state = sim.update_force(consts, state, vid, f)
            state = sim.sim_step(consts, state)
        self.consts, self.state = consts, state
        fc = cfg["field"]
        if fc.get("backbone", "mlp") == "hashgrid":
            spec = network.make_spec(
                bound=rd["bound"], compute_dtype=dtype or cfg["dtype"],
                backbone="hashgrid", hidden_dim=fc["width"],
                hidden_dim_color=fc["width"], num_layers=fc["sigma_layers"],
                num_layers_color=fc["color_layers"])
            spec = spec._replace(grid=hash_encoder.make_spec(**fc["grid"]))
        else:
            spec = network.make_spec(
                bound=rd["bound"], compute_dtype=dtype or cfg["dtype"],
                n_freqs=fc["n_freqs"], hidden_dim=fc["width"],
                hidden_dim_color=fc["width"])
        self.pw = field_kernel.pack_weights(inp.layers, spec, device)
        bst = beam_bend.BeamBendSettings(
            num_seek_ip=rd["num_seek"], max_iter_num=1,
            ip_dx=rd["ip_dx_factor"] * cfg["scene"]["lattice"],
            ips_per_tile=rd["ips_per_tile"])
        self.ist = interactive.InteractiveSettings(
            spec=spec, bend=bst, tile=16, samples=rd["K"],
            active_frac=rd["active_frac"], tile_chunk=rd["tile_chunk"],
            min_near=rd["min_near"], T_thresh=rd["T_thresh"],
            cut=rd["cut"], bound=rd["bound"],
            tighten_sampling=rd["tighten"], bend_window=rd["bend_window"],
            cut_static_frac=rd["cut_static_frac"])
        self.cut_bounds = (None if inp.cut_bounds is None else torch.tensor(
            inp.cut_bounds, dtype=torch.float32, device=device))
        self.H, self.W, self.intr = rd["H"], rd["W"], inp.intr
        self.n_tiles = (self.H // 16) * (self.W // 16)
        self.poses, self.pack = inp.poses, None

    def frame(self, k: int, span=None):
        """One paused-viewer frame at pose ``k``; ``span(name)`` wraps the
        stages (a profiler range, or nothing). Returns (image [n_tiles,
        256, 3], counters [4], host seconds from the call until the fetch
        was issued)."""
        span = span or (lambda name: nullcontext())
        t0 = time.perf_counter()
        pose = self.torch.as_tensor(self.poses[k], device=self.dev)
        with span("bench.ip_pack"):
            p_def, F, dF = self.sim.get_ip_info(self.consts, self.state)
            self.pack = self.bb.pack_ip_data_fast(
                p_def, self.consts.ip_pos.float(), F, dF)
        with span("bench.render"):
            out = self.ia.render_frame_fused(
                self.ist, self.pw, self.pack, p_def, pose, self.intr, self.H,
                self.W, 1.0, self.cut_bounds)
        host_s = time.perf_counter() - t0
        with span("bench.fetch"):
            img, _, _, counters = self.viewer._fetch_frame(
                out, self.n_tiles, 256)
        return img, counters, host_s


class Reservoir:
    """A uniform sample of ``k`` of the frames offered, drawn from the
    seed (reservoir sampling): holds references, copies nothing."""

    def __init__(self, k: int, seed: int):
        self.k, self.items, self.seen, self.rng = k, [], 0, _rng(seed, 4)

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def per_layer_names(spec: dict, cell: str) -> List[str]:
    """The per-layer metrics this cell reports: every one without a
    ``workloads`` key, and those that list it."""
    return [m["name"] for m in spec["per_layer"]
            if "workloads" not in m or cell in m["workloads"]]


if __name__ == "__main__":
    if sys.argv[1:2] != ["fit"] or len(sys.argv) != 4:
        sys.exit("usage: python -m benchmark.cell fit <field JSON> <out.npz>")
    _fit_main(sys.argv[2], sys.argv[3])
