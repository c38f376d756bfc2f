"""Chip smoke for the PyTorch / CUDA port: builds the kernels, holds each
against its plain PyTorch version on the card (both kernels at both widths:
the 64-wide net and the 128-wide distilled student), and drives the port's
entry points at full width on the trained checkpoint:

  main path 1, the coupled interactive frame of bench.py (3,053 IPs,
    800x800, K=128), checked against the committed exact-bending oracle and
    the port's own oracle; then the same path with the checkpoint embedded
    in the 128-wide student's architecture (the same field, so the same
    frame);
  main path 2, the cut-mode frame at the trex operating point of
    tools/trex_proxy.py (1008x752, num_seek 1, T_thresh 5e-2, the IPs inside
    the cut box): the static background cached once, then the bend class
    every frame, checked against the port's cut-mode oracle; then its
    128-wide run;
  the Newton frame (interactive.render_frame at max_iter_num 100, the
    field kernel), checked against the port's exact oracle;
  main_gui as a user runs it: fused, --cut, at its default Newton depth,
    and on the 128-wide checkpoint.

    python3 chip_smoke.py

Needs one CUDA card and nvcc (sm_90a). Every phase prints one JSON line;
any failure raises, so the script exits non-zero. The last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "runs/quality_mlp_800/checkpoints/ngp_ep0015.npz")
ORACLE = os.path.join(ROOT, "runs/bench_oracle_800_K128_3053ip.npz")

# published H100 SXM peaks (dense): f32 on the CUDA cores, bf16 on the
# tensor cores, HBM3 bandwidth; they assume the 700 W power limit
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
# MACs per point by kernel width: the 64-wide net (sigma 3264+4096+4096+
# 1024, color 1984+4096+192) and the 128-wide student (sigma 8064+16384+
# 16384+2048, color 3968+16384+384)
FIELD_MACS = {64: 18752, 128: 63616}
FIELD_IO = 40                     # bytes per point: x, d in; sigma, rgb out
WIDE = dict(hidden_dim=128, hidden_dim_color=128, n_freqs=10)
# bf16 kernel-vs-plain limits, set between the sound kernel's reading and
# the control's (the f32 kernel, which skips the bf16 rounding, read against
# the bf16 plain version); the control must fail them. On an H100 the
# kernels read 0.0 / 0.0 and 97.6 dB, the controls 0.040 / 0.18 and 67.1 dB.
FIELD_BF16_TOL = (1e-2, 2e-2)     # rgb max abs, sigma max rel
TILE_BF16_DB = 80.0               # PSNR of the rgb rows
# the static march bends nothing, so its bf16 kernel and plain version
# encode identical sample positions and differ only in summation order: on
# an H100 the kernel read 120 dB (the PSNR floor of a 1e-12 MSE) and the
# control 79.6 dB, too near 80 to show the check can fail; the limit sits
# between the two
TILE_BF16_DB_STATIC = 100.0
# the trex proxy's cut box (tools/trex_proxy.py:42) and the resolution of
# the cut-mode fidelity frame
CUT_BOUNDS = [-0.30, 0.75, -0.75, 0.60, -0.45, 0.75]
CUT_FID_RES = (1008, 752)


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean device ms per call over ``reps`` calls, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def frame_profile(prof, n_frames: int, ms_per_frame: float) -> dict:
    """Per-frame times from a torch.profiler run of ``n_frames`` chained
    frames: host ms and device ms of pipeline.py's ``frame.*`` ranges, the
    device's busy ms (union of its kernel and copy spans), the tile
    kernel's device ms, and the idle share of the unprofiled frame. A
    range's device ms counts the kernels of the torch ops inside it; the
    profiler links no op to the tile kernel's ctypes launch, so the tile
    kernel is counted on its own and not in ``frame.render``."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    host, dev_ms, spans, tile_us = {}, {}, [], 0.0
    for e in prof.events():
        if e.name.startswith("frame."):
            if e.device_type != cuda:
                host[e.name] = host.get(e.name, 0.0) + e.cpu_time_total
                dev_ms[e.name] = dev_ms.get(e.name, 0.0) + e.device_time_total
        elif e.device_type == cuda:
            spans.append((e.time_range.start, e.time_range.end))
            if "render_tiles_kernel" in e.name:
                tile_us += e.time_range.elapsed_us()
    busy, end = 0.0, float("-inf")
    for s, t in sorted(spans):
        if t > end:
            busy += t - max(s, end)
            end = t
    per = 1e3 * n_frames
    busy_ms = busy / per
    return dict(frames=n_frames,
                stage_host_ms={k: v / per for k, v in host.items()},
                stage_device_ms={k: v / per for k, v in dev_ms.items()},
                device_busy_ms=busy_ms, device_events=len(spans),
                tile_kernel_device_ms=tile_us / per,
                ms_per_frame_unprofiled=ms_per_frame,
                device_idle_share=1.0 - busy_ms / ms_per_frame)


def ptxas_report(log: str) -> list:
    """Per kernel entry of an ``nvcc -Xptxas -v`` log: a readable name,
    registers, stack and spill bytes, and the dynamic shared memory its
    launch asks for (at Wn = 64 in the bending modes)."""
    rows, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
            wd = 128 if "ILi128E" in name or "wide" in name else 64
            b = re.search(r"ILb(\d)E(?:Lb(\d)ELb(\d)E)?", name)
            bf16 = bool(b and b.group(1) == "1")
            if "render_tiles" in name:
                mode = ("static" if b.group(2) == "0" else
                        "cut" if b.group(3) == "1" else "deformed")
                label = f"tile {mode}"
            else:
                mode, label = None, "field"
            # mirrors field_mlp.cuh mlp_smem_floats (+ the Wn x 16 window)
            floats = (18816 + 2 * 64 * 256 if wd == 64
                      else 128 * 128 + 2 * 128 * 128)
            floats += 64 * 16 if mode in ("deformed", "cut") else 0
            cur = {"kernel": f"{label} w{wd} {'bf16' if bf16 else 'f32'}",
                   "dynamic_smem_bytes": floats * 4}
            rows.append(cur)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and cur is not None:
            cur.update(stack=int(m[1]), spill_stores=int(m[2]),
                       spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            cur["registers"] = int(m[1])
    return rows


def embed_wide(params: dict) -> dict:
    """The 64-wide, n_freqs-8 params tree embedded in the 128-wide,
    n_freqs-10 student's architecture: the same field, zero weights
    elsewhere. Per axis the encoding rows [x, sin 0..7, cos 0..7] move to
    their places in the 21-row block [x, sin 0..9, cos 0..9]."""
    rows = np.concatenate([21 * a + np.r_[0, 1:9, 11:19] for a in range(3)])
    s, c = params["sigma_net"], params["color_net"]

    def pad(w, shape):
        out = np.zeros(shape, np.float32)
        out[:w.shape[0], :w.shape[1]] = w
        return out

    s0 = np.zeros((63, 128), np.float32)
    s0[rows, :64] = s[0]
    return {"sigma_net": [s0, pad(s[1], (128, 128)), pad(s[2], (128, 128)),
                          pad(s[3], (128, 16))],
            "color_net": [pad(c[0], (31, 128)), pad(c[1], (128, 128)),
                          pad(c[2], (128, 3))]}


def fill_wide(params: dict, seed: int) -> dict:
    """embed_wide(params) with every weight it leaves zero drawn at random
    from a seed, at a tenth of the Kaiming-uniform bound: every block of
    the [7, 128, 128] pack is nonzero, and the field stays close to the
    trained one, so that the bf16 limits and their controls of the 64-wide
    checks carry over (a purely random field renders so smoothly that the
    bf16 control reads 96 dB and passes the 80 dB limit)."""
    rng = np.random.RandomState(seed)
    return {k: [np.where(w != 0.0, w, 0.1 * np.sqrt(3.0 / w.shape[0])
                         * rng.uniform(-1.0, 1.0, w.shape)).astype(np.float32)
                for w in ws] for k, ws in embed_wide(params).items()}


def field_check(phase, fk, pw, specs, bf16_tol, rng) -> dict:
    """The field kernel against its plain version at N = 2^20 and a ragged
    N, f32 then bf16, one line each. f32: summation order only, 1e-5;
    bf16: ``bf16_tol`` (rgb max abs, sigma max rel) sits below the
    control, a kernel that skips the bf16 rounding (the f32 kernel read
    against the bf16 plain version), which must fail it. Returns the
    N = 2^20 rows by dtype, with ms, plain ms and the bound."""
    import torch
    dev = pw.device
    wd = pw.shape[-1]

    def err(a, b):
        """(rgb max abs, sigma max rel) between two (sigma, rgb) pairs."""
        return (float((a[1] - b[1]).abs().max()),
                float(((a[0] - b[0]).abs() / b[0].abs().clamp(min=1e-6))
                      .max()))

    rows = {}
    for n in (1 << 20, (1 << 20) - 12345):
        x = torch.as_tensor(rng.uniform(-1, 1, (3, n)).astype(np.float32),
                            device=dev)
        d = torch.as_tensor(rng.randn(3, n).astype(np.float32), device=dev)
        d = (d / d.norm(dim=0, keepdim=True)).contiguous()
        k32 = fk.field_eval(pw, specs[0], x, d)
        for spec in specs:
            k = fk.field_eval(pw, spec, x, d)
            p = fk.field_eval_plain(pw, spec, x, d)
            torch.cuda.synchronize()
            rgb_err, sig_rel = err(k, p)
            f32 = spec.compute_dtype == "float32"
            tol = (1e-5, 1e-5) if f32 else bf16_tol
            row = dict(n=n, width=wd, dtype=spec.compute_dtype,
                       rgb_max_abs=rgb_err, sigma_max_rel=sig_rel, tol=tol)
            if not f32:
                row["control_rgb_max_abs"], row["control_sigma_max_rel"] = \
                    err(k32, p)
            if n == 1 << 20:
                row["ms"] = cuda_ms(lambda: fk.field_eval(pw, spec, x, d),
                                    10)
                row["plain_ms"] = cuda_ms(
                    lambda: fk.field_eval_plain(pw, spec, x, d), 3)
                flops = 2.0 * FIELD_MACS[wd] * n
                row["bound_ms"] = max(
                    flops / (PEAK_F32 if f32 else PEAK_BF16),
                    (FIELD_IO * n + pw.numel() * 4) / PEAK_BYTES) * 1e3
                rows[spec.compute_dtype] = row
            emit(phase, **row)
            assert rgb_err <= tol[0] and sig_rel <= tol[1], row
            # the check must be able to fail the control
            assert f32 or (row["control_rgb_max_abs"] > tol[0]
                           or row["control_sigma_max_rel"] > tol[1]), row
    return rows


def psnr(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return float(10.0 * np.log10(1.0 / max(mse, 1e-12)))


def tile_check(phase, tk, specs, pw, args, kw, limit_db=TILE_BF16_DB,
               pw_f32=None) -> dict:
    """The tile kernel against its plain version on one pass's inputs,
    f32 then bf16, one line each: f32 within 1e-4 with the dropped row
    equal, on ``pw_f32`` (default ``pw``); bf16 on ``pw`` at ``limit_db``
    or more, and the control (the f32 kernel on ``pw``, which skips the
    bf16 rounding) below it. The wide checks hold the f32 rule on the
    embedded checkpoint, whose zero blocks make the plain version's
    summation order immaterial: with every block filled, one f32 rounding
    difference can flip a ray's T_thresh test and move it by a sample's
    weight, which the f32 line reports as ``filled_*`` without asserting.
    Returns the bf16 row with the kernel's ms, the plain version's ms and
    the bound."""
    import torch
    spec32, spec16 = specs
    stats = {}

    def f32_pair(weights):
        ko = tk.render_tiles(spec32, weights, *args, **kw)
        po = tk.render_tiles_plain(spec32, weights, *args, **kw)
        torch.cuda.synchronize()
        return ko, po, (ko[:, 0:5] - po[:, 0:5]).abs()

    ko, po, err = f32_pair(pw if pw_f32 is None else pw_f32)
    drop_eq = bool(torch.equal(ko[:, 5], po[:, 5]))
    row = dict(width=pw.shape[-1], dtype="float32",
               max_abs_err=float(err.max()), dropped_equal=drop_eq,
               dropped=float(ko[:, 5, 0].sum()))
    ko32 = ko
    if pw_f32 is not None:
        ko32, _, err_f = f32_pair(pw)
        row.update(filled_max_abs_err=float(err_f.max()),
                   filled_rays_over_1e4=int((err_f > 1e-4).any(1).sum()))
    emit(phase, **row)
    assert row["max_abs_err"] <= 1e-4 and drop_eq, row
    ko = tk.render_tiles(spec16, pw, *args, **kw)
    po = tk.render_tiles_plain(spec16, pw, *args, **kw, stats=stats)
    torch.cuda.synchronize()
    po_rgb = po[:, 0:3].cpu().numpy()
    row = dict(width=pw.shape[-1], dtype="bfloat16",
               max_abs_err=float((ko[:, 0:5] - po[:, 0:5]).abs().max()),
               dropped_equal=bool(torch.equal(ko[:, 5], po[:, 5])),
               psnr_rgb=psnr(ko[:, 0:3].cpu().numpy(), po_rgb),
               control_psnr_rgb=psnr(ko32[:, 0:3].cpu().numpy(), po_rgb),
               limit_db=limit_db)
    row["ms"] = cuda_ms(lambda: tk.render_tiles(spec16, pw, *args, **kw), 5)
    row["plain_ms"] = cuda_ms(lambda: tk.render_tiles_plain(
        spec16, pw, *args, **kw), 1)
    # the reference's operations per executed sample: the field MLP; in
    # the bending modes one squared distance per window row (8 flops),
    # then num_seek min passes over the window (tile_kernel.py:406-420).
    # The static march reads no candidates.
    samples = stats["segments"] * tk.T2 * kw["Ks"]
    op_s = 2.0 * FIELD_MACS[pw.shape[-1]] * samples / PEAK_BF16
    read = args
    if kw["deformed"]:
        op_s += (8.0 + kw["num_seek"]) * kw["Wn"] * samples / PEAK_F32
    else:
        read = (args[0], args[2], args[3])   # tile_sc, params, dirs
    nbytes = sum(t.numel() * t.element_size()
                 for t in read) + pw.numel() * 4 + ko.numel() * 4
    row["executed_segments"] = stats["segments"]
    row["bound_ms"] = max(op_s, nbytes / PEAK_BYTES) * 1e3
    row["bound_by"] = ("operations" if op_s > nbytes / PEAK_BYTES
                       else "bytes")
    bf16_row = row
    emit(phase, **row)
    assert bf16_row["control_psnr_rgb"] < limit_db, bf16_row
    assert bf16_row["psnr_rgb"] >= limit_db, bf16_row
    return bf16_row


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(1)

    import pienerf_tpu_torch  # noqa: F401  (precision policy)
    from pienerf_tpu_torch.io.checkpoint import load_native, save_native
    from pienerf_tpu_torch.kernels import _build
    from pienerf_tpu_torch.kernels import field as fk
    from pienerf_tpu_torch.kernels import tile as tk
    from pienerf_tpu_torch.models import network
    from pienerf_tpu_torch.ops import beam_bend
    from pienerf_tpu_torch.render import interactive, pipeline
    from pienerf_tpu_torch.sim import solver as sim
    from pienerf_tpu_torch.weights import field_from_numpy

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    def reset_counts():
        fk.field_eval.launches = dict.fromkeys(fk.WIDTHS, 0)
        tk.render_tiles.launches = dict.fromkeys(tk.render_tiles.launches, 0)

    def read_counts():
        out = {f"field_w{w}": k for w, k in fk.field_eval.launches.items()}
        out.update({f"tile_{m}_w{w}": k
                    for (m, w), k in tk.render_tiles.launches.items()})
        return out

    def only(**launched):
        """The counts of a run that launched these kernels and no other."""
        return {**dict.fromkeys(read_counts(), 0), **launched}

    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, name=kind,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # ---- build: one nvcc per source, all started together
    t0 = time.perf_counter()
    rep = _build.build()
    emit("build", seconds=time.perf_counter() - t0,
         ptxas={k: ptxas_report(v["log"]) for k, v in rep.items()})

    # ---- the trained field (bench.py adopts the arch from the weights)
    tree, _ = load_native(CKPT)
    params = tree["ema_params"]
    nf = (params["sigma_net"][0].shape[0] // 3 - 1) // 2
    spec16 = network.make_spec(bound=1.0, compute_dtype="bfloat16",
                               n_freqs=nf,
                               num_layers=len(params["sigma_net"]))
    spec32 = spec16._replace(compute_dtype="float32")
    field = field_from_numpy(params, spec32, dev)
    pw = fk.pack_weights(field, spec32, dev)
    # the 128-wide student: the committed checkpoint embedded in its
    # architecture, written and read back as main_gui reads a workspace
    # (the same field, so the same frames), and for the kernel checks the
    # same with every block of the [7, 128, 128] pack nonzero (fill_wide)
    spec16_w = spec16._replace(**WIDE)
    spec32_w = spec16_w._replace(compute_dtype="float32")
    wide_ws = os.path.join(ROOT, "build", "smoke_wide_ws")
    wide_ck = os.path.join(wide_ws, "checkpoints", "ngp_ep0015.npz")
    os.makedirs(os.path.dirname(wide_ck), exist_ok=True)
    save_native(wide_ck, {"ema_params": embed_wide(params)},
                extra={"epoch": 15})
    pw_w = fk.pack_weights(field_from_numpy(load_native(wide_ck)[0][
        "ema_params"], spec32_w, dev), spec32_w, dev)
    pw_fill = fk.pack_weights(field_from_numpy(fill_wide(params, 0),
                                               spec32_w, dev), spec32_w, dev)

    # ---- the field kernel against its plain version, both widths
    rng = np.random.RandomState(0)
    field_rows = {
        64: field_check("field_kernel", fk, pw, (spec32, spec16),
                        FIELD_BF16_TOL, rng),
        128: field_check("field_kernel_w128", fk, pw_fill,
                         (spec32_w, spec16_w), FIELD_BF16_TOL, rng)}

    # ---- the bench scene (bench.py:45-147)
    H = W = 800
    r0, dx = 0.45, 0.05
    c = np.arange(-r0, r0 + 1e-6, dx)
    xx, yy, zz = np.meshgrid(c, c, c, indexing="ij")
    pts = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], 1)
    pts = pts[np.linalg.norm(pts, axis=1) <= r0]
    n = pts.shape[0]
    t0 = time.perf_counter()
    consts, state_rest, aux = sim.sim_init(
        pts, np.full(n, 0.1), np.full(n, 1e5), np.full(n, 1e5),
        pts[:, 2] < -0.3, dt=1e-2, iters=10, bbox=np.array([2.0, 2.0, 2.0]),
        kres=7, dx=dx, gravity=(0.0, 0.0, 0.0), stiff=1e5,
        base=np.array([-1.0, -1.0, -1.0]), device=dev)
    sim_init_s = time.perf_counter() - t0
    bst = beam_bend.BeamBendSettings(num_seek_ip=3, max_iter_num=1,
                                     ip_dx=1.05 * dx, ips_per_tile=256)
    ist = interactive.InteractiveSettings(
        spec=spec16, bend=bst, tile=16, samples=128, active_frac=0.5,
        tile_chunk=32, min_near=0.05, tighten_sampling=True)
    intr = (1.2 * H, 1.2 * H, W / 2, H / 2)
    pose_np = np.eye(4, dtype=np.float32)
    pose_np[:3, 3] = (0, 0, -2.5)
    pose = torch.as_tensor(pose_np, device=dev)
    vid = int(np.argmax(consts.ip_pos[:, 2].cpu().numpy()))
    vid_kernel = consts.IP_kernel[vid]
    vid_nx = consts.IP_Nx[vid]
    vid_rest = consts.ip_pos[vid]

    def frame(st, fi, settings, weights):
        # the GUI's spring drag toward a target orbiting the IP (bench.py)
        p_ip = vid_rest + torch.einsum("ia,iad->d", vid_nx,
                                       st.ddof[vid_kernel])
        ang = torch.tensor(0.25 * fi, device=dev)
        target = vid_rest + 0.25 * torch.stack(
            [torch.cos(ang), torch.sin(ang), torch.zeros((), device=dev)])
        f = torch.clamp(1e5 * (target - p_ip), -5e5, 5e5)
        return pipeline.interactive_frame_step(
            settings, consts, st, weights, pose, intr, H, W, 1.0, vid, f)

    from torch.profiler import ProfilerActivity, profile

    def chained(phase, settings, weights, tile_key):
        """Main path 1 with these settings and weights: 20 chained frames
        with the launch counts read around them, then 3 x 10 timed frames
        and 5 under torch.profiler (where a frame's time goes: the stages
        are pipeline.py's named ranges). Returns (frame-0 state, frame-0
        counters, launches)."""
        reset_counts()
        state = state_rest
        for fi in range(20):
            state, out = frame(state, fi, settings, weights)
            if fi == 0:
                state0 = state
                counters0 = {k: int(out[k]) for k in
                             ("dropped_beam", "dropped_window",
                              "n_tile_overflow", "n_active")}
            assert bool(torch.isfinite(out["tiles_image"]).all()), fi
            assert bool(torch.isfinite(state.ddof).all()), fi
            assert int(out["n_active"]) > 0, fi
        torch.cuda.synchronize()
        launches = read_counts()
        assert launches == only(**{tile_key: 20}), launches
        reps = []
        fi = 20
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                state, out = frame(state, fi, settings, weights)
                fi += 1
            torch.cuda.synchronize()
            reps.append((time.perf_counter() - t0) / 10 * 1e3)
        assert bool(torch.isfinite(state.ddof).all())
        emit(phase, n_ip=aux["n_ip"], n_k=aux["n_k"], sim_init_s=sim_init_s,
             width=weights.shape[-1], frame0=counters0, launches=launches,
             ms_per_frame_reps=reps,
             ms_per_frame_median=float(np.median(reps)))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                state, out = frame(state, fi, settings, weights)
                fi += 1
            torch.cuda.synchronize()
        emit(f"{phase}_profile",
             **frame_profile(prof, 5, float(np.median(reps))))
        return state0, counters0, launches

    # ---- main path 1
    state0, drops0, frame_launches = chained("frame", ist, pw,
                                             "tile_deformed_w64")

    # ---- tile kernel against its plain version at frame 0's state, both
    # widths (the inputs do not depend on the width)
    p_def, F, dF = sim.get_ip_info(consts, state0)
    pack = beam_bend.pack_ip_data_fast(p_def, consts.ip_pos.float(), F, dF)
    (_, o, bbmin, bbmax, act_ids, act_mask, _, _) = interactive.active_tiles(
        ist, p_def, pose, intr, H, W, ist.tile_chunk)
    args, kw, _ = interactive.tile_kernel_inputs(
        ist, pack, p_def, o, pose, intr, H, W, act_ids, act_mask, bbmin,
        bbmax)
    tile_row = tile_check("tile_kernel", tk, (spec32, spec16), pw, args, kw)
    tile_row_w = tile_check("tile_kernel_w128", tk, (spec32_w, spec16_w),
                            pw_fill, args, kw, pw_f32=pw_w)

    # ---- main path 1, fidelity (bench.py:222-274): f32, tighten off,
    # against the committed JAX oracle and the port's own oracle
    ist_nt = ist._replace(tighten_sampling=False, spec=spec32)
    st_fid = state_rest
    push = torch.tensor([2e3, 0.0, 0.0], device=dev)
    for _ in range(5):
        st_fid = sim.sim_step(consts, sim.update_force(consts, st_fid, vid,
                                                       push))
    p_def, F, dF = sim.get_ip_info(consts, st_fid)
    p_ori = consts.ip_pos.float()
    pack = beam_bend.pack_ip_data_fast(p_def, p_ori, F, dF)
    reset_counts()
    out_f = interactive.render_frame_fused(ist_nt, pw, pack, p_def, pose,
                                           intr, H, W, 1.0)
    img_f = interactive.tiles_to_image(out_f["tiles_image"], H, W)
    oracle = np.load(ORACLE)["img"].astype(np.float32)
    p800 = psnr(img_f, oracle)
    # the port's own oracle at the same 800x800, K=128: settles whether the
    # gap to the JAX oracle is the port's bending or field arithmetic
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_x800 = interactive.render_frame_exact(
        ist_nt, pw, p_def, p_ori, F, dF, pose, intr, H, W, 1.0, tile_chunk=8)
    torch.cuda.synchronize()
    exact800_s = time.perf_counter() - t0
    img_x800 = interactive.tiles_to_image(out_x800["tiles_image"], H, W)
    r = 256
    intr_r = (1.2 * r, 1.2 * r, r / 2, r / 2)
    out_fr = interactive.render_frame_fused(ist_nt, pw, pack, p_def, pose,
                                            intr_r, r, r, 1.0)
    out_x = interactive.render_frame_exact(
        ist_nt, pw, p_def, p_ori, F, dF, pose, intr_r, r, r, 1.0,
        tile_chunk=8)
    torch.cuda.synchronize()
    fid_launches = read_counts()
    p256 = psnr(interactive.tiles_to_image(out_fr["tiles_image"], r, r),
                interactive.tiles_to_image(out_x["tiles_image"], r, r))
    diff = np.abs(img_f - oracle).max(axis=-1)
    emit("fidelity", psnr_800_vs_jax_oracle=p800, jax_own_db=86.93,
         max_abs_800=float(diff.max()),
         pixels_over_0p1=int((diff > 0.1).sum()),
         psnr_800_fused_vs_port_exact=psnr(img_f, img_x800),
         psnr_800_port_exact_vs_jax_oracle=psnr(img_x800, oracle),
         port_exact_800_s=exact800_s,
         n_active_800=[int(out_f["n_active"]), int(out_x800["n_active"])],
         psnr_256_fused_vs_port_exact=p256, launches=fid_launches,
         n_active_256=[int(out_fr["n_active"]), int(out_x["n_active"])])
    assert p800 >= 60.0 and p256 >= 55.0, (p800, p256)
    assert fid_launches == only(field_w64=fid_launches["field_w64"],
                                tile_deformed_w64=2)
    assert fid_launches["field_w64"] > 0

    # ---- the 128-wide student on main path 1
    ist_w = ist._replace(spec=spec16_w)
    _, drops0_w, wframe_launches = chained("wide_frame", ist_w, pw_w,
                                           "tile_deformed_w128")
    assert drops0_w == drops0, (drops0_w, drops0)
    # the f32 fused frames of the two widths at the fidelity state
    ist_ntw = ist_nt._replace(spec=spec32_w)
    reset_counts()
    out_fw = interactive.render_frame_fused(ist_ntw, pw_w, pack, p_def, pose,
                                            intr, H, W, 1.0)
    img_fw = interactive.tiles_to_image(out_fw["tiles_image"], H, W)
    p_w64 = psnr(img_fw, img_f)
    bit_equal = bool(torch.equal(out_fw["tiles_image"], out_f["tiles_image"]))
    emit("wide_frame", psnr_800_f32_w128_vs_w64=p_w64, limit_db=100.0,
         bit_identical=bit_equal,
         max_abs=float(np.abs(img_fw - img_f).max()))
    assert p_w64 >= 100.0, p_w64

    # the wide fused frame against the port's exact oracle at Wd 128 (its
    # field through the Wd-128 field kernel)
    out_frw = interactive.render_frame_fused(ist_ntw, pw_w, pack, p_def, pose,
                                             intr_r, r, r, 1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_xw = interactive.render_frame_exact(
        ist_ntw, pw_w, p_def, p_ori, F, dF, pose, intr_r, r, r, 1.0,
        tile_chunk=8)
    torch.cuda.synchronize()
    exact_w_s = time.perf_counter() - t0
    wfid_launches = read_counts()
    p256w = psnr(interactive.tiles_to_image(out_frw["tiles_image"], r, r),
                 interactive.tiles_to_image(out_xw["tiles_image"], r, r))
    emit("wide_fidelity", psnr_256_fused_vs_port_exact=p256w, limit_db=55.0,
         psnr_256_w64=p256, port_exact_256_s=exact_w_s,
         n_active_256=[int(out_frw["n_active"]), int(out_xw["n_active"])],
         launches=wfid_launches)
    assert p256w >= 55.0, p256w
    assert wfid_launches == only(field_w128=wfid_launches["field_w128"],
                                 tile_deformed_w128=2)
    assert wfid_launches["field_w128"] > 0

    # ---- the Newton frame (main_gui's default path): render_frame at
    # max_iter_num 100 on the fidelity state, the 48-wide pack, the default
    # bin_capacity and halo_bins, against the exact oracle at the same depth
    ist_n = ist_nt._replace(bend=bst._replace(max_iter_num=100))
    pack48 = beam_bend.pack_for(ist_n.bend, p_def, p_ori, F, dF)
    reset_counts()
    out_n = interactive.render_frame(ist_n, pw, pack48, p_def, pose, intr_r,
                                     r, r, 1.0)
    torch.cuda.synchronize()
    newton_launches = read_counts()
    newton0 = {k: int(out_n[k]) for k in ("n_active", "n_tile_overflow",
                                          "dropped_beam", "dropped_window")}
    newton_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        interactive.render_frame(ist_n, pw, pack48, p_def, pose, intr_r, r,
                                 r, 1.0)
        torch.cuda.synchronize()
        newton_ms.append((time.perf_counter() - t0) * 1e3)
    out_xn = interactive.render_frame_exact(
        ist_n, pw, p_def, p_ori, F, dF, pose, intr_r, r, r, 1.0,
        tile_chunk=8)
    img_n = interactive.tiles_to_image(out_n["tiles_image"], r, r)
    img_xn = interactive.tiles_to_image(out_xn["tiles_image"], r, r)
    # the default capacities bind: P = 256 candidates a tile, taken in IP
    # order, and a window of the sample's bin and one each side (~0.01
    # world units at K = 128 against a bend reach of 0.105). The same frame
    # uncapped (every IP a candidate, the window widened to the reach by
    # auto_halo over the sphere's 0.9 depth span, 32 slots a bin, 4-tile
    # chunks to bound memory) shows what they cost against the oracle
    bend_w = ist_n.bend._replace(
        ips_per_tile=4096, bin_capacity=32, halo_bins=beam_bend.auto_halo(
            beam_bend.reach_of(ist_n.bend), 0.9, ist_n.samples))
    out_nw = interactive.render_frame(
        ist_n._replace(bend=bend_w, tile_chunk=4), pw, pack48, p_def, pose,
        intr_r, r, r, 1.0)
    emit("newton_frame", resolution=r, max_iter_num=100,
         bin_capacity=ist_n.bend.bin_capacity,
         halo_bins=ist_n.bend.halo_bins, frame0=newton0,
         ms_reps=newton_ms, ms_median=float(np.median(newton_ms)),
         psnr_vs_port_exact=psnr(img_n, img_xn),
         uncapped=dict(
             ips_per_tile=bend_w.ips_per_tile, halo_bins=bend_w.halo_bins,
             bin_capacity=bend_w.bin_capacity,
             psnr_vs_port_exact=psnr(interactive.tiles_to_image(
                 out_nw["tiles_image"], r, r), img_xn),
             dropped_beam=int(out_nw["dropped_beam"]),
             dropped_window=int(out_nw["dropped_window"])),
         psnr_vs_fused_single_step=psnr(img_n, interactive.tiles_to_image(
             out_fr["tiles_image"], r, r)),
         launches=newton_launches)
    assert bool(np.isfinite(img_n).all())
    assert newton_launches == only(field_w64=newton_launches["field_w64"]), \
        newton_launches
    assert newton_launches["field_w64"] > 0

    # ---- main path 2: the cut-mode frame at the trex operating point
    # (tools/trex_proxy.py:206-253) on the committed field: the bench
    # sphere's IPs strictly inside the cut box, the lowest 12% in z pinned
    # (trex_proxy.py:167), the static class cached once per camera
    Hc, Wc = 752, 1008
    fc = 0.9 * 756
    intr_c = (fc, fc, Wc / 2.0, Hc / 2.0)
    cbox = np.asarray(CUT_BOUNDS)
    pts_c = pts[np.all((pts > cbox[0::2]) & (pts < cbox[1::2]), axis=1)]
    nc = pts_c.shape[0]
    pin_c = pts_c[:, 2] < np.quantile(pts_c[:, 2], 0.12)
    t0 = time.perf_counter()
    consts_c, rest_c, aux_c = sim.sim_init(
        pts_c, np.full(nc, 0.1), np.full(nc, 1e5), np.full(nc, 1e5), pin_c,
        dt=1e-2, iters=10, bbox=np.array([2.0, 2.0, 2.0]), kres=7, dx=dx,
        gravity=(0.0, 0.0, 0.0), stiff=1e5,
        base=np.array([-1.0, -1.0, -1.0]), device=dev)
    sim_init_c_s = time.perf_counter() - t0
    cb = torch.tensor(CUT_BOUNDS, dtype=torch.float32, device=dev)
    ist_c = interactive.InteractiveSettings(
        spec=spec16, bend=beam_bend.BeamBendSettings(
            num_seek_ip=1, max_iter_num=1, ip_dx=1.05 * dx, ips_per_tile=256),
        tile=16, samples=128, active_frac=0.5, tile_chunk=32, min_near=0.05,
        T_thresh=5e-2, cut=True, bound=1.0, bend_window=64,
        cut_static_frac=0.95)
    vid_c = int(np.argmax(consts_c.ip_pos[:, 2].cpu().numpy()))
    vk_c, vnx_c = consts_c.IP_kernel[vid_c], consts_c.IP_Nx[vid_c]
    vrest_c = consts_c.ip_pos[vid_c]

    def cut_frame(st, fi, cache, settings=ist_c, weights=pw):
        # spring drag toward a target orbiting at radius 0.2
        # (trex_proxy.py:245-250)
        p_ip = vrest_c + torch.einsum("ia,iad->d", vnx_c, st.ddof[vk_c])
        ang = torch.tensor(0.25 * fi, device=dev)
        target = vrest_c + 0.2 * torch.stack(
            [torch.cos(ang), torch.sin(ang), torch.zeros((), device=dev)])
        f = torch.clamp(1e5 * (target - p_ip), -5e5, 5e5)
        return pipeline.interactive_frame_step(
            settings, consts_c, st, weights, pose, intr_c, Hc, Wc, 1.0, vid_c,
            f, cb, static_cache=cache)

    reset_counts()
    cache = interactive.render_static_cache(ist_c, pw, pose, intr_c, Hc, Wc,
                                            cb)
    state = rest_c
    for fi in range(20):
        state, out = cut_frame(state, fi, cache)
        if fi == 0:
            state0_c = state
            cut0 = {k: int(out[k]) for k in
                    ("n_active", "dropped_beam", "dropped_window",
                     "n_tile_overflow")}
        assert bool(torch.isfinite(out["tiles_image"]).all()), fi
        assert bool(torch.isfinite(state.ddof).all()), fi
    torch.cuda.synchronize()
    cut_launches = read_counts()
    assert cut_launches == only(tile_static_w64=1, tile_cut_w64=20), \
        cut_launches
    reps = []
    fi = 20
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            state, out = cut_frame(state, fi, cache)
            fi += 1
        torch.cuda.synchronize()
        reps.append((time.perf_counter() - t0) / 10 * 1e3)
    assert bool(torch.isfinite(state.ddof).all())
    cache_ms = cuda_ms(lambda: interactive.render_static_cache(
        ist_c, pw, pose, intr_c, Hc, Wc, cb), 3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            state, out = cut_frame(state, fi, cache)
            fi += 1
        torch.cuda.synchronize()
    cut_profile = frame_profile(prof, 5, float(np.median(reps)))

    # the two classes, and the cache's bit-exact property
    # (test_cut_static_cache_bit_exact) on frame 0's state
    o_c, bbmin_c, bbmax_c, bend_c, static_c = interactive.cut_classes(
        ist_c, pose, intr_c, Hc, Wc, cb)
    cut0.update(n_bend=int(bend_c[2]), n_static=int(static_c[2]),
                bend_slots=int(bend_c[0].shape[0]),
                static_slots=int(static_c[0].shape[0]))
    p_def, F, dF = sim.get_ip_info(consts_c, state0_c)
    pack = beam_bend.pack_ip_data_fast(p_def, consts_c.ip_pos.float(), F, dF)
    fargs = (ist_c, pw, pack, p_def, pose, intr_c, Hc, Wc, 1.0, cb)
    out_cc = interactive.render_frame_fused(*fargs, static_cache=cache)
    out_cu = interactive.render_frame_fused(*fargs)
    cache_exact = (all(torch.equal(out_cc[k], out_cu[k]) for k in
                       ("tiles_image", "tiles_depth", "tiles_ws"))
                   and all(int(out_cc[k]) == int(out_cu[k]) for k in cut0
                           if k in out_cc))
    emit("cut_frame", n_ip=aux_c["n_ip"], n_pinned=int(pin_c.sum()),
         n_k=aux_c["n_k"], sim_init_s=sim_init_c_s, frame0=cut0,
         launches=cut_launches, ms_per_frame_reps=reps,
         ms_per_frame_median=float(np.median(reps)), cache_ms=cache_ms,
         cache_bit_exact=cache_exact)
    emit("cut_frame_profile", **cut_profile)
    assert cache_exact
    assert cut0["n_tile_overflow"] == 0 and cut0["n_bend"] > 0 \
        and cut0["n_active"] == cut0["n_bend"] + cut0["n_static"], cut0

    # main path 2 with the 128-wide student: the cache pass and 10 chained
    # cut frames with the counts read around them, then 10 timed frames
    ist_cw = ist_c._replace(spec=spec16_w)
    reset_counts()
    cache_w = interactive.render_static_cache(ist_cw, pw_w, pose, intr_c, Hc,
                                              Wc, cb)
    state = rest_c
    for fi in range(10):
        state, out = cut_frame(state, fi, cache_w, ist_cw, pw_w)
        if fi == 0:
            cut0_w = {k: int(out[k]) for k in
                      ("n_active", "dropped_beam", "dropped_window",
                       "n_tile_overflow")}
        assert bool(torch.isfinite(out["tiles_image"]).all()), fi
    torch.cuda.synchronize()
    wcut_launches = read_counts()
    assert wcut_launches == only(tile_static_w128=1, tile_cut_w128=10), \
        wcut_launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        state, out = cut_frame(state, fi, cache_w, ist_cw, pw_w)
        fi += 1
    torch.cuda.synchronize()
    wcut_ms = (time.perf_counter() - t0) / 10 * 1e3
    wcache_ms = cuda_ms(lambda: interactive.render_static_cache(
        ist_cw, pw_w, pose, intr_c, Hc, Wc, cb), 1)
    emit("wide_cut_frame", frame0=cut0_w, launches=wcut_launches,
         ms_per_frame=wcut_ms, cache_ms=wcache_ms)
    assert all(cut0_w[k] == cut0[k] for k in cut0_w), (cut0_w, cut0)

    # ---- the static and cut modes against their plain versions, on that
    # frame's static-class and bend-class inputs, both widths
    args_s, kw_s, _ = interactive.tile_kernel_inputs(
        ist_c, pack, p_def, o_c, pose, intr_c, Hc, Wc, static_c[0],
        static_c[1], bbmin_c, bbmax_c, deformed=False)
    args_b, kw_b, _ = interactive.tile_kernel_inputs(
        ist_c, pack, p_def, o_c, pose, intr_c, Hc, Wc, bend_c[0], bend_c[1],
        bbmin_c, bbmax_c, deformed=True, cut=True, cut_bounds=cb)
    rows_c = {}
    for suffix, specs, weights, w32 in (
            ("", (spec32, spec16), pw, None),
            ("_w128", (spec32_w, spec16_w), pw_fill, pw_w)):
        rows_c["static" + suffix] = tile_check(
            "tile_kernel_static" + suffix, tk, specs, weights, args_s, kw_s,
            limit_db=TILE_BF16_DB_STATIC, pw_f32=w32)
        rows_c["cut" + suffix] = tile_check(
            "tile_kernel_cut" + suffix, tk, specs, weights, args_b, kw_b,
            pw_f32=w32)

    # ---- main path 2, fidelity: f32, five pushes from rest, the fused cut
    # frame against the port's cut-mode oracle over every tile that hits
    # the scene box (active_frac 1: no slot cap)
    ist_c32 = ist_c._replace(spec=spec32)
    st_fid = rest_c
    for _ in range(5):
        st_fid = sim.sim_step(consts_c, sim.update_force(consts_c, st_fid,
                                                         vid_c, push))
    p_def, F, dF = sim.get_ip_info(consts_c, st_fid)
    pack = beam_bend.pack_ip_data_fast(p_def, consts_c.ip_pos.float(), F, dF)
    Wf, Hf = CUT_FID_RES
    ff = 0.9 * (756 if Wf == 1008 else Hf)
    intr_f = (ff, ff, Wf / 2.0, Hf / 2.0)
    reset_counts()
    out_f = interactive.render_frame_fused(ist_c32, pw, pack, p_def, pose,
                                           intr_f, Hf, Wf, 1.0, cb)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_x = interactive.render_frame_exact(
        ist_c32._replace(active_frac=1.0), pw, p_def,
        consts_c.ip_pos.float(), F, dF, pose, intr_f, Hf, Wf, 1.0,
        tile_chunk=8, cut_bounds=cb)
    torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t0
    cfid_launches = read_counts()
    img_f = interactive.tiles_to_image(out_f["tiles_image"], Hf, Wf)
    img_x = interactive.tiles_to_image(out_x["tiles_image"], Hf, Wf)
    pcut = psnr(img_f, img_x)
    # the same frame unbent: how far the bending moves the pixels at all
    out_s = interactive.render_frame_fused(
        ist_c32._replace(deformed=False, active_frac=1.0), pw, pack, p_def,
        pose, intr_f, Hf, Wf, 1.0, cb)
    img_s = interactive.tiles_to_image(out_s["tiles_image"], Hf, Wf)
    diff = np.abs(img_f - img_x).max(axis=-1)
    emit("cut_fidelity", resolution=[Wf, Hf], focal=ff, psnr=pcut,
         limit_db=55.0, psnr_fused_vs_unbent=psnr(img_f, img_s),
         pixels_bent_over_0p1=int(
             (np.abs(img_f - img_s).max(axis=-1) > 0.1).sum()),
         max_abs=float(diff.max()),
         pixels_over_0p1=int((diff > 0.1).sum()), oracle_s=oracle_s,
         n_active=[int(out_f["n_active"]), int(out_x["n_active"])],
         n_tile_overflow=[int(out_f["n_tile_overflow"]),
                          int(out_x["n_tile_overflow"])],
         dropped_window=int(out_f["dropped_window"]),
         launches=cfid_launches)
    assert int(out_x["n_tile_overflow"]) == 0
    assert int(out_f["n_active"]) == int(out_x["n_active"])
    assert cfid_launches["tile_cut_w64"] == 1
    assert cfid_launches["field_w64"] > 0
    assert pcut >= 55.0, pcut

    # ---- the port's main_gui as a user runs it: fused, --cut, at its
    # default Newton depth (max_iter_num 100, num_seek_IP 1), and on the
    # 128-wide checkpoint
    fused_flags = ["--max_iter_num", "1", "--num_seek_IP", "3"]

    def main_gui(phase, extra, workspace="runs/quality_mlp_800"):
        out_dir = os.path.join(ROOT, "build", f"smoke_{phase}_frames")
        cmd = [sys.executable, "-m", "pienerf_tpu_torch.main_gui",
               "--workspace", workspace, "--exp_name", "cube",
               "--backbone", "mlp", "--sim_dx", "0.2", "--bound", "0.5",
               "--W", "400", "--H", "400", "--radius", "2.5", "--frames",
               "3", "--out_dir", out_dir, "--kres", "4",
               "--timing_on"] + extra
        t0 = time.perf_counter()
        res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                             timeout=600)
        pngs = sorted(p for p in os.listdir(out_dir) if p.endswith(".png")) \
            if os.path.isdir(out_dir) else []
        frame_ms = [float(m) for m in re.findall(
            r"timing: frame \d+: ([\d.]+) ms", res.stdout)]
        emit(phase, rc=res.returncode, seconds=time.perf_counter() - t0,
             pngs=pngs, frame_ms=frame_ms,
             tail=res.stdout.strip().splitlines()[-3:])
        assert res.returncode == 0, res.stderr[-4000:]
        assert pngs == [f"frame_{i:04d}.png" for i in range(3)], pngs

    main_gui("main_gui", fused_flags)
    main_gui("main_gui_cut", fused_flags + [
        "--cut", "--cut_bounds", "0.0", "0.5", "-0.5", "0.5", "-0.5", "0.5"])
    main_gui("main_gui_newton", [])
    main_gui("main_gui_w128", fused_flags,
             workspace=os.path.relpath(wide_ws, ROOT))

    # ---- every (kernel, mode, width) with its launches on its main path:
    # field kernel, the Newton frame (Wd 64) and the wide fidelity oracle
    # (Wd 128); tile kernel, main path 1 (deformed) and main path 2 (the
    # cache pass and the cut frames), at each width
    def row(name, source, replaces, launches, reading):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": reading.get("max_abs_err",
                                           reading.get("rgb_max_abs")),
                "ms": reading["ms"], "plain_ms": reading["plain_ms"],
                "bound_ms": reading["bound_ms"],
                "bound_by": reading.get("bound_by", "operations"),
                "library_ms": None}

    fsrc = ("pienerf_tpu_torch/csrc/field_kernel.cu",
            "pienerf_tpu/ops/pallas/field_kernel.py:134")
    tsrc = ("pienerf_tpu_torch/csrc/tile_kernel.cu",
            "pienerf_tpu/ops/pallas/tile_kernel.py:238")
    kernels = [
        row("field_kernel", *fsrc, newton_launches["field_w64"],
            field_rows[64]["float32"]),
        row("tile_kernel", *tsrc, frame_launches["tile_deformed_w64"],
            tile_row),
        row("tile_kernel_static", *tsrc, cut_launches["tile_static_w64"],
            rows_c["static"]),
        row("tile_kernel_cut", *tsrc, cut_launches["tile_cut_w64"],
            rows_c["cut"]),
        row("field_kernel_w128", *fsrc, wfid_launches["field_w128"],
            field_rows[128]["float32"]),
        row("tile_kernel_w128", *tsrc, wframe_launches["tile_deformed_w128"],
            tile_row_w),
        row("tile_kernel_static_w128", *tsrc,
            wcut_launches["tile_static_w128"], rows_c["static_w128"]),
        row("tile_kernel_cut_w128", *tsrc, wcut_launches["tile_cut_w128"],
            rows_c["cut_w128"]),
    ]
    assert all(k["launches"] > 0 for k in kernels), kernels
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
