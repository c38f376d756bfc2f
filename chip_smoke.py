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
    field kernel), checked against the port's exact oracle; then under -O
    (the field kernel in bf16) at both widths, checked against the same
    frame with the field's plain version;
  main_gui as a user runs it: fused, --cut, at its default Newton depth,
    and on the 128-wide checkpoint;
  torch-ngp's hash-grid field at its published widths (seeded weights):
    main path 1 through its tile kernel (frame_hashgrid), then the kernel
    in each mode on the checks' passes against its plain version, with
    its device counters' readings and their cost, the kernel timed with
    its counter buffer and without, in turns (tile_kernel_hashgrid_*);
  the tile kernel's paired and block_tiles schedules: each against its
    plain version and, bit for bit, against the default schedule, then the
    bench frame through each;
  the tools: gather_probe (four row-fetch kernels and torch.index_select,
    at three table sizes: two in the L2, one beyond it)
    and micro_floor (the tile kernel's shell, six arms);
  the large-scene simulator: a pinned sphere above 6,000 IPs through the
    cached init, the chunked and the dense operator, bf16 storage and one
    coupled frame; and main_sim as a user runs it;
  main path 3, the non-fused render paths: one occupancy-grid update of
    the committed field, the static and the hierarchical render at
    800x800, ten spatial-hash deformed frames (pipeline.frame_step) on the
    bench scene, the default hash grid at full width (its plain encode
    timed alone, a static render and deformed frames at 256x256), the
    Simulator facade against the functions, and main_render as a user
    runs it on dumps of the deformed frame's state (its PNG equal to
    render_frame's image, the field kernel launched). Each render is held
    against the port's CPU run on a subset of its rays, from the same
    inputs and draws;
  main path 4, train -> distill -> serve: a blender-layout dataset of the
    sphere (40 + 4 views at 800x800, integrated on the card); one f32 train
    step on each path (the hash grid's occupancy march, the mlp's
    hierarchical renderer) held against the port's CPU from the same state
    and draws; each trainer's ms a step and device idle share, and the
    plain hash encode's forward + backward inside a hash-grid step;
    main_train on the mlp (bf16, 4096 rays, 256 samples, 150 steps) and
    on the default hash grid (2,000 steps), their losses falling, the hash
    grid's point cloud not empty; main_distill --student_width 128 on the
    hash grid's workspace; field_agreement against the untrained
    student's; image_agreement at 800x800 through the tile kernel's static
    mode (held against its plain version at >= 100 dB); main_gui --ckpt
    latest serving the student on the field kernel, and its first Newton
    frame in process held against the same frame on the plain field;
  main path 5, the point cloud and the live viewer, on main path 4's
    workspaces: main_sample on the hash-grid teacher (sub_res 256, then
    the hash-grid chain's 64), its occupancy on the card against the
    CPU's, the chain's annotation and main_sim on the cloud; main_viewer
    serving the 128-wide student in bf16 on that cloud as a process
    (--cut, 30 frames); run_sim_viewer in process under an HTTP client
    that orbits, drags, releases, pauses and quits (every served PNG equal
    to its frame, the pick taken, one tile-kernel pass against its plain
    version); the train viewer on the mlp's workspace (the static tile
    kernel); tools/distill_table.py at 200 + 200 steps, Wd 128;
  the last modules, on main path 4's workspaces: AlexNet-LPIPS on seeded
    weights (loaded through $PIENERF_LPIPS_WEIGHTS) on an 800x800 frame
    pair and in a patch-32 train step of the mlp, each held against the
    CPU; CLIP ViT-B/16 on seeded weights, both towers against the CPU and
    three CLIP steps of the mlp at 64x64 -> 224; tools/hashgrid_chain.py
    on the hash grid (.pth round trip, cloud, annotation, validate_asset:
    distill 300 steps, 4 poses at 256x256, the coupled frame's rate); and
    parallel/dryrun.py on two gloo ranks sharing the card (the sharded
    train step, sim and band frames at toy shapes, and the 896x800 band
    frame, plain and paired), each against one process's result.

The bf16 instantiations of both kernels run the field MLP on the tensor
cores (warpgroup MMAs), the f32 ones on the CUDA cores: the build phase
reports every instantiation's registers, spills, shared memory and
resident blocks per SM, and fails if ptxas serialised any warpgroup MMA;
field_mlp_bf16 times the tensor-core MLP alone (the field kernel at
N = 2^20) against its bound. The kernels line holds only this run's
readings; the prior_ms line just before it gives each kernel's time before
the tensor-core MLP (``pr4_ms``: commit 35c7b8a, whose bf16 MLP ran as FMA
chains), and for the kernels redesigned since commit ba2b58d (the
register-blocked f32 field kernel, the tensor-core one-hot fetch) that
commit's time too (``pr5_ms``), and for the two fetches redesigned since
commit 9fe92db (``dynslice_fetch`` as one warp-wide access a row,
``dma_fetch`` on bulk copies and mbarriers) that commit's time
(``pr6_ms``), and for the tile kernel's rows, whose window scan is one
pass a sub-segment since commit db7d684, that commit's time (``pr7_ms``),
and for the bf16 rows, whose MLP issued mma.sync one warp at a time at
commit 12c2c3c, that commit's time (``pr13_ms``).
tile_split runs the tile kernel's timed instantiation on the bench
inputs (deformed, both widths) and the cut pass's, in bf16 and in f32: its
output equal to the untimed kernel's, where each tile's cycles go (window
staging, scan, bend and blend, MLP, composite) and how the tiles fill the
card's slots; in f32 also the share of the executed sample steps the MLP
evaluated (the live samples alone) and how full its passes of 256 ran.
Every tile check times the f32 kernel too (the dtype
main_gui and main_viewer run without -O; its MLP register-blocked on the
CUDA cores), and frame_f32 runs main path 1 in f32. With
PIENERF_TILE_BASELINE set to an unpacked checkout of another commit (the
parent, say), the script also builds that commit's field and tile
libraries and times every tile row and both field rows in either dtype,
field_mlp_bf16, tile_split's timed instantiation and the f32 frame on
them in turns with this tree's (``before_ms``, ``before``): the f32
outputs held equal bit for bit, the bf16 ones to the bf16 limits each
holds against its plain version.
field_kernel_embedded holds the
f32 field kernel at Wd 128 on the embedded checkpoint bit for bit to Wd 64;
big_sim holds bf16 operator storage to the JAX package's own reading and
runs a 50-step drag under it.

    python3 chip_smoke.py
    PIENERF_TILE_BASELINE=build/parent python3 chip_smoke.py  # + before_ms

Needs one CUDA card and nvcc (sm_90a). Every phase prints one JSON line;
any failure raises, so the script exits non-zero. The last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
import time
import types

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
# the bf16 plain version); the control must fail them. The field's are
# means: with every layer rounded to bf16, any summation order but the plain
# version's own flips some activation's rounding by one bf16 ulp, and one
# flip of sigma_raw in [8, 16) moves sigma by exp(2^-4) - 1 = 6.45%. The
# CUDA-core FMA chains (commit 35c7b8a) summed in cuBLAS's order and read
# 0.0 against max limits of 1e-2 (rgb) and 2e-2 (sigma rel); the tensor
# cores' order read 0.0131 and
# 0.0645 on an H100 (control 0.040, 0.18), so a max limit below one flip
# can hold only for a bit-identical order. The means sit between the
# kernel's readings (88.1-92.0 dB, 1.4e-6-4.7e-6 at both widths) and the
# control's (56.2 dB, 1.03e-2). The max stays a guard against gross errors
# (a wrong column reads O(1)), above two flips.
FIELD_BF16_DB = 70.0              # PSNR of rgb
FIELD_BF16_SIGMA_MEAN_REL = 2e-3  # mean of |d sigma| / sigma
FIELD_BF16_GUARD = (0.1, 0.25)    # rgb max abs, sigma max rel
# the tile kernel's deformed and cut modes on the tensor cores read
# 88.6-97.4 dB on an H100, their controls 62.6-67.1 dB
TILE_BF16_DB = 80.0               # PSNR of the rgb rows
# the static march bends nothing, so its bf16 kernel and plain version
# encode identical sample positions and differ only in summation order: on
# an H100 the kernel read 120 dB (the PSNR floor of a 1e-12 MSE) and the
# control 79.6 dB, too near 80 to show the check can fail; the limit sits
# between the two
TILE_BF16_DB_STATIC = 100.0
# each kernel's time in the kernels line of commit 35c7b8a, before the
# tensor-core MLP (PERF.md "every TPU kernel", chip_smoke.py on an H100
# 80GB HBM3 at 700 W): bf16 for the tile rows, f32 for the field rows
# (their bf16 reading in PRIOR_FIELD_BF16_MS)
PRIOR_MS = {"field_kernel": 1.565, "field_kernel_w128": 5.818,
          "tile_kernel": 16.65, "tile_kernel_static": 108.2,
          "tile_kernel_cut": 30.24, "tile_kernel_w128": 59.45,
          "tile_kernel_static_w128": 413.2, "tile_kernel_cut_w128": 116.4,
          "tile_kernel_paired": 16.60, "tile_kernel_paired_static": 96.77,
          "tile_kernel_paired_cut": 30.20, "tile_kernel_block": 33.76,
          "onehot_fetch": 4.764, "dma_fetch": 0.06326,
          "take_fetch": 0.01419, "dynslice_fetch": 0.5080,
          "floor_shell": 0.01993}
PRIOR_FIELD_BF16_MS = {64: 1.597, 128: 6.064}
# the times at commit ba2b58d (chip_smoke.py on an H100 80GB HBM3 at
# 700 W) of the kernels redesigned since: the f32 field kernel at both
# widths (per-point FMA chains, now register-blocked) and the one-hot fetch
# (an f32 FMA loop, now on the tensor cores)
PR5_MS = {"field_kernel": 1.547, "field_kernel_w128": 5.776,
          "onehot_fetch": 4.770}
# the times at commit 9fe92db (the same script and card) of the two fetches
# redesigned since: dynslice (one thread a block, 32 float4s a row, now one
# warp-wide access a row) and dma (a cp.async ring of one warp a block, now
# bulk copies on mbarriers, 16 warps a block)
PR6_MS = {"dynslice_fetch": 0.5037, "dma_fetch": 0.06295}
# the tile rows' times at commit db7d684 (the same script and card), whose
# scan made num_seek passes over the window for every sample
PR7_MS = {"tile_kernel": 3.297, "tile_kernel_static": 8.210,
          "tile_kernel_cut": 3.162, "tile_kernel_w128": 6.108,
          "tile_kernel_static_w128": 22.65, "tile_kernel_cut_w128": 9.338,
          "tile_kernel_paired": 3.389, "tile_kernel_paired_static": 8.017,
          "tile_kernel_paired_cut": 3.308, "tile_kernel_block": 7.082}
# the bf16 rows' times at commit 12c2c3c (the same script and card), whose
# bf16 MLP issued mma.sync.m16n8k16 one warp at a time: the field kernel
# (its bf16 reading) and every tile row
PR13_MS = {"field_kernel": 0.1546, "field_kernel_w128": 0.4363,
           "tile_kernel": 2.054, "tile_kernel_static": 8.244,
           "tile_kernel_cut": 2.699, "tile_kernel_w128": 4.226,
           "tile_kernel_static_w128": 22.70, "tile_kernel_cut_w128": 7.385,
           "tile_kernel_paired": 2.046, "tile_kernel_paired_static": 7.972,
           "tile_kernel_paired_cut": 2.757, "tile_kernel_block": 4.327}
# bf16 storage of the sim operator moves one step of the 8,144-IP big_sim
# scene by about 5% of the state's scale, and that is the reference's own
# behaviour: from the same state after the same 20-step drag, JAX's
# cast_B_bf16 step reads 0.05247 on the CPU and the port's 0.05249
# (tests/test_torch_bigsim.py, its "chip" case, which is this scene). The
# card's f32 trajectory parts from the CPU's by about 4e-5 of the scale
# over those 20 steps, so its reading should match JAX's within a few
# percent: the check allows 15% either way, and a reading outside means the
# port's bf16 path no longer does what JAX's does.
BF16_STEP_REL_JAX = 0.05247
BF16_STEP_REL_TOL = 0.15
LONG_DRAG_STEPS = 50              # the bf16 long drag, read every 25 steps
LONG_DRAG_EVERY = 25
# the trex proxy's cut box (tools/trex_proxy.py:42) and the resolution of
# the cut-mode fidelity frame
CUT_BOUNDS = [-0.30, 0.75, -0.75, 0.60, -0.45, 0.75]
CUT_FID_RES = (1008, 752)


T_START = time.perf_counter()


def emit(phase, **kw):
    """One JSON line per phase; ``t`` is the seconds since the start."""
    print(json.dumps({"phase": phase, **kw,
                      "t": round(time.perf_counter() - T_START, 1)}),
          flush=True)


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
    frames: host ms and device ms of the port's ``frame.*`` spans
    (``pienerf_tpu_torch/utils/trace.py``: ``frame.sim``,
    ``frame.ip_info``, ``frame.ip_pack``, ``frame.render`` and the spans
    inside it), the device's busy ms (union of its kernel and copy spans),
    the tile kernel's device ms, and the idle share of the unprofiled
    frame. A span's device ms counts the kernels linked to the ops and
    spans inside it; the tile kernel is also counted on its own, by
    name."""
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


# ptxas's note that it issued an entry's warpgroup MMAs one at a time
# (accumulators touched between issue and wait, or a pipeline it cannot
# prove), which undoes their asynchrony
WGMMA_SERIALIZED = re.compile(r"wgmma.*serializ")


def ptxas_report(log: str) -> list:
    """Per kernel entry of an ``nvcc -Xptxas -v`` log: a readable name,
    registers, stack and spill bytes, and for the field and tile kernels
    the instantiation (``inst``) that ``occupancy`` reads."""
    rows, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
            wd = 128 if "ILi128E" in name or "wide" in name else 64
            b = re.search(
                r"ILb(\d)E(?:Lb(\d)ELb(\d)ELb(\d)ELb(\d)E)?", name)
            bf16 = "mma" in name or bool(b and b.group(1) == "1")
            inst = dict(kernel="field", wd=wd, bf16=bf16)
            if "render_tiles_kernel_grid" in name:
                g = re.search(r"ILb(\d)ELb(\d)E", name)
                mode = ("static" if g.group(1) == "0" else
                        "cut" if g.group(2) == "1" else "deformed")
                cur = {"kernel": f"tile {mode} hashgrid f32",
                       "inst": dict(kernel="tile_grid", mode=mode)}
                rows.append(cur)
                continue
            if "render_tiles" in name:
                inst.update(kernel="tile", paired=b.group(4) == "1",
                            block=b.group(5) == "1",
                            mode=("static" if b.group(2) == "0" else
                                  "cut" if b.group(3) == "1"
                                  else "deformed"),
                            timed="EEELb1EEEv" in name)
                label = (f"tile {inst['mode']}"
                         + (" paired" if inst["paired"] else "")
                         + (" block" if inst["block"] else "")
                         + (" timed" if inst["timed"] else ""))
            elif "field_eval" in name:
                label = "field"
            else:                      # the probes: no MLP, no width
                rows.append({"kernel": re.sub(
                    r"^_ZN7pienerf\d+|_kernel.*$", "", name)})
                cur = rows[-1]
                continue
            cur = {"kernel": f"{label} w{wd} {'bf16' if bf16 else 'f32'}",
                   "inst": inst}
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
            m = re.search(r"(\d+) bytes smem", ln)
            cur["static_smem_bytes"] = int(m[1]) if m else 0
    return rows


def occupancy(_build, inst: dict) -> tuple:
    """(resident blocks per SM, dynamic shared memory bytes) of one field
    or tile kernel instantiation (the timed ones too), from its library's
    occupancy entry
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor at the launch's shared
    memory; the bending modes at Wn = 64)."""
    blocks, smem = ctypes.c_int(), ctypes.c_int()
    out = (ctypes.byref(blocks), ctypes.byref(smem))
    if inst["kernel"] == "tile_grid":
        lib = _build.library("tile_grid")
        rc = lib.pienerf_render_tiles_grid_occupancy(
            int(inst["mode"] != "static"), int(inst["mode"] == "cut"), 64,
            *out)
    elif inst["kernel"] == "field":
        lib = _build.library("field")
        rc = lib.pienerf_field_occupancy(int(inst["bf16"]), inst["wd"], *out)
    else:
        mode = (int(inst["mode"] != "static"), int(inst["mode"] == "cut"))
        if inst["timed"]:
            lib = _build.library("tile_timed")
            rc = lib.pienerf_render_tiles_timed_occupancy(
                int(inst["bf16"]), mode[1], inst["wd"], 64, *out)
        elif inst["paired"]:
            lib = _build.library("tile_paired")
            rc = lib.pienerf_render_tiles_paired_occupancy(
                2 if inst["block"] else 1, int(inst["bf16"]), *mode, 64, 64,
                *out)
        else:
            lib = _build.library("tile_block" if inst["block"] else "tile")
            fn = (lib.pienerf_render_tiles_block_occupancy if inst["block"]
                  else lib.pienerf_render_tiles_occupancy)
            rc = fn(int(inst["bf16"]), *mode, inst["wd"], 64, *out)
    _build.check(lib, rc, "occupancy query")
    return blocks.value, smem.value


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


def field_check(phase, fk, pw, specs, rng) -> dict:
    """The field kernel against its plain version at N = 2^20 and a ragged
    N, f32 then bf16, one line each. f32: summation order only, 1e-5 max;
    bf16: rgb PSNR >= FIELD_BF16_DB and mean sigma relative error <=
    FIELD_BF16_SIGMA_MEAN_REL, which the control, a kernel that skips the
    bf16 rounding (the f32 kernel read against the bf16 plain version),
    must fail; the max errors within FIELD_BF16_GUARD. Returns the N = 2^20
    rows by dtype, with ms, plain ms and the bound."""
    import torch
    dev = pw.device
    wd = pw.shape[-1]

    def err(a, b):
        """rgb max abs, sigma max rel, rgb PSNR and sigma mean rel between
        two (sigma, rgb) pairs."""
        rel = (a[0] - b[0]).abs() / b[0].abs().clamp(min=1e-6)
        mse = float(((a[1] - b[1]).double() ** 2).mean())
        return dict(rgb_max_abs=float((a[1] - b[1]).abs().max()),
                    sigma_max_rel=float(rel.max()),
                    rgb_psnr=float(10.0 * np.log10(1.0 / max(mse, 1e-12))),
                    sigma_mean_rel=float(rel.mean()))

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
            f32 = spec.compute_dtype == "float32"
            row = dict(n=n, width=wd, dtype=spec.compute_dtype, **err(k, p))
            if f32:
                row["tol"] = (1e-5, 1e-5)
            else:
                row.update(limit_db=FIELD_BF16_DB,
                           limit_sigma_mean_rel=FIELD_BF16_SIGMA_MEAN_REL,
                           guard=FIELD_BF16_GUARD,
                           control={k_: v for k_, v in err(k32, p).items()})
            if n == 1 << 20:
                row.update(timed_turns(
                    lambda: fk.field_eval(pw, spec, x, d), 10,
                    hold=field_hold(f32)))
                row["plain_ms"] = cuda_ms(
                    lambda: fk.field_eval_plain(pw, spec, x, d), 3)
                flops = 2.0 * FIELD_MACS[wd] * n
                row["bound_ms"] = max(
                    flops / (PEAK_F32 if f32 else PEAK_BF16),
                    (FIELD_IO * n + pw.numel() * 4) / PEAK_BYTES) * 1e3
                rows[spec.compute_dtype] = row
            emit(phase, **row)
            if f32:
                assert row["rgb_max_abs"] <= 1e-5, row
                assert row["sigma_max_rel"] <= 1e-5, row
                continue
            assert row["rgb_psnr"] >= FIELD_BF16_DB, row
            assert row["sigma_mean_rel"] <= FIELD_BF16_SIGMA_MEAN_REL, row
            assert row["rgb_max_abs"] <= FIELD_BF16_GUARD[0], row
            assert row["sigma_max_rel"] <= FIELD_BF16_GUARD[1], row
            # the check must be able to fail the control
            ctl = row["control"]
            assert (ctl["rgb_psnr"] < FIELD_BF16_DB or ctl["sigma_mean_rel"]
                    > FIELD_BF16_SIGMA_MEAN_REL), row
    return rows


def field_hold(f32):
    """timed_turns' comparison of two field kernel outputs (sigma, rgb):
    f32 bit for bit; bf16 at the limits each holds against its plain
    version (rgb PSNR and mean sigma relative error)."""
    import torch

    def hold(b, n):
        if f32:
            eq = bool(torch.equal(b[0], n[0]) and torch.equal(b[1], n[1]))
            assert eq
            return {"before_equal": eq}
        rel = float(((b[0] - n[0]).abs() / n[0].abs().clamp(min=1e-6))
                    .mean())
        mse = float(((b[1] - n[1]).double() ** 2).mean())
        p = float(10.0 * np.log10(1.0 / max(mse, 1e-12)))
        assert p >= FIELD_BF16_DB and rel <= FIELD_BF16_SIGMA_MEAN_REL, (
            p, rel)
        return {"before_psnr_rgb": p, "before_sigma_mean_rel": rel}
    return hold


def printed(counts: dict, key: str) -> int:
    """The launches of ``key`` in counts an entry point printed (a tile
    name ends in its dtype there: ``key``_float32, ``key``_bfloat16) or
    read_counts returned (``key`` itself)."""
    return sum(v for k, v in counts.items()
               if k in (key, f"{key}_float32", f"{key}_bfloat16"))


def psnr(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return float(10.0 * np.log10(1.0 / max(mse, 1e-12)))


def tile_bound(tk, pw, args, kw, out, segments, peak_mlp, macs=None,
               grid_flops=0) -> dict:
    """The tile kernel's bound on one pass's inputs: the reference's
    operations per executed sample (the field MLP at ``peak_mlp``, the f32
    or the bf16 peak; in the bending modes one squared distance per window
    row, 8 flops, then num_seek min passes over the window,
    tile_kernel.py:406-420, on the CUDA cores) against the bytes read and
    written once (the static march reads no candidates). ``macs``: the
    net's MACs a sample (default the Fourier net of the pack's width);
    ``grid_flops``: a hash grid's encoding operations a sample (f32)."""
    samples = segments * tk.T2 * kw["Ks"]
    macs = FIELD_MACS[pw.shape[-1]] if macs is None else macs
    op_s = (2.0 * macs * samples / peak_mlp
            + grid_flops * samples / PEAK_F32)
    read = args
    if kw["deformed"]:
        op_s += (8.0 + kw["num_seek"]) * kw["Wn"] * samples / PEAK_F32
    else:
        read = (args[0], args[2], args[3])   # tile_sc, params, dirs
    nbytes = sum(t.numel() * t.element_size()
                 for t in read) + pw.numel() * 4 + out.numel() * 4
    return dict(executed_segments=segments,
                bound_ms=max(op_s, nbytes / PEAK_BYTES) * 1e3,
                bound_by=("operations" if op_s > nbytes / PEAK_BYTES
                          else "bytes"))


# torch-ngp's hash-grid nets (sigma 32-64-16, color 31-64-64-3) and its
# encoding's operations a sample inside the box (16 levels x (3 + 16 + 16
# x 2 features): benchmark/reference/hashgrid.py flops_per_sample)
GRID_MACS = 9344
GRID_ENCODE_FLOPS = 816


def hashgrid_rows(tk, spec, pw, passes) -> dict:
    """torch-ngp's hash-grid net in the tile kernel (f32, the default
    schedule), per mode on one pass's inputs (``passes``: mode -> (args,
    kw)): the kernel against its plain version (within 1e-4, the dropped
    row equal), the plain version's ms, the bound (tile_bound over every
    marched sample, the encoding's operations added, the table's rows not
    counted), and the kernel's ms in turns with its counters and without
    (off, on, on, off; on under a profiler of the host alone: the
    counters' cost, which a traced run's launches pay), with the
    counters' readings: samples encoded (= the
    plain version's live points), rows read (= 16 x 8 x those inside the
    grid's box) and the encode stage's share of the warps' cycles. One
    line a mode (tile_kernel_hashgrid_<mode>)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    rows = {}
    for mode, (args, kw) in passes.items():
        st = {}
        ko = tk.render_tiles(spec, pw, *args, **kw)
        po = tk.render_tiles_plain(spec, pw, *args, **kw, stats=st)
        torch.cuda.synchronize()
        row = dict(mode=mode, dtype="float32",
                   max_abs_err=float((ko[:, 0:5] - po[:, 0:5]).abs().max()),
                   dropped_equal=bool(torch.equal(ko[:, 5], po[:, 5])),
                   points=st["points"], inside=st["inside"])
        def run():
            return tk.render_tiles(spec, pw, *args, **kw)

        def counted(reps):
            # a profiler of the host alone turns the counters on, as in a
            # traced run
            with profile(activities=[ProfilerActivity.CPU]):
                return cuda_ms(run, reps)
        reps = 5
        tk.read_grid_counters(zero=True)
        off = [cuda_ms(run, reps)]
        on = [counted(reps), counted(reps)]
        off.append(cuda_ms(run, reps))
        n_counted = 2 * (reps + 1)
        enc, tile, samples, nrows = (
            v / n_counted for v in tk.read_grid_counters(zero=True).values())
        row.update(ms=float(np.mean(off)), ms_reps=off,
                   counters_ms=float(np.mean(on)), counters_ms_reps=on,
                   counters_cost=float(np.mean(on) / np.mean(off) - 1.0),
                   samples_encoded=samples, rows_read=nrows,
                   rows_per_sample=nrows / max(samples, 1.0),
                   encode_cycle_share=enc / max(tile, 1.0))
        row["plain_ms"] = cuda_ms(lambda: tk.render_tiles_plain(
            spec, pw, *args, **kw), 1)
        row.update(tile_bound(tk, pw, args, kw, ko, st["segments"],
                              PEAK_F32, macs=GRID_MACS,
                              grid_flops=GRID_ENCODE_FLOPS))
        emit(f"tile_kernel_hashgrid_{mode}", **row)
        assert row["max_abs_err"] <= 1e-4 and row["dropped_equal"], row
        assert samples == st["points"], row
        assert nrows == 16 * 8 * st["inside"], row
        rows[mode] = row
    return rows


# the parent commit's field and tile libraries for the before / after
# columns, built from $PIENERF_TILE_BASELINE/pienerf_tpu_torch/csrc when
# that is set (an unpacked checkout of the parent); empty otherwise
BASELINE_ENV = "PIENERF_TILE_BASELINE"
BASELINE_LIBS = {}
BASELINE_NAMES = ("field", "tile", "tile_block", "tile_paired", "tile_timed")


def start_baseline(_build) -> dict:
    """Start one nvcc per baseline library, beside the main build."""
    root = os.environ.get(BASELINE_ENV)
    if not root:
        return {}
    csrc = os.path.join(os.path.abspath(root), "pienerf_tpu_torch", "csrc")
    out = os.path.join(ROOT, "build", "tile_baseline")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name in BASELINE_NAMES:
        so = os.path.join(out, f"lib{name}.so")
        cmd = [_build._nvcc()] + _build.NVCC_FLAGS + [
            "-o", so, os.path.join(csrc, _build.SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    return procs


def finish_baseline(procs) -> None:
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate(timeout=900)
        assert proc.returncode == 0, log[-4000:]
        lib = ctypes.CDLL(so)
        lib.pienerf_error_string.restype = ctypes.c_char_p
        lib.pienerf_error_string.argtypes = [ctypes.c_int]
        BASELINE_LIBS[name] = lib


def on_baseline(fn):
    """fn() with the baseline libraries in place of this tree's (the
    fused frame's captured graphs, which launch the kernels they were
    captured with, dropped on either side)."""
    from pienerf_tpu_torch.kernels import _build
    from pienerf_tpu_torch.render import interactive
    saved = dict(_build._libs)
    _build._libs.update(BASELINE_LIBS)
    interactive.drop_frame_graphs()
    try:
        return fn()
    finally:
        _build._libs.clear()
        _build._libs.update(saved)
        interactive.drop_frame_graphs()


def timed_turns(run, reps, hold=None) -> dict:
    """``run``'s device ms; with the baseline libraries also theirs, in
    turns (baseline, this tree, this tree, baseline), and the two outputs
    compared: bit for bit (``before_equal``), or, given ``hold``, by
    ``hold(baseline's, this tree's)``, a dict of readings."""
    import torch
    if not BASELINE_LIBS:
        return {"ms": cuda_ms(run, reps)}
    b = [on_baseline(lambda: cuda_ms(run, reps))]
    n = [cuda_ms(run, reps), cuda_ms(run, reps)]
    b.append(on_baseline(lambda: cuda_ms(run, reps)))
    out_b = on_baseline(run)
    out_n = run()
    torch.cuda.synchronize()
    return {"ms": float(np.mean(n)), "ms_reps": n,
            "before_ms": float(np.mean(b)), "before_ms_reps": b,
            **({"before_equal": bool(torch.equal(out_b, out_n))}
               if hold is None else hold(out_b, out_n))}


def rgb_psnr_hold(limit_db):
    """timed_turns' comparison of two bf16 tile outputs: the rgb rows'
    PSNR (``before_psnr_rgb``), which must reach ``limit_db``, the limit
    each holds against its plain version."""
    def hold(b, n):
        p = psnr(b[:, 0:3].cpu().numpy(), n[:, 0:3].cpu().numpy())
        assert p >= limit_db, (p, limit_db)
        return {"before_psnr_rgb": p}
    return hold


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
    Each line carries its kernel's ms on ``pw`` (beside the baseline's,
    in turns, when one is built), the plain version's ms and the bound at that
    dtype's peak. Returns {"float32": row, "bfloat16": row}."""
    import torch
    spec32, spec16 = specs
    stats, stats32 = {}, {}

    def f32_pair(weights, st=None):
        ko = tk.render_tiles(spec32, weights, *args, **kw)
        po = tk.render_tiles_plain(spec32, weights, *args, **kw,
                                   **({} if st is None else {"stats": st}))
        torch.cuda.synchronize()
        return ko, po, (ko[:, 0:5] - po[:, 0:5]).abs()

    ko, po, err = f32_pair(pw if pw_f32 is None else pw_f32,
                           stats32 if pw_f32 is None else None)
    drop_eq = bool(torch.equal(ko[:, 5], po[:, 5]))
    row = dict(width=pw.shape[-1], dtype="float32",
               max_abs_err=float(err.max()), dropped_equal=drop_eq,
               dropped=float(ko[:, 5, 0].sum()))
    ko32 = ko
    if pw_f32 is not None:
        ko32, _, err_f = f32_pair(pw, stats32)
        row.update(filled_max_abs_err=float(err_f.max()),
                   filled_rays_over_1e4=int((err_f > 1e-4).any(1).sum()))
    row.update(timed_turns(lambda: tk.render_tiles(spec32, pw, *args, **kw),
                           3))
    row["plain_ms"] = cuda_ms(lambda: tk.render_tiles_plain(
        spec32, pw, *args, **kw), 1)
    row.update(tile_bound(tk, pw, args, kw, ko, stats32["segments"],
                          PEAK_F32))
    f32_row = row
    emit(phase, **row)
    assert row["max_abs_err"] <= 1e-4 and drop_eq, row
    assert row.get("before_equal", True), row
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
    row.update(timed_turns(lambda: tk.render_tiles(spec16, pw, *args, **kw),
                           5, hold=rgb_psnr_hold(limit_db)))
    row["plain_ms"] = cuda_ms(lambda: tk.render_tiles_plain(
        spec16, pw, *args, **kw), 1)
    row.update(tile_bound(tk, pw, args, kw, ko, stats["segments"],
                          PEAK_BF16))
    bf16_row = row
    emit(phase, **row)
    assert bf16_row["control_psnr_rgb"] < limit_db, bf16_row
    assert bf16_row["psnr_rgb"] >= limit_db, bf16_row
    return {"float32": f32_row, "bfloat16": bf16_row}


def variant_check(phase, tk, specs, pw, pw_variant, args, kw, block_tiles=1,
                  limit_db=TILE_BF16_DB, base_row=None,
                  base_row32=None) -> dict:
    """A schedule variant of the tile kernel (the paired pack, or
    ``block_tiles`` tiles per block, or both) on one pass's inputs, f32
    then bf16, one line each: ``torch.equal`` to the default schedule's
    kernel output, and against the variant's own plain version as
    ``tile_check`` holds the default (f32 within 1e-4 with the dropped row
    equal; bf16 at ``limit_db`` or more); the f32 line with the variant's
    and the default's ms, its plain version's ms and ``base_row32``'s bound.
    Returns the bf16 row with the variant's ms beside the default's (timed
    in turns), the plain version's ms and the bound, which is the default
    schedule's (``base_row``): the same function; its f32 row under
    "f32"."""
    import torch
    vkw = dict(kw, block_tiles=block_tiles)
    row = None
    for spec in specs:
        ko = tk.render_tiles(spec, pw_variant, *args, **vkw)
        base = tk.render_tiles(spec, pw, *args, **kw)
        stats = {}
        po = tk.render_tiles_plain(spec, pw_variant, *args, **vkw,
                                   stats=stats)
        torch.cuda.synchronize()
        f32 = spec.compute_dtype == "float32"
        row = dict(dtype=spec.compute_dtype, block_tiles=block_tiles,
                   paired=pw_variant is not pw,
                   equals_default=bool(torch.equal(ko, base)),
                   max_abs_err=float((ko[:, 0:5] - po[:, 0:5]).abs().max()),
                   dropped_equal=bool(torch.equal(ko[:, 5], po[:, 5])),
                   executed_segments=stats["segments"])
        if f32:
            # its ms (beside the baseline's) and the default schedule's
            run_v = (lambda: tk.render_tiles(spec, pw_variant, *args, **vkw))
            row.update(timed_turns(run_v, 3))
            row["default_ms"] = cuda_ms(
                lambda: tk.render_tiles(spec, pw, *args, **kw), 3)
            row["plain_ms"] = cuda_ms(lambda: tk.render_tiles_plain(
                spec, pw_variant, *args, **vkw), 1)
            if base_row32 is not None:
                row.update(bound_ms=base_row32["bound_ms"],
                           bound_by=base_row32["bound_by"])
            emit(phase, **row)
            assert row["max_abs_err"] <= 1e-4 and row["dropped_equal"], row
            assert row.get("before_equal", True), row
            f32_row = row
        else:
            row["psnr_rgb"] = psnr(ko[:, 0:3].cpu().numpy(),
                                   po[:, 0:3].cpu().numpy())
        assert row["equals_default"], row
    spec16 = specs[1]

    def run_variant():
        return tk.render_tiles(spec16, pw_variant, *args, **vkw)

    def run_default():
        return tk.render_tiles(spec16, pw, *args, **kw)
    ms_d = [cuda_ms(run_default, 5)]
    ms_v = [cuda_ms(run_variant, 5), cuda_ms(run_variant, 5)]
    ms_d.append(cuda_ms(run_default, 5))
    # the baseline's variant in turns with this tree's
    before = {k: v for k, v in timed_turns(
        run_variant, 5, hold=rgb_psnr_hold(limit_db)).items()
        if k.startswith("before_")}
    row.update(ms=float(np.mean(ms_v)), default_ms=float(np.mean(ms_d)),
               ms_reps=ms_v, default_ms_reps=ms_d, limit_db=limit_db,
               **before,
               plain_ms=cuda_ms(lambda: tk.render_tiles_plain(
                   spec16, pw_variant, *args, **vkw), 1))
    if base_row is not None:
        row.update(bound_ms=base_row["bound_ms"],
                   bound_by=base_row["bound_by"])
    emit(phase, **row)
    assert row["psnr_rgb"] >= limit_db and row["dropped_equal"], row
    return dict(row, f32=f32_row)


def tile_split(phase, tk, spec, pw, args, kw, base_row, resident,
               n_sm, before_resident=None, **extra) -> dict:
    """The tile kernel's timed instantiation on one pass's inputs (f32 or
    bf16, as ``spec``):
    its output ``torch.equal`` to the untimed kernel's, then where a tile's
    cycles go. Per phase (window staging, scan, bend and blend, MLP,
    composite with the early exit): its share of the summed warp cycles
    and its warp cycles per executed sample step (a warp's 32 rays one
    sample on); the timed and untimed ms, timed in turns. The tail: the
    spread of the tiles' total cycles (max / mean), the waves (active
    tiles over ``resident`` x ``n_sm`` slots), the share of tiles in the
    last wave and the share of the kernel's span after the last wave's
    first start (global timer), and the slots' fill (the tiles' summed
    ns over slots x span). f32: the points the MLP evaluated over the
    executed sample steps x 256 (``evaluated_share``) and over its passes
    x 256 (``batch_fill``). With the baseline's timed library, its split
    and timed ms beside (``before``, at its ``before_resident`` blocks an
    SM; a library without the counts marches every sample)."""
    import torch
    skw = {k: kw[k] for k in ("K", "Ks", "Ksb", "Wn", "num_seek", "cut")}
    active = args[0][:, 2] > 0
    n_ph = len(tk.SPLIT_PHASES)
    steps = base_row["executed_segments"] * tk.T2 * kw["Ks"] / 32

    def timed():
        return tk.render_tiles_timed(spec, pw, *args, **skw)

    def split(res):
        """The timed run's output and its cycles by phase and tile."""
        out_t, cyc = timed()
        c = cyc[active].double().cpu()        # [n, 8 warps, SPLIT_COLS]
        ph = c[..., :n_ph].sum(dim=(0, 1))
        total = c[..., n_ph].amax(1)                   # per tile
        start, end = c[..., n_ph + 1].amin(1), c[..., n_ph + 2].amax(1)
        span = float(end.max() - start.min())
        n, slots = int(c.shape[0]), res * n_sm
        n_last = n % slots or slots
        last_start = float(start.sort().values[n - n_last])
        # the f32 path's evaluated points and MLP passes (0: not counted)
        pts = float(c[:, 0, n_ph + 3].sum())
        passes = float(c[:, 0, n_ph + 4].sum())
        counts = {} if passes == 0 else dict(
            evaluated_points=pts, mlp_passes=passes,
            evaluated_share=pts / (steps * 32), batch_fill=pts / (
                passes * tk.T2))
        return out_t, dict(
            **counts,
            share={p: float(ph[i] / ph.sum())
                   for i, p in enumerate(tk.SPLIT_PHASES)},
            warp_cycles_per_sample_step={p: float(ph[i] / steps)
                                         for i, p in enumerate(
                                             tk.SPLIT_PHASES)},
            phases_over_total=float(ph.sum() / c[..., n_ph].sum()),
            tile_cycles_mean=float(total.mean()),
            tile_cycles_max_over_mean=float(total.max() / total.mean()),
            resident_blocks=res, slots=slots, active_tiles=n,
            waves=n / slots, last_wave_tiles_share=n_last / n,
            last_wave_span_share=float(end.max() - last_start) / span,
            slot_fill=float((end - start).sum()) / (slots * span),
            span_ms=span * 1e-6)

    out_t, reading = split(resident)
    base = tk.render_tiles(spec, pw, *args, **kw)
    torch.cuda.synchronize()
    equal = bool(torch.equal(out_t, base))
    ms_u = [cuda_ms(lambda: tk.render_tiles(spec, pw, *args, **kw), 5)]
    ms_t = [cuda_ms(timed, 5) for _ in range(2)]
    ms_u.append(cuda_ms(lambda: tk.render_tiles(spec, pw, *args, **kw),
                        5))
    row = dict(
        width=pw.shape[-1], dtype=spec.compute_dtype,
        mode="cut" if kw["cut"] else "deformed",
        num_seek=kw["num_seek"], equals_untimed=equal,
        executed_segments=base_row["executed_segments"], **reading,
        ms=float(np.mean(ms_u)), timed_ms=float(np.mean(ms_t)),
        ms_reps=ms_u, timed_ms_reps=ms_t, **extra)
    if before_resident is not None:
        _, before = on_baseline(lambda: split(before_resident))
        before["timed_ms"] = on_baseline(lambda: cuda_ms(timed, 5))
        row["before"] = before
    emit(phase, **row)
    assert equal, row
    return row


def main_path_3(c) -> dict:
    """Main path 3: the non-fused render paths of the JAX package's XLA
    side (the occupancy grid, the static and hierarchical renderers, the
    spatial-hash deformed frame on the mlp field and on the default hash
    grid, the Simulator facade, main_render). Each card result is held
    against the port's CPU run on a subset of rays (rays are independent
    once a frame's structures are built) with the same inputs and draws.
    ``c`` carries main()'s state. Returns main_render's field-kernel
    launches."""
    import copy

    import torch
    from torch.profiler import ProfilerActivity, profile

    from pienerf_tpu_torch.config import PieNeRFConfig, get_shared_opts
    from pienerf_tpu_torch.data.rays import get_rays_full
    from pienerf_tpu_torch.io.framesink import read_png
    from pienerf_tpu_torch.main_gui import _load_field
    from pienerf_tpu_torch.models import network
    from pienerf_tpu_torch.ops import beam_bend
    from pienerf_tpu_torch.ops import grid as gridlib
    from pienerf_tpu_torch.render import deformed, fast, interactive
    from pienerf_tpu_torch.render import pipeline, renderer
    from pienerf_tpu_torch.sim import solver as sim

    dev, cpu = c.dev, torch.device("cpu")
    H = W = 800
    pose, intr = c.pose, c.intr
    field, field_cpu = c.field, copy.deepcopy(c.field).cpu()

    def sync_ms(fn, reps):
        """Host ms per call, each call ending in a device sync."""
        out, ms = None, []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return out, ms

    def profiled(fn, n, ms):
        """frame_profile over n calls of fn."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        return frame_profile(prof, n, ms)

    def flat_rows(h, w, every, every_col=1):
        """Flat indices of every ``every``-th row (and ``every_col``-th
        column): the rays a CPU re-render takes."""
        rows = torch.arange(0, h, every)
        return (rows[:, None] * w
                + torch.arange(0, w, every_col)[None]).reshape(-1)

    def cpu_rays(idx, h, w, intr_):
        ro, rd = get_rays_full(pose.cpu(), intr_, h, w)
        return ro[idx], rd[idx]

    def chunked(fn, n, chunk=8192):
        """fn(s, e) over [s, e) ray ranges of at most ``chunk`` rays."""
        outs = [fn(s, min(s + chunk, n)) for s in range(0, n, chunk)]
        return torch.cat(outs)

    # ---- occupancy_grid: one full update of the committed field, cascade
    # from its config (bound 1), the jitter from an explicit generator
    cfg = PieNeRFConfig(bound=1.0).finalize()
    gen = torch.Generator(device=dev).manual_seed(0)
    h3 = gridlib.GRID_SIZE ** 3
    noise = torch.rand((cfg.cascade, h3, 3), generator=gen,
                       device=dev) * 2.0 - 1.0

    def dens(f):
        return lambda x: f.density(x)[0]

    def update(f, d, nz):
        return gridlib.update(gridlib.init(cfg.cascade, d), dens(f),
                              cfg.bound, cfg.density_thresh, noise=nz)

    g, grid_ms = sync_ms(lambda: update(field, dev, noise), 3)
    t0 = time.perf_counter()
    g_cpu = update(field_cpu, cpu, noise.cpu())
    grid_cpu_s = time.perf_counter() - t0
    bits = [np.unpackbits(x.bitfield.cpu().numpy().view(np.uint8),
                          bitorder="little").astype(bool) for x in (g, g_cpu)]
    dcpu = g_cpu.density.numpy().reshape(-1)
    th = min(float(g_cpu.mean_density), cfg.density_thresh)
    near = np.abs(dcpu - th) <= 1e-5 * th
    differ = bits[0] != bits[1]
    emit("occupancy_grid", cascade=cfg.cascade, cells=int(bits[0].size),
         ms_reps=grid_ms, ms=float(np.median(grid_ms)),
         mean_density=float(g.mean_density),
         mean_density_cpu=float(g_cpu.mean_density),
         set_share=float(bits[0].mean()), differing_bits=int(differ.sum()),
         near_threshold_cells=int(near.sum()),
         differing_off_threshold=int((differ & ~near).sum()),
         cpu_s=grid_cpu_s)
    assert bits[0].any() and not (differ & ~near).any()

    # ---- static_render: render_image at 800x800, K = 256 (the trainer's
    # infer_settings) on that bitfield
    st = renderer.RenderSettings(
        bound=cfg.bound, cascade=cfg.cascade, min_near=cfg.min_near,
        dt_gamma=cfg.dt_gamma, max_steps=cfg.max_steps,
        T_thresh=cfg.T_thresh, max_samples=256, bg_radius=cfg.bg_radius)

    def static():
        return renderer.render_image(field, st, g, pose, intr, H, W)

    img_s, static_ms = sync_ms(static, 3)
    prof_s = profiled(static, 1, float(np.median(static_ms)))
    idx = flat_rows(H, W, 16)
    ro, rd = cpu_rays(idx, H, W, intr)
    bf_cpu = g.bitfield.cpu()
    t0 = time.perf_counter()
    sub = chunked(lambda s, e: renderer.render_rays(
        field_cpu, st, bf_cpu, ro[s:e], rd[s:e], 1.0)["image"], len(idx))
    static_cpu_s = time.perf_counter() - t0
    card = img_s["image"].reshape(-1, 3)[idx.to(dev)].cpu()
    p_static = psnr(card.numpy(), sub.numpy())
    emit("static_render", resolution=[W, H], max_samples=256,
         ms_reps=static_ms, ms=float(np.median(static_ms)),
         device_busy_ms=prof_s["device_busy_ms"],
         device_idle_share=prof_s["device_idle_share"],
         device_events=prof_s["device_events"],
         weights_sum_mean=float(img_s["weights_sum"].mean()),
         psnr_vs_cpu=p_static, cpu_rays=len(idx), cpu_s=static_cpu_s,
         limit_db=60.0)
    assert bool(torch.isfinite(img_s["image"]).all()) and p_static >= 60.0

    # ---- fast_render: render_image_fast at 800x800, 128 coarse + 128
    # fine, the same draws on both sides
    fst = fast.FastSettings(bound=cfg.bound, min_near=cfg.min_near,
                            T_thresh=cfg.T_thresh, num_coarse=128,
                            num_fine=128, bg_radius=cfg.bg_radius)
    draws = fast.draw(H * W, fst, gen, dev)

    def hier():
        return fast.render_image_fast(field, fst, pose, intr, H, W,
                                      draws=draws)

    img_f, fast_ms = sync_ms(hier, 3)
    prof_f = profiled(hier, 1, float(np.median(fast_ms)))
    idxf = flat_rows(H, W, 16, 2)
    rof, rdf = cpu_rays(idxf, H, W, intr)
    uc, uf = (d[idxf.to(dev)].cpu() for d in draws)
    t0 = time.perf_counter()
    sub = chunked(lambda s, e: fast.render_rays_fast(
        field_cpu, fst, rof[s:e], rdf[s:e], 1.0, u_coarse=uc[s:e],
        u_fine=uf[s:e])["image"], len(idxf))
    fast_cpu_s = time.perf_counter() - t0
    card = img_f["image"].reshape(-1, 3)[idxf.to(dev)].cpu()
    p_fast = psnr(card.numpy(), sub.numpy())
    emit("fast_render", resolution=[W, H], num_coarse=128, num_fine=128,
         ms_reps=fast_ms, ms=float(np.median(fast_ms)),
         device_busy_ms=prof_f["device_busy_ms"],
         device_idle_share=prof_f["device_idle_share"],
         psnr_vs_cpu=p_fast, psnr_vs_static=psnr(
             img_f["image"].cpu().numpy(), img_s["image"].cpu().numpy()),
         cpu_rays=len(idxf), cpu_s=fast_cpu_s, limit_db=60.0)
    assert bool(torch.isfinite(img_f["image"]).all()) and p_fast >= 60.0

    # ---- deformed_frame: pipeline.frame_step on the bench scene (its
    # config: sim_dx 0.05, 3 seeks, one Newton step, min_near 0.05), the
    # spring drag, 10 chained frames at 800x800
    cfgb = PieNeRFConfig(bound=1.0, sim_dx=0.05, num_seek_IP=3,
                         max_iter_num=1, min_near=0.05).finalize()
    vid_t = torch.tensor(c.vid, device=dev)
    rays = get_rays_full(pose, intr, H, W)

    def frames(fs, fld, bf, rays_, n, state):
        out = None
        for fi in range(n):
            state, out = pipeline.frame_step(
                fs, c.consts, state, fld, bf, *rays_, 1.0, vid_t,
                c.spring(state, fi))
        return state, out

    fs = pipeline.make_frame_settings(c.spec32, cfgb, cfgb.sim_dx)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, out_d = frames(fs, field, g.bitfield, rays, 10, c.state_rest)
    torch.cuda.synchronize()
    deformed_ms = (time.perf_counter() - t0) / 10 * 1e3
    assert bool(torch.isfinite(state.ddof).all())
    prof_d = profiled(lambda: frames(fs, field, g.bitfield, rays, 1, state),
                      1, deformed_ms)
    p_def, F, dF = sim.get_ip_info(c.consts, state)
    p_ori = c.consts.ip_pos.float()
    ipc = [a.cpu() for a in (p_def, p_ori, F, dF)]
    idx32 = flat_rows(H, W, 32, 8)
    ro32, rd32 = cpu_rays(idx32, H, W, intr)
    t0 = time.perf_counter()
    cc, no = deformed.prepare_frame(fs.deformed, ipc[0])
    sub = chunked(lambda s, e: deformed.render_rays_deformed(
        field_cpu, fs.deformed, bf_cpu, *ipc, ro32[s:e], rd32[s:e], 1.0,
        None, cc, no)["image"], len(idx32), 4096)
    deformed_cpu_s = time.perf_counter() - t0
    img_d = out_d["image"]
    p_deformed = psnr(img_d[idx32.to(dev)].cpu().numpy(), sub.numpy())
    ist_x = interactive.InteractiveSettings(
        spec=c.spec32, bend=beam_bend.BeamBendSettings(
            num_seek_ip=3, max_iter_num=1, ip_dx=1.05 * cfgb.sim_dx,
            ips_per_tile=256), tile=16, samples=128, min_near=0.05)
    ox = interactive.render_frame_exact(ist_x, c.pw, p_def, p_ori, F, dF,
                                        pose, intr, H, W, 1.0, tile_chunk=8)
    img_x = interactive.tiles_to_image(ox["tiles_image"], H, W)
    emit("deformed_frame", resolution=[W, H], n_ip=int(p_def.shape[0]),
         frames=10, max_samples=fs.deformed.base.max_samples,
         max_bend_samples=fs.deformed.max_bend_samples,
         max_steps=fs.deformed.base.max_steps, ms_per_frame=deformed_ms,
         stage_host_ms=prof_d["stage_host_ms"],
         device_busy_ms=prof_d["device_busy_ms"],
         device_idle_share=prof_d["device_idle_share"],
         peak_memory_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
         psnr_vs_cpu=p_deformed, cpu_rays=len(idx32), cpu_s=deformed_cpu_s,
         limit_db=60.0,
         psnr_vs_port_exact=psnr(img_d.reshape(H, W, 3).cpu().numpy(),
                                 img_x))
    assert bool(torch.isfinite(img_d).all()) and p_deformed >= 60.0

    # ---- hashgrid_frame: the package's default hash grid at full width
    # (16 levels x 2, 2^19 a level, desired_resolution 2048, 64-wide nets)
    # on a seeded field, its embeddings from U(-1, 1) so the encode shapes
    # the field; static and deformed at 256x256 (the resolution is cut,
    # not the width)
    r = 256
    intr_r = (1.2 * r, 1.2 * r, r / 2, r / 2)
    spec_h = network.make_spec(bound=1.0, backbone="hashgrid")
    gcpu = torch.Generator().manual_seed(0)
    field_h = network.FieldMLP(spec_h, generator=gcpu, device=dev)
    field_h.encoder.data = (torch.rand(tuple(field_h.encoder.shape),
                                       generator=gcpu) * 2 - 1).to(dev)
    field_hc = copy.deepcopy(field_h).cpu()
    # the plain encode alone at N = 2^20 (the baseline of a fused hash-grid
    # kernel): each point reads 8 corners x 16 levels x 2 f32 channels
    from pienerf_tpu_torch.models import hash_encoder
    n_enc = 1 << 20
    x_enc = torch.rand((n_enc, 3), generator=gen, device=dev) * 2 - 1
    enc_ms = cuda_ms(lambda: hash_encoder.encode(
        field_h.encoder, spec_h.grid, x_enc, 1.0, feature_major=True), 5)
    enc_bytes = n_enc * (12 + 8 * spec_h.grid.num_levels * 2 * 4
                         + spec_h.grid.output_dim * 4)
    torch.cuda.reset_peak_memory_stats()
    gh, hgrid_ms = sync_ms(lambda: gridlib.update(
        gridlib.init(1, dev), dens(field_h), 1.0, cfg.density_thresh,
        generator=gen), 1)
    img_h, hstatic_ms = sync_ms(lambda: renderer.render_image(
        field_h, st, gh, pose, intr_r, r, r), 3)
    fs_h = pipeline.make_frame_settings(spec_h, cfgb, cfgb.sim_dx)
    rays_r = get_rays_full(pose, intr_r, r, r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state_h, out_h = frames(fs_h, field_h, gh.bitfield, rays_r, 3,
                            c.state_rest)
    torch.cuda.synchronize()
    hframe_ms = (time.perf_counter() - t0) / 3 * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    idxh = flat_rows(r, r, 32, 4)
    roh, rdh = cpu_rays(idxh, r, r, intr_r)
    bfh = gh.bitfield.cpu()
    t0 = time.perf_counter()
    sub_s = renderer.render_rays(field_hc, st, bfh, roh, rdh, 1.0)["image"]
    iph = [a.cpu() for a in sim.get_ip_info(c.consts, state_h)]
    sub_d = deformed.render_deformed_chunked(
        field_hc, fs_h.deformed, bfh, iph[0], p_ori.cpu(), iph[1], iph[2],
        roh, rdh, 1.0)["image"]
    hcpu_s = time.perf_counter() - t0
    p_hs = psnr(img_h["image"].reshape(-1, 3)[idxh.to(dev)].cpu().numpy(),
                sub_s.numpy())
    p_hd = psnr(out_h["image"][idxh.to(dev)].cpu().numpy(), sub_d.numpy())
    emit("hashgrid_frame", resolution=[r, r], levels=spec_h.grid.num_levels,
         table_rows=spec_h.grid.total_params,
         log2_hashmap_size=spec_h.grid.log2_hashmap_size,
         encode_n=n_enc, encode_ms=enc_ms,
         encode_gather_bound_ms=enc_bytes / PEAK_BYTES * 1e3,
         grid_update_ms=hgrid_ms[0], static_ms_reps=hstatic_ms,
         static_ms=float(np.median(hstatic_ms)), frame_ms=hframe_ms,
         peak_memory_gb=peak, set_share=float(np.unpackbits(
             gh.bitfield.cpu().numpy().view(np.uint8)).mean()),
         psnr_static_vs_cpu=p_hs, psnr_frame_vs_cpu=p_hd,
         cpu_rays=len(idxh), cpu_s=hcpu_s, limit_db=60.0)
    assert bool(torch.isfinite(out_h["image"]).all())
    assert p_hs >= 60.0 and p_hd >= 60.0, (p_hs, p_hd)

    # ---- simulator_facade: 20 stepforwards with update_force through
    # the Simulator equal the same calls through the functions
    r0, dxs = 0.45, 0.1
    cs = np.arange(-r0, r0 + 1e-6, dxs)
    xx, yy, zz = np.meshgrid(cs, cs, cs, indexing="ij")
    pts = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], 1)
    pts = pts[np.linalg.norm(pts, axis=1) <= r0]
    n = pts.shape[0]
    sargs = (pts, np.full(n, 0.1), np.full(n, 1e5), np.full(n, 1e5),
             pts[:, 2] < -0.3)
    skw = dict(dt=1e-2, iters=10, bbox=np.array([2.0, 2.0, 2.0]), kres=7,
               dx=dxs, gravity=(0.0, 0.0, 0.0), stiff=1e5,
               base=np.array([-1.0, -1.0, -1.0]))
    simr = sim.Simulator(device=dev, **skw)
    simr.initialize(*sargs)
    consts_s, state_s, _ = sim.sim_init(*sargs, device=dev, **skw)
    svid = int(np.argmax(consts_s.ip_pos[:, 2].cpu().numpy()))
    equal = True
    for i in range(20):
        f = [2e3 * np.cos(0.3 * i), 1e3, 0.0]
        simr.update_force(svid, f)
        simr.stepforward()
        state_s = sim.sim_step(consts_s, sim.update_force(
            consts_s, state_s, svid, torch.tensor(f, dtype=torch.float32,
                                                  device=dev)))
        equal = equal and bool(torch.equal(simr.state.ddof, state_s.ddof))
    emit("simulator_facade", n_ip=int(consts_s.ip_pos.shape[0]), steps=20,
         equal=equal, moved=float(state_s.ddof.abs().max()))
    assert equal and float(state_s.ddof.abs().max()) > 0

    # ---- main_render as a user runs it, on dumps of the deformed frame's
    # last state; its PNG equals render_frame on the same state
    dump = os.path.join(ROOT, "build", "smoke_render_dump")
    os.makedirs(dump, exist_ok=True)
    for name, a in (("ip_pos_0", p_def), ("ip_F_0", F), ("ip_dF_0", dF),
                    ("ip_rest", p_ori)):
        np.save(os.path.join(dump, f"{name}.npy"), a.cpu().numpy())
    png = os.path.join(dump, "render.png")
    if os.path.exists(png):
        os.remove(png)
    flags = ["--workspace", "runs/quality_mlp_800", "--backbone", "mlp",
             "--H", str(r), "--W", str(r), "--sim_dx", "0.05",
             "--num_seek_IP", "3"]
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "pienerf_tpu_torch.main_render", *flags,
         "--dump_dir", dump, "--frame", "0", "--out", png], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    mr_s = time.perf_counter() - t0
    assert res.returncode == 0, res.stderr[-4000:]
    line = [s for s in res.stdout.splitlines()
            if s.startswith("field kernel launches: ")]
    mr_launches = json.loads(line[-1].split(": ", 1)[1])
    cfg_r = get_shared_opts(None, flags)
    spec_r, pw_r = _load_field(cfg_r, dev)
    bst = beam_bend.BeamBendSettings(
        num_seek_ip=cfg_r.num_seek_IP, max_iter_num=cfg_r.max_iter_num,
        ip_dx=1.05 * cfg_r.sim_dx)
    ist_r = interactive.InteractiveSettings(
        spec=spec_r, bend=bst, samples=96, min_near=cfg_r.min_near,
        T_thresh=cfg_r.T_thresh, cut=cfg_r.cut, bound=cfg_r.bound)
    focal = r / (2 * np.tan(np.radians(cfg_r.fovy) / 2))
    c.reset_counts()
    o = interactive.render_frame(
        ist_r, pw_r, beam_bend.pack_for(bst, p_def, p_ori, F, dF), p_def,
        pose, (focal, focal, r / 2, r / 2), r, r, 1.0)
    torch.cuda.synchronize()
    inproc = c.read_counts()
    want = (np.clip(interactive.tiles_to_image(o["tiles_image"], r, r), 0, 1)
            * 255).astype(np.uint8)
    got = read_png(png)
    emit("main_render", rc=res.returncode, seconds=mr_s,
         resolution=[r, r], max_iter_num=cfg_r.max_iter_num,
         png_equals_render_frame=bool(np.array_equal(got, want)),
         field_kernel_launches=mr_launches,
         in_process_launches=inproc["field_w64"],
         tail=res.stdout.strip().splitlines()[-2:])
    assert np.array_equal(got, want) and want.std() > 1
    assert mr_launches.get("w64_float32", 0) > 0
    assert inproc == c.only(field_w64=inproc["field_w64"])
    assert inproc["field_w64"] > 0
    return mr_launches


# main path 4 at full width: the sphere at 800x800, 40 training views and
# 4 held out; the mlp trained at runs/quality_mlp_800/summary.json's
# configuration (bf16, 4096 rays, 256 samples, lr decay 1e-5), the hash
# grid at the default width (16 levels x 2, 2^19 rows, 64-wide nets, 64
# samples, a grid update every 16 steps), the 128-wide student distilled
# from it; depth cut to 150 mlp steps and 2,000 hash-grid steps (the EMA,
# decayed 0.95^(1/40) a step, keeps 0.95^50 = 7.7% of the random init
# after 2,000: the distilled teacher is a trained field)
TRAIN = dict(hw=800, n_train=40, n_val=4, iters={"mlp": 150,
                                                 "hashgrid": 2000},
             distill_steps=1000, distill_batch=8192, num_rays=4096,
             cmp_rays=1024, prof_steps=32, agree_views=2)
CKPT_CHUNK = 500   # steps between the trainer's checkpoints (Trainer.train)
G_FLOOR = 1e-6     # |g| / max|g| of its leaf above which params compare
MAX_FLIPS = 2      # the CPU parity test's flips a leaf (or 1e-4 of those
#                    below the floor, on the card's millions of rows)


def compare_steps(a, b, grads):
    """Two param lists updated from one state, card and CPU: the largest
    difference where |g| > G_FLOOR of its leaf's largest; each leaf's
    flips below that floor (params more than 1e-6 apart) and entries
    there; whether the flips stay at most MAX_FLIPS a leaf (or 1e-4 of
    the entries below the floor)."""
    p_err, flips, below, flips_ok = 0.0, [], [], True
    for x, y, g in zip(a, b, grads):
        big = g.abs() > G_FLOOR * g.abs().max()
        if big.any():
            p_err = max(p_err, float((x - y)[big].abs().max()))
        flips.append(int(((x - y).abs() > 1e-6)[~big].sum()))
        below.append(int((~big).sum()))
        flips_ok &= flips[-1] <= max(MAX_FLIPS, 1e-4 * below[-1])
    return p_err, flips, below, flips_ok


def step_profile(prof, n_steps: int, ms_per_step: float) -> dict:
    """Device busy ms a step (union of kernel and copy spans) and the idle
    share of the unprofiled step, from a torch.profiler run of n_steps."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == cuda)
    busy, end = 0.0, float("-inf")
    for s, t in spans:
        if t > end:
            busy += t - max(s, end)
            end = t
    busy_ms = busy / 1e3 / n_steps
    return dict(steps=n_steps, device_busy_ms=busy_ms,
                device_events_per_step=len(spans) / n_steps,
                ms_per_step_unprofiled=ms_per_step,
                device_idle_share=1.0 - busy_ms / ms_per_step)


def main_path_4(c, sz=TRAIN) -> dict:
    """Main path 4: train -> distill -> serve, through the entry points.
    A blender-layout dataset of the sphere rendered on the card; one f32
    train step on each path held against the port's CPU from the same
    state and draws; each trainer's ms a step, device idle share and (hash
    grid) the plain encode's forward + backward, in process; main_train
    (mlp, then hash grid) and main_distill as subprocesses; the student's
    field_agreement against the untrained student's, its image_agreement
    through the tile kernel's static mode (held against its plain version)
    and main_gui serving it. Returns the launches of the tile kernel in
    image_agreement and of the field kernel in main_gui."""
    import shutil

    import torch
    from torch.profiler import ProfilerActivity, profile

    from pienerf_tpu_torch import main_gui
    from pienerf_tpu_torch.config import get_shared_opts
    from pienerf_tpu_torch.data import synthetic
    from pienerf_tpu_torch.data.provider import NeRFDataset
    from pienerf_tpu_torch.data.rays import get_rays_sampled
    from pienerf_tpu_torch.io.checkpoint import load_native
    from pienerf_tpu_torch.kernels import field as fk
    from pienerf_tpu_torch.models import hash_encoder, network
    from pienerf_tpu_torch.ops import grid as gridlib
    from pienerf_tpu_torch.render import interactive, renderer
    from pienerf_tpu_torch.train import distill
    from pienerf_tpu_torch.train import trainer as ttr
    from pienerf_tpu_torch.weights import field_from_numpy

    dev, cpu, tk = c.dev, torch.device("cpu"), c.tk
    root = os.path.join(ROOT, "build", "smoke_train")
    shutil.rmtree(root, ignore_errors=True)
    data = os.path.join(root, "data")
    hw, n_tr, n_va = sz["hw"], sz["n_train"], sz["n_val"]
    f = 0.9 * hw
    intr = (f, f, hw / 2.0, hw / 2.0)

    # ---- the dataset: RGBA views of the sphere, integrated on the card
    # (the same function as the host's numpy integral, held to it on a
    # 64x64 view: premultiplied color and alpha, since the straight color
    # of a pixel the sphere barely touches is a ratio of two near-zeros),
    # written as a blender-layout directory
    poses = synthetic.orbit_poses(n_tr + n_va, seed=0)
    sm = (0.9 * 64, 0.9 * 64, 32.0, 32.0)
    pair = [synthetic.render_gt(poses[0], sm, 64, 64, alpha=True, device=d)
            for d in (dev, None)]
    gt_err = float(np.abs(np.concatenate(
        [pair[0][..., :3] * pair[0][..., 3:], pair[0][..., 3:]], -1)
        - np.concatenate([pair[1][..., :3] * pair[1][..., 3:],
                          pair[1][..., 3:]], -1)).max())
    t0 = time.perf_counter()
    imgs = [synthetic.render_gt(p, intr, hw, hw, alpha=True, device=dev)
            for p in poses]
    t_gt = time.perf_counter() - t0
    t0 = time.perf_counter()
    synthetic.write_blender(data, {"train": (poses[:n_tr], imgs[:n_tr]),
                                   "val": (poses[n_tr:], imgs[n_tr:])},
                            intr, hw, hw)
    emit("train_dataset", views=[n_tr, n_va],
         hw=hw, gt_seconds=t_gt, write_seconds=time.perf_counter() - t0,
         card_vs_host_max_abs=gt_err)
    assert gt_err <= 1e-6, gt_err

    common = ["--path", data, "--bound", "1.0", "--scale", "1.0",
              "--dt_gamma", "0", "--num_rays", str(sz["num_rays"])]
    paths = {"mlp": ["--backbone", "mlp", "--fp16", "--train_max_samples",
                     "256", "--lr_decay_rate", "1e-5"],
             "hashgrid": ["--backbone", "hashgrid", "--train_max_samples",
                          "64", "--update_extra_interval", "16"]}
    for name in paths:
        paths[name] += ["--iters", str(sz["iters"][name])]

    # ---- one f32 step on each path, card against CPU, same state/draws
    view = torch.as_tensor(imgs[0]).reshape(hw * hw, 4)
    for name in ("hashgrid", "mlp"):
        cfg = get_shared_opts(args=common + paths[name])
        k = cfg.train_max_samples
        spec = network.make_spec(bound=1.0, backbone=name)
        tree = network.init_params(torch.Generator().manual_seed(0), spec)
        st = renderer.RenderSettings(
            bound=1.0, cascade=cfg.cascade, min_near=cfg.min_near,
            dt_gamma=0.0, max_steps=cfg.max_steps, T_thresh=cfg.T_thresh,
            max_samples=k)
        g = torch.Generator().manual_seed(1)
        n = sz["cmp_rays"]
        inds = torch.randint(0, hw * hw, (n,), generator=g)
        ro, rd = get_rays_sampled(torch.as_tensor(poses[0]), intr, hw, hw,
                                  inds)
        batch = {"rays_o": ro, "rays_d": rd, "pixels": view[inds]}
        draws = {"bg": torch.rand((n, 3), generator=g)}
        if name == "mlp":
            draws["u_coarse"] = torch.rand((n, k // 2), generator=g)
            draws["u_fine"] = torch.rand((n, k - k // 2), generator=g)
        else:
            draws["noise"] = torch.rand((n,), generator=g)
        grid = gridlib.init(cfg.cascade, cpu)
        dens = torch.full_like(grid.density, 20.0)
        bitfield = gridlib.packbits(dens, 10.0)
        res = []
        for d in (dev, cpu):
            field = field_from_numpy(tree, spec, d, trainable=True)
            opt = ttr.make_optimizer(cfg.lr, cfg.iters, cfg.lr_decay_rate)
            step = ttr.make_train_step(spec, st, opt, ema_decay=0.95,
                                       use_fast_path=name == "mlp")
            state, m = step(ttr.init_state(field, opt), bitfield.to(d),
                            {a: b.to(d) for a, b in batch.items()},
                            draws={a: b.to(d) for a, b in draws.items()})
            res.append((float(m["loss"]), [q.cpu() for q in m["grads"]],
                        [q.detach().cpu() for q in state.params.leaves()]))
        (lc, gc, pc), (lh, gh, ph) = res
        grad_rel = max(float((a - b).abs().max() / b.abs().max().clamp(
            min=1e-30)) for a, b in zip(gc, gh))
        p_err, flips, below, flips_ok = compare_steps(pc, ph, gh)
        loss_rel = abs(lc / lh - 1.0)
        emit("train_step_card_vs_cpu", path=name, rays=n, samples=k,
             loss_card=lc, loss_cpu=lh, loss_rel=loss_rel,
             grad_max_rel=grad_rel, param_max_abs=p_err,
             flips_below_floor=flips, below_floor=below)
        assert np.isfinite(lc) and loss_rel <= 1e-5, (lc, lh)
        assert p_err <= 1e-6 and flips_ok, (p_err, flips, below)

    # ---- each trainer in process on the card: ms a step, idle share;
    # for the hash grid the plain encode's forward + backward alone at a
    # step's live samples
    prof_rows = {}
    for name in ("mlp", "hashgrid"):
        cfg = get_shared_opts(args=common + paths[name] + [
            "--workspace", os.path.join(root, f"prof_{name}")])
        ds = NeRFDataset(cfg, type="train")
        tr = ttr.Trainer("ngp", cfg, use_checkpoint="scratch", device=dev)
        tr.train_iterations(ds, 16)                     # warm-up
        n = sz["prof_steps"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train_iterations(ds, n)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / n
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            tr.train_iterations(ds, n)
            torch.cuda.synchronize()
        row = step_profile(prof, n, ms)
        if name == "hashgrid":
            field, seen = tr.state.params, {}
            density = field.density

            def record(x, _density=density):
                if torch.is_grad_enabled():
                    seen["x"] = tuple(v.detach() for v in x)
                return _density(x)

            field.density = record
            tr.train_iterations(ds, 1)
            del field.density
            xs = seen["x"]
            emb = field.encoder
            cot = torch.randn((tr.spec.grid.output_dim, xs[0].shape[0]),
                              device=dev)

            def fwd():
                return hash_encoder.encode(emb, tr.spec.grid, xs, 1.0,
                                           feature_major=True)

            def fwd_bwd():
                return torch.autograd.grad(fwd(), emb, grad_outputs=cot)

            with torch.no_grad():
                enc_f = cuda_ms(fwd, 10)
            enc_fb = cuda_ms(fwd_bwd, 10)
            row.update(encode_points=int(xs[0].shape[0]),
                       encode_fwd_ms=enc_f, encode_fwd_bwd_ms=enc_fb,
                       encode_share_of_step=enc_fb / ms)
        emit("train_profile", path=name, **row)
        prof_rows[name] = row
        del tr, ds
        torch.cuda.empty_cache()

    # ---- main_train as a user runs it: the mlp, then the hash grid
    def run(phase, module, args):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", module] + args, cwd=ROOT,
                           capture_output=True, text=True, timeout=900)
        emit(phase, rc=r.returncode, seconds=time.perf_counter() - t0,
             tail=r.stdout.strip().splitlines()[-4:])
        assert r.returncode == 0, r.stderr[-4000:]
        return r.stdout

    def ply_vertices(path):
        with open(path, "rb") as fh:
            head = fh.read(4096).split(b"end_header")[0].decode("ascii")
        return int(re.findall(r"element vertex (\d+)", head)[0])

    ws, ck_last = {}, {}
    for name in ("mlp", "hashgrid"):
        ws[name] = os.path.join(root, f"ws_{name}")
        out = run(f"main_train_{name}", "pienerf_tpu_torch.main_train",
                  common + paths[name] + ["--workspace", ws[name]])
        losses = np.load(os.path.join(ws[name], "train_losses.npy"))
        psnr_val = float(re.findall(r"\[final eval\] PSNR=([\d.]+)",
                                    out)[-1])
        ck = sorted(os.listdir(os.path.join(ws[name], "checkpoints")))
        val = sorted(os.listdir(os.path.join(ws[name], "validation")))
        n_ck = -(-sz["iters"][name] // CKPT_CHUNK)
        ck_last[name] = f"ngp_ep{n_ck:04d}.npz"
        tree, _ = load_native(os.path.join(ws[name], "checkpoints",
                                           ck_last[name]))
        finite = all(np.isfinite(np.asarray(a)).all()
                     for v in tree["params"].values()
                     for a in (v if isinstance(v, list) else [v]))
        first, last = float(losses[:50].mean()), float(losses[-50:].mean())
        pc_vertices = ply_vertices(os.path.join(ws[name], "point_cloud.ply"))
        if name == "hashgrid":
            # a trained EMA field has geometry above the density threshold
            assert pc_vertices > 0, pc_vertices
        emit(f"train_{name}", steps=int(losses.size),
             loss_start=float(losses[0]), loss_end=float(losses[-1]),
             loss_first50=first, loss_last50=last, heldout_psnr=psnr_val,
             ms_per_step=prof_rows[name]["ms_per_step_unprofiled"],
             device_idle_share=prof_rows[name]["device_idle_share"],
             checkpoints=ck, validation_pngs=len(val),
             point_cloud_vertices=pc_vertices)
        assert np.isfinite(losses).all() and finite
        assert last < first, (first, last)
        assert ck == [f"ngp_ep{e:04d}.npz{x}" for e in range(
            max(n_ck - 1, 1), n_ck + 1) for x in ("", ".json")], ck
        assert len(val) == 2 * n_va, val

    # ---- main_distill: the 128-wide student of the hash grid
    out = run("main_distill", "pienerf_tpu_torch.main_distill", [
        "--workspace", ws["hashgrid"], "--bound", "1.0", "--student_width",
        "128", "--steps", str(sz["distill_steps"]), "--batch",
        str(sz["distill_batch"])])
    ckdir = os.path.join(ws["hashgrid"], "checkpoints")
    n_ck = int(ck_last["hashgrid"][6:10])
    student_ck = f"ngp_ep{n_ck + 1:04d}.npz"
    assert sorted(os.listdir(ckdir))[-2:] == [
        student_ck, student_ck + ".json"], os.listdir(ckdir)
    t_tree, _ = load_native(os.path.join(ckdir, ck_last["hashgrid"]))
    s_tree, _ = load_native(os.path.join(ckdir, student_ck))
    t_spec = network.make_spec(bound=1.0, backbone="hashgrid")
    s_spec = distill.make_student_spec(t_spec, 128)
    teacher = field_from_numpy(t_tree["ema_params"], t_spec, dev)
    student = field_from_numpy(s_tree["ema_params"], s_spec, dev)
    untrained = network.FieldMLP(s_spec, torch.Generator().manual_seed(0),
                                 device=dev)
    fa = distill.field_agreement(teacher, t_spec, student, s_spec)
    fa0 = distill.field_agreement(teacher, t_spec, untrained, s_spec)
    emit("field_agreement", student=fa, untrained=fa0)
    assert fa["sigma_logmse"] < fa0["sigma_logmse"], (fa, fa0)

    # ---- image_agreement at 800x800: the student through the tile
    # kernel's static mode, its first pass held against the plain version;
    # the teacher's occupancy grid built from the teacher's EMA weights by
    # image_agreement itself (six full updates, as the JAX package does:
    # the checkpoint's grid follows the raw params, which the EMA lags)
    kernel, calls = tk.render_tiles, []

    def capture(*args, **kw):
        out = kernel(*args, **kw)
        calls.append((args, kw, out))
        return out

    capture.launches = kernel.launches
    tk.render_tiles = capture
    c.reset_counts()
    t0 = time.perf_counter()
    ia = distill.image_agreement(teacher, t_spec, student, s_spec,
                                 poses[n_tr:n_tr + sz["agree_views"]], intr,
                                 hw, hw)
    torch.cuda.synchronize()
    ia_s = time.perf_counter() - t0
    ia_launches = c.read_counts()
    ia_f32 = c.read_f32_counts()
    kernel.launches = tk.render_tiles.launches
    tk.render_tiles = kernel
    args, kw, ko = calls[0]
    po = tk.render_tiles_plain(*args, **kw)
    torch.cuda.synchronize()
    vs_plain = psnr(ko[:, 0:3].cpu().numpy(), po[:, 0:3].cpu().numpy())
    key = f"tile_static_w{s_spec.hidden_dim}"
    emit("image_agreement", views=sz["agree_views"], hw=hw, seconds=ia_s,
         psnr_per_view=ia["psnr_per_view"], ssim_per_view=ia["ssim_per_view"],
         psnr_mean=ia["psnr_mean"], ssim_mean=ia["ssim_mean"],
         launches={k: v for k, v in ia_launches.items() if v},
         tile_vs_plain_db=vs_plain, student_dtype=s_spec.compute_dtype)
    assert ia_launches == c.only(**{key: sz["agree_views"]}), ia_launches
    assert vs_plain >= TILE_BF16_DB_STATIC, vs_plain
    assert all(np.isfinite(ia["psnr_per_view"]))

    # ---- main_gui serving the student (--ckpt latest), its Newton frame
    # on the field kernel at the student's width
    gui_out = os.path.join(root, "gui_frames")
    gui_args = [
        "--workspace", ws["hashgrid"], "--exp_name", "cube", "--backbone",
        "mlp", "--ckpt", "latest", "--sim_dx", "0.2", "--bound", "1.0",
        "--W", "400", "--H", "400", "--radius", "2.5", "--frames", "3",
        "--out_dir", gui_out, "--kres", "4", "--timing_on"]
    out = run("main_gui_student", "pienerf_tpu_torch.main_gui", gui_args)
    gui_launches = json.loads(re.findall(r"kernel launches: (\{.*\})",
                                         out)[-1])
    pngs = sorted(os.listdir(gui_out))
    emit("main_gui_student_launches", launches=gui_launches, pngs=pngs)
    assert student_ck in out, out[-2000:]
    assert pngs == [f"frame_{i:04d}.png" for i in range(3)], pngs
    assert gui_launches.get("field_w128_float32", 0) > 0, gui_launches

    # ---- the same Newton frame in process, with main_gui's own set-up
    # (its flags, the student from --ckpt latest, the cube's first sim
    # step), rendered through the field kernel and again with its plain
    # version swapped in: the f32 kernel-vs-plain limit (1e-4 max abs) on
    # the frame, as the tile kernel's f32 checks hold it
    cwd = os.getcwd()
    os.chdir(ROOT)              # main_gui reads assets/{exp_name}.ply
    try:
        app = main_gui.setup(gui_args)
    finally:
        os.chdir(cwd)
    assert (app.spec.hidden_dim, app.spec.compute_dtype) == (128, "float32")
    _, pack, p_def = main_gui.newton_sim(app, app.state, 0)
    c.reset_counts()
    out_k = main_gui.newton_render(app, pack, p_def)
    torch.cuda.synchronize()
    nf_launches = c.read_counts()
    interactive.field_kernel = types.SimpleNamespace(
        field_eval=fk.field_eval_plain)
    c.reset_counts()
    try:
        out_p = main_gui.newton_render(app, pack, p_def)
    finally:
        interactive.field_kernel = fk
    assert c.read_counts() == c.only(), "the plain frame launched a kernel"
    img_k, img_p = (interactive.tiles_to_image(o["tiles_image"], app.H,
                                               app.W) for o in (out_k, out_p))
    nf_err = float(np.abs(img_k - img_p).max())
    emit("newton_frame_student", hw=[app.H, app.W],
         n_active=int(out_k["n_active"]), max_abs_vs_plain=nf_err,
         psnr_vs_plain=psnr(img_k, img_p), limit_max_abs=1e-4,
         image_mean=float(img_k.mean()), launches={
             k: v for k, v in nf_launches.items() if v})
    assert bool(np.isfinite(img_k).all()) and img_k.std() > 0
    assert nf_launches == c.only(field_w128=nf_launches["field_w128"])
    assert nf_launches["field_w128"] > 0, nf_launches
    assert nf_err <= 1e-4, nf_err
    return {"tile_static_w128": ia_launches[key],
            "tile_static_w128_f32": ia_f32[key],
            "field_w128": gui_launches["field_w128_float32"],
            "train": {k: {"ms_per_step": v["ms_per_step_unprofiled"],
                          "device_idle_share": v["device_idle_share"]}
                      for k, v in prof_rows.items()},
            # what main path 5 runs on: the workspaces, the teacher's
            # checkpoint (the student is the newest), the dataset and the
            # mlp's training flags
            "ws": ws, "teacher": os.path.join(ckdir, ck_last["hashgrid"]),
            "mlp_flags": common + paths["mlp"]}


# main path 5 on main path 4's workspaces: the teacher sampled at the
# reference's operating point (sub_res 256, threshold 0.05) and at the
# hash-grid chain's (tools/hashgrid_chain.py: sub_res 64, threshold 0.02,
# sim_dx 0.05, kres 7); the viewers at 800x800 on the student in bf16
SAMPLE = dict(ref=("256", "0.05"), chain=("64", "0.02"), cmp_points=1 << 16,
              sim_steps=20)
VIEWER = dict(hw=800, process_frames=30, frames=40, train_frames=6,
              cut_bounds=["-0.6", "0.6", "-0.6", "0.0", "-0.6", "0.6"])
DT_SMOKE = ["--teacher_steps", "200", "--distill_steps", "200", "--n_poses",
            "2", "--widths", "128"]


def main_path_5(c, p4) -> dict:
    """Main path 5, the point cloud and the live viewer: main_sample on
    main path 4's hash-grid teacher (the reference's sub_res 256, then the
    chain's 64), its occupancy on the card against the CPU's, the chain's
    annotation and main_sim on the cloud; main_viewer serving the
    128-wide student on it as a process (--cut, 30 frames) and
    run_sim_viewer in process under a client thread that orbits, drags,
    releases, pauses and quits (every served PNG decoded to its frame, the
    pick, one frame's tile-kernel pass against its plain version); the
    train viewer on the mlp's workspace; distill_table at a smoke size.
    Returns the tile kernel's launches of the path by (mode, width)."""
    import shutil
    import threading
    import urllib.request

    import torch

    from pienerf_tpu_torch import main_sample, main_sim, main_viewer
    from pienerf_tpu_torch import web_viewer
    from pienerf_tpu_torch.config import get_shared_opts
    from pienerf_tpu_torch.io.checkpoint import load_native
    from pienerf_tpu_torch.io.framesink import decode_png, encode_png
    from pienerf_tpu_torch.io.ply import read_physics_ply, read_ply
    from pienerf_tpu_torch.models import network
    from pienerf_tpu_torch.sample import AdaptiveUniformSampling
    from pienerf_tpu_torch.tools import distill_table, hashgrid_chain
    from pienerf_tpu_torch.weights import field_from_numpy

    dev, cpu, tk = c.dev, torch.device("cpu"), c.tk
    root = os.path.join(ROOT, "build", "smoke_path5")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(root, "assets"))
    ws_t = p4["ws"]["hashgrid"]
    launches = {}

    def add(counts):
        for k, v in counts.items():
            if v:
                launches[k] = launches.get(k, 0) + v

    def in_root(fn, *a):
        cwd = os.getcwd()
        os.chdir(root)
        try:
            return fn(*a)
        finally:
            os.chdir(cwd)

    # ---- the physics point cloud of the teacher
    teacher = ["--device", "cuda", "--workspace", ws_t, "--ckpt",
               p4["teacher"], "--backbone", "hashgrid", "--bound", "1.0",
               "--sim_dx", "0.05"]
    clouds = {}
    for name, (res, thr) in (("ref", SAMPLE["ref"]),
                             ("chain", SAMPLE["chain"])):
        t0 = time.perf_counter()
        out = in_root(main_sample.main, teacher + [
            "--exp_name", name, "--sub_res", res, "--density_threshold",
            thr])
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        cloud = read_ply(os.path.join(root, out))
        clouds[name] = os.path.join(root, out)
        emit("main_sample", cloud=name, sub_res=int(res), threshold=float(
            thr), points=int(cloud["x"].shape[0]), seconds=sec,
             vp_sum=float(cloud["vp"].sum()))
        assert cloud["x"].shape[0] > 200 and np.isfinite(cloud["vp"]).all()

    # ---- the occupancy on the card against the CPU's, on 2^16 points of
    # the sub_res 256 lattice
    tree = load_native(p4["teacher"])[0]["ema_params"]
    t_spec = network.make_spec(bound=1.0, backbone="hashgrid")
    cfg = get_shared_opts(args=["--bound", "1.0", "--sub_res", "256"])
    samplers = [AdaptiveUniformSampling(cfg, field_from_numpy(
        tree, t_spec, d), t_spec) for d in (dev, cpu)]
    ax = samplers[0].lattice()[0]
    ids = np.random.RandomState(0).randint(0, 256, (SAMPLE["cmp_points"],
                                                    3))
    x = ax[ids]
    occ = [s.get_density(x) for s in samplers]
    occ_err = float(np.abs(occ[0] - occ[1]).max())
    emit("sample_card_vs_cpu", points=int(x.shape[0]), max_abs=occ_err,
         limit=1e-5, occupied=int((occ[1] > 0.05).sum()))
    assert occ_err <= 1e-5, occ_err
    del samplers

    # ---- annotate the chain's cloud as tools/hashgrid_chain.py does (the
    # bottom cap pinned, rubber-like moduli) and simulate it
    chain_ply = os.path.join(root, "assets", "chain.ply")
    shutil.copy(clouds["chain"], chain_ply)
    n_pin = hashgrid_chain.annotate(chain_ply)
    d = read_physics_ply(chain_ply)
    n = d["pos"].shape[0]
    sim_out = os.path.join(root, "sim_out")
    t0 = time.perf_counter()
    main_sim.main(["--ply", chain_ply, "--steps", str(SAMPLE["sim_steps"]),
                   "--out_every", "10", "--sim_dx", "0.05", "--kres", "7",
                   "--bound", "1.0", "--out_dir", sim_out])
    plys = sorted(os.listdir(sim_out))
    last = read_ply(os.path.join(sim_out, plys[-1]))
    last = np.stack([last[k] for k in ("x", "y", "z")], 1)
    emit("chain_sim", points=n, pinned=n_pin,
         steps=SAMPLE["sim_steps"], seconds=time.perf_counter() - t0,
         plys=plys, max_move=float(np.abs(last - d["pos"]).max()))
    assert plys == ["pnt_00000.ply", "pnt_00010.ply"], plys
    assert np.isfinite(last).all() and last.shape == d["pos"].shape

    # ---- main_viewer as a user runs it: the student (--ckpt latest, bf16)
    # on the annotated cloud, cut mode, 30 frames
    hw = str(VIEWER["hw"])
    viewer = ["--workspace", ws_t, "--exp_name", "chain", "--backbone",
              "mlp", "--ckpt", "latest", "--fp16", "--sim_dx", "0.05",
              "--kres", "7", "--bound", "1.0", "--max_iter_num", "1",
              "--num_seek_IP", "3", "--W", hw, "--H", hw, "--radius", "2.5",
              "--port", "0"]
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "pienerf_tpu_torch.main_viewer"] + viewer + [
            "--frames", str(VIEWER["process_frames"]), "--cut",
            "--cut_bounds"] + VIEWER["cut_bounds"],
        cwd=root, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": ROOT})
    emit("main_viewer_process", rc=r.returncode,
         seconds=time.perf_counter() - t0,
         tail=r.stdout.strip().splitlines()[-3:])
    assert r.returncode == 0, r.stderr[-4000:]
    proc = json.loads(re.findall(r"kernel launches: (\{.*\})",
                                 r.stdout)[-1])
    assert printed(proc, "tile_cut_w128_default") > 0, proc
    add({f"tile_{m}_w128": printed(proc, f"tile_{m}_w128_default")
         for m in ("deformed", "static", "cut")})

    # ---- run_sim_viewer in process, a client thread on HTTP
    cfg_v, ns_v = main_viewer.parse(viewer)
    trainer = main_viewer.load_trainer(cfg_v, ns_v)
    consts, state, ist, pw, cut_bounds = in_root(
        main_viewer.setup_sim, cfg_v, ns_v, trainer)
    assert (trainer.spec.hidden_dim, trainer.spec.compute_dtype) == (
        128, "bfloat16")
    server = web_viewer.ViewerServer(VIEWER["hw"], VIEWER["hw"],
                                     port=0).start()
    base = f"http://127.0.0.1:{server.port}"
    shared = server.shared

    def get(path):
        with urllib.request.urlopen(base + path, timeout=300) as resp:
            return resp.read()

    def post(path, obj):
        req = urllib.request.Request(base + path, method="POST",
                                     data=json.dumps(obj).encode())
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.read()

    def wait(cond, what):
        t_end = time.monotonic() + 300
        while not cond():
            if time.monotonic() > t_end:
                raise TimeoutError(what)
            time.sleep(0.02)

    published, frames, calls, served, errors = [], [], [], [], []
    publish, encode, kernel = (shared.publish, web_viewer.encode_frame,
                               tk.render_tiles)

    def rec_publish(png, stats):
        publish(png, stats)
        published.append((png, stats))
        if stats["frame"] == 2:      # the client's release and pause first
            wait(lambda: len(shared.events) >= 2, "client events")

    def rec_encode(img):
        frames.append(img)
        return encode(img)

    def capture(*a, **kw):
        out = kernel(*a, **kw)
        if not calls:
            calls.append((a, kw, out))
        return out

    def client():
        try:
            served.append(get("/frame.png?s=0"))
            wait(lambda: json.loads(get("/state")).get("frame", -1) >= 2,
                 "frame 2")
            post("/event", {"t": "drag_end"})
            post("/event", {"t": "pause"})
            wait(lambda: json.loads(get("/state")).get("paused"), "pause")
            served.append(get("/frame.png?s=0"))
            post("/quit", {})
        except Exception as e:       # raised below, on the main thread
            errors.append(e)
            shared.stop = True

    capture.launches = kernel.launches
    shared.publish, web_viewer.encode_frame, tk.render_tiles = (
        rec_publish, rec_encode, capture)
    for ev in ({"t": "orbit", "dx": 40, "dy": 10},
               {"t": "drag_start", "x": 0.5, "y": 0.5},
               {"t": "drag", "x": 0.56, "y": 0.48}):
        post("/event", ev)
    th = threading.Thread(target=client, daemon=True)
    th.start()
    c.reset_counts()
    t0 = time.perf_counter()
    try:
        web_viewer.run_sim_viewer(cfg_v, consts, state, ist, pw,
                                  cut_bounds=cut_bounds,
                                  max_frames=VIEWER["frames"], server=server)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        th.join(timeout=60)
    finally:
        web_viewer.encode_frame = encode
        kernel.launches = tk.render_tiles.launches
        tk.render_tiles = kernel
        server.close()
    sv = c.read_counts()
    add(sv)
    if errors:
        raise errors[0]
    assert not th.is_alive()
    pngs = [p for p, _ in published]
    decoded_equal = all(np.array_equal(decode_png(p), np.clip(
        f * 255.0, 0, 255).astype(np.uint8)) for p, f in zip(pngs, frames))
    stats = [s for _, s in published]
    a, kw, ko = calls[0]
    po = tk.render_tiles_plain(*a, **kw)
    torch.cuda.synchronize()
    vs_plain = psnr(ko[:, 0:3].cpu().numpy(), po[:, 0:3].cpu().numpy())
    frame_ms = [s["frame_ms"] for s in stats[1:]]
    enc_ms = [s["encode_ms"] for s in stats]
    emit("sim_viewer", frames=len(stats), seconds=sec,
         res=[s["res"] for s in stats],
         force_ip=[s["force_ip"] for s in stats],
         paused=[s["paused"] for s in stats],
         frame_ms_median=float(np.median(frame_ms)), frame_ms=frame_ms,
         encode_ms_median=float(np.median(enc_ms)),
         png_bytes_median=float(np.median([len(p) for p in pngs])),
         served=len(served), decoded_equal=decoded_equal,
         tile_vs_plain_db=vs_plain, limit_db=TILE_BF16_DB,
         drops=stats[1]["drops"],
         launches={k: v for k, v in sv.items() if v})
    assert len(frames) == len(pngs) >= 4 and decoded_equal
    assert all(b in pngs for b in served) and len(served) == 2
    assert stats[1]["force_ip"] >= 0 and stats[2]["force_ip"] >= 0, stats
    assert stats[-1]["paused"] and shared.stop
    assert sv["tile_deformed_w128"] > 0, sv
    assert vs_plain >= TILE_BF16_DB, vs_plain
    del trainer, consts, state, pw

    # ---- the served frame's zlib level: frame 0 (full size) on this
    # machine's host at level 1 (the viewer's) and 6 (write_png's)
    q = np.clip(frames[0] * 255.0, 0, 255).astype(np.uint8)
    levels = {}
    for level in (1, 6):
        t0 = time.perf_counter()
        for _ in range(5):
            data = encode_png(q, level)
        levels[level] = {"ms": (time.perf_counter() - t0) * 1e3 / 5,
                         "bytes": len(data)}
    emit("png_levels", hw=list(q.shape[:2]), levels=levels,
         viewer_level=web_viewer.PNG_LEVEL)

    # ---- the train viewer on the mlp's workspace (bf16, static mode)
    c.reset_counts()
    t0 = time.perf_counter()
    main_viewer.main(p4["mlp_flags"] + [
        "--workspace", p4["ws"]["mlp"], "--mode", "train", "--frames",
        str(VIEWER["train_frames"]), "--port", "0", "--W", hw, "--H", hw,
        "--radius", "2.5"])
    torch.cuda.synchronize()
    tv = c.read_counts()
    add(tv)
    emit("train_viewer", frames=VIEWER["train_frames"],
         seconds=time.perf_counter() - t0,
         launches={k: v for k, v in tv.items() if v})
    assert tv["tile_static_w64"] > 0, tv

    # ---- distill_table at a smoke size (Wd 128, 200 + 200 steps, 2 poses)
    c.reset_counts()
    t0 = time.perf_counter()
    table = distill_table.main(DT_SMOKE + [
        "--out", os.path.join(root, "distill_table", "table.json")])
    torch.cuda.synchronize()
    dl = c.read_counts()
    add(dl)
    row = table["rows"][0]
    emit("distill_table_smoke", seconds=time.perf_counter() - t0,
         teacher_fit_seconds=table["teacher_fit_seconds"],
         image_psnr=row["image_psnr"], image_ssim=row["image_ssim"],
         field=row["field"], fps_800=row["fps_800"],
         launches={k: v for k, v in dl.items() if v})
    assert np.isfinite(row["image_psnr"]) and row["fps_800"] > 0
    assert dl["tile_deformed_w128"] > 0 and dl["tile_static_w128"] > 0, dl
    return launches


# the last modules, on main path 4's workspaces: LPIPS and CLIP at their
# published widths on seeded weights (the pretrained ones are not in the
# repository), the asset chain on the 2,000-step hash grid, and the sharded
# paths on two gloo ranks sharing the card
LPIPS = dict(hw=800, patch=32, samples=256, limit_rel=1e-4)
# ViT-B/16: vision (layers, width, heads, mlp, patch, image), text (layers,
# width, heads, mlp, vocabulary, positions), the projection
CLIP = dict(vision=(12, 768, 12, 3072, 16, 224),
            text=(12, 512, 8, 2048, 49408, 77), proj=512, frame=64,
            samples=64, radius=2.5, steps=3, limit=1e-4)
CHAIN = ["--distill_steps", "300", "--n_poses", "4", "--H", "256", "--W",
         "256"]


def main_path_6(c, p4) -> dict:
    """The last modules' phases: LPIPS (AlexNet-LPIPS on seeded weights in
    the lpips package's raw layout, loaded through $PIENERF_LPIPS_WEIGHTS)
    on an 800x800 frame pair and in a patch-32 train step of main path 4's
    mlp, each held against the CPU; CLIP ViT-B/16 on seeded weights, both
    towers against the CPU and three CLIP steps of the mlp at 64x64 ->
    224; tools/hashgrid_chain.py on main path 4's hash grid (distill 300
    steps, 4 poses at 256x256); parallel/dryrun.py on two gloo ranks
    sharing the card, its toy checks and the 896x800 band frame. Returns
    the kernels' launches by phase."""
    import glob
    import shutil

    import torch

    from pienerf_tpu_torch.data import synthetic
    from pienerf_tpu_torch.data.rays import get_rays_sampled
    from pienerf_tpu_torch.data.rays import sample_patch_indices
    from pienerf_tpu_torch.io.checkpoint import load_native
    from pienerf_tpu_torch.models import network
    from pienerf_tpu_torch.parallel import dryrun
    from pienerf_tpu_torch.render import renderer
    from pienerf_tpu_torch.tools import hashgrid_chain
    from pienerf_tpu_torch.train import clip_guidance as cg
    from pienerf_tpu_torch.train import lpips as lp
    from pienerf_tpu_torch.train import trainer as ttr
    from pienerf_tpu_torch.weights import (clip_to_torch, field_from_numpy,
                                           lpips_to_torch)

    dev, cpu = c.dev, torch.device("cpu")
    root = os.path.join(ROOT, "build", "smoke_path6")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    launches = {}

    # ---- LPIPS: seeded AlexNet-LPIPS weights in the raw layout, through
    # the weight file, on the card and the CPU
    rng = np.random.default_rng(0)
    raw = {}
    for i, ((ci, co, k, _, _), fi) in enumerate(zip(lp._ALEX,
                                                    lp._FEATURE_IDX)):
        raw[f"net.slice{i + 1}.{fi}.weight"] = rng.standard_normal(
            (co, ci, k, k), np.float32) * np.float32((2.0 / (ci * k * k))
                                                     ** 0.5)
        raw[f"net.slice{i + 1}.{fi}.bias"] = rng.standard_normal(
            co, np.float32) * np.float32(0.01)
        raw[f"lin{i}.model.1.weight"] = np.abs(rng.standard_normal(
            (1, co, 1, 1), np.float32)) / np.float32(co)
    wpath = os.path.join(root, "lpips_alex.npz")
    np.savez(wpath, **raw)
    os.environ["PIENERF_LPIPS_WEIGHTS"] = wpath
    w_np = lp.load_weights()
    w = [lpips_to_torch(w_np, d) for d in (dev, cpu)]
    hw = LPIPS["hw"]
    intr = (0.9 * hw, 0.9 * hw, hw / 2.0, hw / 2.0)
    poses = synthetic.orbit_poses(2, seed=7)
    frames = np.stack([synthetic.render_gt(p, intr, hw, hw, device=dev)
                       for p in poses]).astype(np.float32)
    vals = []                                   # card, CPU
    for j, d in enumerate((dev, cpu)):
        a, b = (torch.as_tensor(frames[i:i + 1], device=d) for i in (0, 1))
        t0 = time.perf_counter()
        with torch.no_grad():
            vals.append(float(lp.lpips(a, b, w[j])[0]))
        cpu_s = time.perf_counter() - t0
    a, b = (torch.as_tensor(frames[i:i + 1], device=dev) for i in (0, 1))
    with torch.no_grad():
        card_ms = cuda_ms(lambda: lp.lpips(a, b, w[0]), 5)
    frame_rel = abs(vals[0] / vals[1] - 1.0)

    # a patch-32 step of main path 4's mlp (f32) with the perceptual term:
    # one 32x32 patch of the first frame, card against CPU
    ck = sorted(glob.glob(os.path.join(p4["ws"]["mlp"], "checkpoints",
                                       "ngp_ep*.npz")))[-1]
    tree = load_native(ck)[0]["ema_params"]
    spec = network.make_spec(bound=1.0, backbone="mlp")
    k = LPIPS["samples"]
    st = renderer.RenderSettings(bound=1.0, cascade=1, min_near=0.05,
                                 max_samples=k)
    g = torch.Generator().manual_seed(3)
    p = LPIPS["patch"]
    inds = sample_patch_indices(g, hw, hw, p * p, p)
    ro, rd = get_rays_sampled(torch.as_tensor(poses[0]), intr, hw, hw, inds)
    batch = {"rays_o": ro, "rays_d": rd, "pixels": torch.as_tensor(
        frames[0].reshape(-1, 3))[inds]}
    draws = {"u_coarse": torch.rand((p * p, k // 2), generator=g),
             "u_fine": torch.rand((p * p, k - k // 2), generator=g)}
    res = []
    for j, d in enumerate((dev, cpu)):
        field = field_from_numpy(tree, spec, d, trainable=True)
        opt = ttr.make_optimizer(1e-2, 1000)
        step = ttr.make_train_step(spec, st, opt, use_fast_path=True,
                                   patch_size=p, lpips_weights=w[j])
        state, m = step(ttr.init_state(field, opt), None,
                        {a_: b_.to(d) for a_, b_ in batch.items()},
                        draws={a_: b_.to(d) for a_, b_ in draws.items()})
        res.append((float(m["loss"]), [q.cpu() for q in m["grads"]],
                    [q.detach().cpu() for q in state.params.leaves()]))
    (lc, gc, pc), (lh, gh, ph) = res
    p_err, flips, _, flips_ok = compare_steps(pc, ph, gh)
    step_rel = abs(lc / lh - 1.0)
    emit("lpips_card_vs_cpu", nvidia_smi=smi_line(), hw=hw,
         lpips_card=vals[0], lpips_cpu=vals[1], rel=frame_rel,
         limit_rel=LPIPS["limit_rel"], card_ms=card_ms, cpu_s=cpu_s,
         step_rays=p * p, step_samples=k, step_loss_card=lc,
         step_loss_cpu=lh, step_loss_rel=step_rel, param_max_abs=p_err,
         flips_below_floor=flips, checkpoint=os.path.relpath(ck, ROOT))
    assert np.isfinite(vals[0]) and vals[0] > 0
    assert frame_rel <= LPIPS["limit_rel"], vals
    assert np.isfinite(lc) and step_rel <= 1e-5, (lc, lh)
    assert p_err <= 1e-6 and flips_ok, p_err
    del w, res

    # ---- CLIP ViT-B/16: both towers on the card against the CPU, then
    # three CLIP steps of the mlp at 64x64 -> 224 on the card
    t0 = time.perf_counter()
    cparams = cg.import_hf_state_dict(
        cg.seeded_state_dict(0, CLIP["vision"], CLIP["text"], CLIP["proj"]),
        CLIP["vision"][2], CLIP["text"][2])
    make_s = time.perf_counter() - t0
    tp = [clip_to_torch(cparams, d) for d in (dev, cpu)]
    vocab, npos = CLIP["text"][4], CLIP["text"][5]
    ids = np.zeros((2, npos), np.int64)
    for i, n_tok in enumerate((7, 15)):
        ids[i, 0] = vocab - 2                       # start of text
        ids[i, 1:n_tok + 1] = rng.integers(1, vocab - 2, n_tok)
        ids[i, n_tok + 1] = vocab - 1               # end of text: pooled
    feats, secs = [], []                        # card, CPU
    for j, d in enumerate((dev, cpu)):
        t0 = time.perf_counter()
        with torch.no_grad():
            img = cg.preprocess(torch.as_tensor(frames, device=d),
                                CLIP["vision"][5])
            feats.append((cg.encode_image(tp[j], img).cpu(),
                          cg.encode_text(tp[j], torch.as_tensor(
                              ids, device=d)).cpu()))
        secs.append(time.perf_counter() - t0)
    img_err = float((feats[0][0] - feats[1][0]).abs().max())
    txt_err = float((feats[0][1] - feats[1][1]).abs().max())
    with torch.no_grad():
        img_d = cg.preprocess(torch.as_tensor(frames, device=dev),
                              CLIP["vision"][5])
        vis_ms = cuda_ms(lambda: cg.encode_image(tp[0], img_d), 5)
    guide = cg.CLIPGuidance(cparams, device=dev)
    guide.prepare_text(ids=ids[:1])
    fr = CLIP["frame"]
    field = field_from_numpy(tree, spec, dev, trainable=True)
    before = [q.detach().clone() for q in field.leaves()]
    opt = ttr.make_optimizer(1e-2, 1000)
    cstep = ttr.make_clip_step(
        spec, opt, guide.params, guide.text_z, fr, fr,
        (0.9 * fr, 0.9 * fr, fr / 2.0, fr / 2.0), radius=CLIP["radius"],
        num_samples=CLIP["samples"], clip_size=CLIP["vision"][5])
    state = ttr.init_state(field, opt)
    gen = torch.Generator(device=dev).manual_seed(0)
    losses = []
    t0 = time.perf_counter()
    for _ in range(CLIP["steps"]):
        state, loss = cstep(state, generator=gen)
        losses.append(float(loss))
    step_s = (time.perf_counter() - t0) / CLIP["steps"]
    moved = float(sum((q.detach() - b_).abs().sum()
                      for q, b_ in zip(state.params.leaves(), before)))
    emit("clip_card_vs_cpu", nvidia_smi=smi_line(),
         vision=list(CLIP["vision"]), text=list(CLIP["text"]),
         proj=CLIP["proj"], weights_seconds=make_s,
         image_features_max_abs=img_err, text_features_max_abs=txt_err,
         limit=CLIP["limit"], card_s=secs[0], cpu_s=secs[1],
         vision_tower_ms_batch2=vis_ms, step_frame=[fr, fr],
         step_losses=losses, step_s=step_s, params_moved=moved,
         steps=int(state.step))
    assert img_err <= CLIP["limit"] and txt_err <= CLIP["limit"], (
        img_err, txt_err)
    assert all(np.isfinite(losses)) and moved > 0.0, (losses, moved)
    del tp, guide, cstep, state, field

    # ---- tools/hashgrid_chain.py on main path 4's hash-grid teacher (a
    # workspace holding only that checkpoint: main_distill wrote the
    # student after it)
    ws = os.path.join(root, "chain_ws")
    os.makedirs(os.path.join(ws, "checkpoints"))
    for ext in ("", ".json"):
        shutil.copy(p4["teacher"] + ext, os.path.join(
            ws, "checkpoints", os.path.basename(p4["teacher"]) + ext))
    c.reset_counts()
    t0 = time.perf_counter()
    rep = hashgrid_chain.main(["--workspace", ws] + CHAIN)
    torch.cuda.synchronize()
    chain_s = time.perf_counter() - t0
    ch = c.read_counts()
    launches["asset_chain"] = ch
    asset = rep["asset"]
    emit("asset_chain", nvidia_smi=smi_line(), seconds=chain_s,
         roundtrip=rep["pth_roundtrip"]["bit_exact"],
         n_tensors=rep["pth_roundtrip"]["n_tensors"],
         points=rep["sampling"]["n_points"],
         pinned=rep["annotation"]["n_pinned"],
         distill=asset["distill"], field_agreement=asset["field_agreement"],
         image_psnr=asset["image_agreement"]["psnr_mean"],
         image_ssim=asset["image_agreement"]["ssim_mean"],
         sim_init=asset["sim_init"], interactive=asset["interactive"],
         launches={k_: v for k_, v in ch.items() if v})
    assert rep["pth_roundtrip"]["bit_exact"]
    assert rep["sampling"]["n_points"] > 200
    assert asset["interactive"]["fps"] > 0
    assert ch["tile_deformed_w64"] > 0 and ch["tile_static_w64"] > 0, ch

    # ---- parallel/dryrun.py: two gloo ranks sharing the card (NCCL
    # refuses two ranks on one card), the toy checks and the 896x800 band
    # frame, each against the same work in one process
    t0 = time.perf_counter()
    dr = dryrun.run(2, fast=True, production=("frame",), device="cuda",
                    backend="gloo", threads=2)
    dr_s = time.perf_counter() - t0
    sharded = {}
    for r_ in dr.values():
        for k_, v in r_.pop("launches").items():
            sharded[k_] = sharded.get(k_, 0) + v
    launches["sharded"] = sharded
    emit("sharded_dryrun", nvidia_smi=smi_line(), ranks=2, backend="gloo",
         seconds=dr_s, checks=dr, launches_rank0=sharded)
    f896 = dr["frame_production"]
    assert f896["hw"] == [896, 800] and f896["max_abs"] < 2e-3, f896
    assert dr["frame_production_paired"]["max_abs"] < 2e-3
    assert printed(sharded, "tile_deformed_w64_default") > 0, sharded
    return launches


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(1)

    import pienerf_tpu_torch  # noqa: F401  (precision policy)
    from pienerf_tpu_torch.io.checkpoint import load_native, save_native
    from pienerf_tpu_torch.kernels import _build
    from pienerf_tpu_torch.kernels import field as fk
    from pienerf_tpu_torch.kernels import probes as pk
    from pienerf_tpu_torch.kernels import tile as tk
    from pienerf_tpu_torch.models import network
    from pienerf_tpu_torch.ops import beam_bend
    from pienerf_tpu_torch.render import interactive, pipeline
    from pienerf_tpu_torch.io.ply import read_ply, write_ply
    from pienerf_tpu_torch.sim import solver as sim
    from pienerf_tpu_torch.tools import gather_probe, micro_floor
    from pienerf_tpu_torch.tools.timing import ms_per_call
    from pienerf_tpu_torch.weights import field_from_numpy

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    def reset_counts():
        fk.field_eval.launches = dict.fromkeys(fk.field_eval.launches, 0)
        tk.render_tiles.launches = dict.fromkeys(tk.render_tiles.launches, 0)
        for fn in pk.FETCH_FNS.values():
            fn.launches = 0
        pk.floor_shell.launches = 0

    def tile_name(mode, wd, schedule):
        return (f"tile_{mode}_paired" if schedule == "paired" else
                f"tile_{mode}_{tk.net_label(wd)}"
                + ("_block" if schedule == "block" else ""))

    def read_counts():
        """Every kernel's launches since the last reset; a tile entry sums
        its two dtypes (read_f32_counts splits the f32 ones out)."""
        out = {f"field_w{w}" + ("_bf16" if t == "bfloat16" else ""): k
               for (w, t), k in fk.field_eval.launches.items()}
        for (m, wd, sch, _), k in tk.render_tiles.launches.items():
            name = tile_name(m, wd, sch)
            out[name] = out.get(name, 0) + k
        out.update({f"fetch_{n}": fn.launches
                    for n, fn in pk.FETCH_FNS.items()})
        out["floor_shell"] = pk.floor_shell.launches
        return out

    def read_f32_counts():
        """The tile kernel's f32 launches since the last reset, by
        read_counts' names."""
        return {tile_name(m, wd, sch): k for (m, wd, sch, t), k
                in tk.render_tiles.launches.items() if t == "float32"}

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
    base_procs = start_baseline(_build)
    rep = _build.build()
    ptxas = {k: ptxas_report(v["log"]) for k, v in rep.items()}
    fetch_smem = _build.library("probes").pienerf_fetch_smem_bytes
    fetch_smem.restype = ctypes.c_longlong
    fetch_smem.argtypes = [ctypes.c_int]
    for rows in ptxas.values():
        for r in rows:
            if "inst" in r:
                r["resident_blocks"], r["dynamic_smem_bytes"] = occupancy(
                    _build, r.pop("inst"))
            elif r["kernel"] in ("onehot_fetch", "dma_fetch",
                                 "dynslice_fetch"):
                r["dynamic_smem_bytes"] = fetch_smem(
                    pk.FETCHES.index(r["kernel"][:-len("_fetch")]))
    # per library: its nvcc's seconds (all start together) and its kernel
    # entries; no entry may have its warpgroup MMAs serialised
    serialized = [ln.strip() for v in rep.values()
                  for ln in v["log"].splitlines()
                  if WGMMA_SERIALIZED.search(ln)]
    emit("build", seconds=time.perf_counter() - t0,
         nvcc_s={k: v["seconds"] for k, v in rep.items()},
         entries={k: len(v) for k, v in ptxas.items()}, ptxas=ptxas,
         wgmma_serialized=serialized)
    assert not serialized, serialized
    if base_procs:
        finish_baseline(base_procs)
        emit("baseline", source=os.environ[BASELINE_ENV],
             libraries=sorted(BASELINE_LIBS),
             seconds=time.perf_counter() - t0)

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
        64: field_check("field_kernel", fk, pw, (spec32, spec16), rng),
        128: field_check("field_kernel_w128", fk, pw_fill,
                         (spec32_w, spec16_w), rng)}
    # the checkpoint embedded in the 128-wide net: every f32 output is the
    # same FMA chain with exact zeros added, so Wd 128 equals Wd 64
    n_emb, rng_e = 1 << 20, np.random.RandomState(1)
    x_emb = torch.as_tensor(rng_e.uniform(-1, 1, (3, n_emb)).astype(
        np.float32), device=dev)
    d_emb = torch.as_tensor(rng_e.randn(3, n_emb).astype(np.float32),
                            device=dev)
    d_emb = (d_emb / d_emb.norm(dim=0, keepdim=True)).contiguous()
    e64 = fk.field_eval(pw, spec32, x_emb, d_emb)
    e128 = fk.field_eval(pw_w, spec32_w, x_emb, d_emb)
    torch.cuda.synchronize()
    emb_equal = bool(torch.equal(e64[0], e128[0])
                     and torch.equal(e64[1], e128[1]))
    emit("field_kernel_embedded", n=n_emb, equal=emb_equal,
         max_abs_diff=max(float((e64[0] - e128[0]).abs().max()),
                          float((e64[1] - e128[1]).abs().max())))
    assert emb_equal

    # ---- the bf16 MLP alone on the tensor cores: the field kernel at
    # N = 2^20, both widths, against its operation bound
    n_mlp = 1 << 20
    x_mlp = torch.as_tensor(rng.uniform(-1, 1, (3, n_mlp)).astype(
        np.float32), device=dev)
    d_mlp = torch.as_tensor(rng.randn(3, n_mlp).astype(np.float32),
                            device=dev)
    d_mlp = (d_mlp / d_mlp.norm(dim=0, keepdim=True)).contiguous()
    for wd, weights, spec in ((64, pw, spec16), (128, pw_fill, spec16_w)):
        r_ = timed_turns(lambda: fk.field_eval(weights, spec, x_mlp, d_mlp),
                         20, hold=field_hold(False))
        flops = 2.0 * FIELD_MACS[wd] * n_mlp
        bound = max(flops / PEAK_BF16, (FIELD_IO * n_mlp + weights.numel()
                                        * 4) / PEAK_BYTES) * 1e3
        share = {"share_of_bf16_peak": bound / r_["ms"]}
        if "before_ms" in r_:
            share["before_share_of_bf16_peak"] = bound / r_["before_ms"]
        emit("field_mlp_bf16", width=wd, n=n_mlp, bound_ms=bound,
             tflop_per_s=flops / (r_["ms"] * 1e-3) / 1e12, **r_, **share,
             pr4_ms=PRIOR_FIELD_BF16_MS[wd], pr13_ms=PR13_MS[
                 "field_kernel" + ("_w128" if wd == 128 else "")])

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

    def spring(st, fi):
        # the GUI's spring drag toward a target orbiting the IP (bench.py)
        p_ip = vid_rest + torch.einsum("ia,iad->d", vid_nx,
                                       st.ddof[vid_kernel])
        ang = torch.tensor(0.25 * fi, device=dev)
        target = vid_rest + 0.25 * torch.stack(
            [torch.cos(ang), torch.sin(ang), torch.zeros((), device=dev)])
        return torch.clamp(1e5 * (target - p_ip), -5e5, 5e5)

    def frame(st, fi, settings, weights):
        return pipeline.interactive_frame_step(
            settings, consts, st, weights, pose, intr, H, W, 1.0, vid,
            spring(st, fi))

    path3 = types.SimpleNamespace(
        dev=dev, pose=pose, intr=intr, field=field, pw=pw, spec32=spec32,
        consts=consts, state_rest=state_rest, vid=vid, spring=spring,
        reset_counts=reset_counts, read_counts=read_counts,
        read_f32_counts=read_f32_counts, only=only)

    from torch.profiler import ProfilerActivity, profile

    def chained(phase, settings, weights, tile_key, n_reps=3, n_prof=5):
        """Main path 1 with these settings and weights: 20 chained frames
        with the launch counts read around them, then n_reps x 10 timed
        frames and n_prof under torch.profiler (where a frame's time goes: the stages
        are the port's frame.* spans). Returns (frame-0 state, frame-0
        counters, launches, and frame 0's image with the median ms per
        frame and the tile kernel's device ms per frame)."""
        reset_counts()
        state = state_rest
        for fi in range(20):
            state, out = frame(state, fi, settings, weights)
            if fi == 0:
                state0 = state
                img0 = out["tiles_image"]
                counters0 = {k: int(out[k]) for k in
                             ("dropped_beam", "dropped_window",
                              "n_tile_overflow", "n_active")}
            assert bool(torch.isfinite(out["tiles_image"]).all()), fi
            assert bool(torch.isfinite(state.ddof).all()), fi
            assert int(out["n_active"]) > 0, fi
        torch.cuda.synchronize()
        launches = read_counts()
        f32_launches = read_f32_counts()
        assert launches == only(**{tile_key: 20}), launches
        reps = []
        fi = 20
        for _ in range(n_reps):
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
            for _ in range(n_prof):
                state, out = frame(state, fi, settings, weights)
                fi += 1
            torch.cuda.synchronize()
        fp = frame_profile(prof, n_prof, float(np.median(reps)))
        emit(f"{phase}_profile", **fp)
        return state0, counters0, launches, dict(
            img0=img0, ms_per_frame=float(np.median(reps)),
            tile_kernel_ms=fp["tile_kernel_device_ms"],
            f32_launches=f32_launches)

    # ---- main path 1
    state0, drops0, frame_launches, frame_info = chained(
        "frame", ist, pw, "tile_deformed_w64")
    # the same frame in f32, as the README's viewer command runs it (Wd 64,
    # --max_iter_num 1, --num_seek_IP 3, no -O): the tile kernel's f32
    # instantiation on the CUDA cores
    ist32 = ist._replace(spec=spec32)
    _, _, _, f32frame_info = chained("frame_f32", ist32, pw,
                                     "tile_deformed_w64", n_prof=2)
    assert f32frame_info["f32_launches"]["tile_deformed_w64"] == 20
    if BASELINE_LIBS:
        def frames_ms(n=20, n_prof=5):
            """A chained f32 frame from rest: ms a frame over n (host clock
            to a sync), then the device's busy ms and the tile kernel's
            device ms a frame over n_prof more under torch.profiler."""
            st = state_rest
            st, _ = frame(st, 0, ist32, pw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for fi in range(1, n + 1):
                st, _ = frame(st, fi, ist32, pw)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / n * 1e3
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for fi in range(n + 1, n + 1 + n_prof):
                    st, _ = frame(st, fi, ist32, pw)
                torch.cuda.synchronize()
            fp = frame_profile(prof, n_prof, ms)
            return ms, fp["device_busy_ms"], fp["tile_kernel_device_ms"]
        b_ = [on_baseline(frames_ms)]
        n_ = [frames_ms(), frames_ms()]
        b_.append(on_baseline(frames_ms))
        emit("frame_f32_ab", **{
            f"{side}{name}": [r[i] for r in reps]
            for side, reps in (("", n_), ("before_", b_))
            for i, name in enumerate(("ms_per_frame", "device_busy_ms",
                                      "tile_kernel_ms"))})

    # ---- tile kernel against its plain version at frame 0's state, both
    # widths (the inputs do not depend on the width)
    p_def, F, dF = sim.get_ip_info(consts, state0)
    pack = beam_bend.pack_ip_data_fast(p_def, consts.ip_pos.float(), F, dF)
    (_, o, bbmin, bbmax, act_ids, act_mask, _, _) = interactive.active_tiles(
        ist, p_def, pose, intr, H, W, ist.tile_chunk)
    args, kw, _ = interactive.tile_kernel_inputs(
        ist, pack, p_def, o, pose, intr, H, W, act_ids, act_mask, bbmin,
        bbmax)
    tile_rows = tile_check("tile_kernel", tk, (spec32, spec16), pw, args,
                           kw)
    tile_row = tile_rows["bfloat16"]
    # each window lands by one bulk copy, which takes only 16-byte-aligned
    # addresses: the wrapper refuses candidates off that boundary, before
    # any launch
    cand_off = torch.empty(args[4].numel() + 4, device=dev)[1:1 + args[4]
                                                           .numel()]
    cand_off = cand_off.view_as(args[4])
    cand_off.copy_(args[4])
    try:
        tk.render_tiles(spec16, pw, *args[:4], cand_off, **kw)
        raise AssertionError("render_tiles took candidates off 16 bytes")
    except ValueError as e:
        if "16-byte" not in str(e):
            raise
    tile_rows_w = tile_check("tile_kernel_w128", tk, (spec32_w, spec16_w),
                             pw_fill, args, kw, pw_f32=pw_w)
    tile_row_w = tile_rows_w["bfloat16"]

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
    fid_f32 = read_f32_counts()
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
    _, drops0_w, wframe_launches, _ = chained("wide_frame", ist_w, pw_w,
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
    wfid_f32 = read_f32_counts()
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

    # ---- the Newton frame under -O (main_gui's fp16 preset: the field
    # kernel in bf16, on the tensor cores) at both widths. Its reference is
    # the same frame with the field's plain version swapped in; the control,
    # the f32 frame read against that reference, must fail the limit
    # (TILE_BF16_DB: the composite is the tile kernel's)
    newton16_launches = {}
    for wd, spec, weights in ((64, spec16, pw), (128, spec16_w, pw_w)):
        ist16 = ist_n._replace(spec=spec)
        reset_counts()
        out16 = interactive.render_frame(ist16, weights, pack48, p_def, pose,
                                         intr_r, r, r, 1.0)
        torch.cuda.synchronize()
        launches16 = read_counts()
        key = f"field_w{wd}_bf16"
        newton16_launches[wd] = launches16[key]
        ms16 = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            interactive.render_frame(ist16, weights, pack48, p_def, pose,
                                     intr_r, r, r, 1.0)
            torch.cuda.synchronize()
            ms16.append((time.perf_counter() - t0) * 1e3)
        out32 = interactive.render_frame(
            ist16._replace(spec=spec._replace(compute_dtype="float32")),
            weights, pack48, p_def, pose, intr_r, r, r, 1.0)
        interactive.field_kernel = types.SimpleNamespace(
            field_eval=fk.field_eval_plain)
        try:
            out16p = interactive.render_frame(ist16, weights, pack48, p_def,
                                              pose, intr_r, r, r, 1.0)
        finally:
            interactive.field_kernel = fk
        img16, img16p, img32 = (interactive.tiles_to_image(
            o["tiles_image"], r, r) for o in (out16, out16p, out32))
        frame16 = {k: int(out16[k]) for k in newton0}
        row16 = dict(width=wd, frame0=frame16, ms_reps=ms16,
                     ms_median=float(np.median(ms16)),
                     psnr_vs_plain=psnr(img16, img16p),
                     control_psnr_vs_plain=psnr(img32, img16p),
                     limit_db=TILE_BF16_DB, launches=launches16)
        emit("newton_frame_bf16", **row16)
        assert bool(np.isfinite(img16).all())
        assert frame16 == newton0, row16
        assert launches16 == only(**{key: launches16[key]}), launches16
        assert launches16[key] > 0
        assert row16["psnr_vs_plain"] >= TILE_BF16_DB, row16
        assert row16["control_psnr_vs_plain"] < TILE_BF16_DB, row16

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
            cut_img0 = out["tiles_image"]
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
    rows_c, rows_c32 = {}, {}
    for suffix, specs, weights, w32 in (
            ("", (spec32, spec16), pw, None),
            ("_w128", (spec32_w, spec16_w), pw_fill, pw_w)):
        for mode, a_, k_, lim in (("static", args_s, kw_s,
                                   TILE_BF16_DB_STATIC),
                                  ("cut", args_b, kw_b, TILE_BF16_DB)):
            r_ = tile_check(f"tile_kernel_{mode}{suffix}", tk, specs,
                            weights, a_, k_, limit_db=lim, pw_f32=w32)
            rows_c[mode + suffix] = r_["bfloat16"]
            rows_c32[mode + suffix] = r_["float32"]

    # ---- torch-ngp's hash-grid field at its published widths (the default
    # grid at bound 1: 16 levels x 2, 2^19 rows a level, 6,119,864 rows;
    # seeded random nets and table, as the trainer starts them): main path
    # 1 with it, then its tile kernel in each mode on the same passes'
    # inputs against its plain version, with the counters' cost
    spec_g = network.make_spec(bound=1.0, backbone="hashgrid")
    pw_g = fk.pack_weights(network.FieldMLP(
        spec_g, generator=torch.Generator().manual_seed(0), device=dev),
        spec_g, dev)
    _, _, grid_launches, grid_info = chained(
        "frame_hashgrid", ist._replace(spec=spec_g), pw_g,
        "tile_deformed_hashgrid", n_prof=2)
    grid_rows = hashgrid_rows(tk, spec_g, pw_g, {
        "deformed": (args, kw), "static": (args_s, kw_s),
        "cut": (args_b, kw_b)})

    # ---- where the tile kernel's cycles go: the timed instantiation on
    # the bench inputs (deformed, both widths) and the cut pass's, with
    # the timed and untimed instantiations' resident blocks per SM
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    split_rows = {}
    for mode, wd, weights, spec, a_, k_, base in (
            ("deformed", 64, pw, spec16, args, kw, tile_row),
            ("deformed", 128, pw_fill, spec16_w, args, kw, tile_row_w),
            ("cut", 64, pw, spec16, args_b, kw_b, rows_c["cut"]),
            # the f32 MLP's share of the same tiles
            ("deformed", 64, pw, spec32, args, kw, tile_rows["float32"]),
            ("deformed", 128, pw_fill, spec32_w, args, kw,
             tile_rows_w["float32"]),
            ("cut", 64, pw, spec32, args_b, kw_b, rows_c32["cut"])):
        inst = dict(kernel="tile", mode=mode, wd=wd,
                    bf16=spec.compute_dtype == "bfloat16", paired=False,
                    block=False)
        res_t = occupancy(_build, dict(inst, timed=True))[0]
        res_u = occupancy(_build, dict(inst, timed=False))[0]
        res_b = (on_baseline(lambda: occupancy(_build, dict(
            inst, timed=True))[0]) if "tile_timed" in BASELINE_LIBS
            else None)
        split_rows[mode, wd, spec.compute_dtype] = tile_split(
            "tile_split", tk, spec, weights, a_, k_, base, res_t, n_sm,
            before_resident=res_b, untimed_resident_blocks=res_u)

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
    cfid_f32 = read_f32_counts()
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

    # ---- the paired schedule (the 64-wide net from the block-diagonal
    # pack) in the three modes, on the inputs of the checks above: against
    # its plain version, and bit for bit against the default schedule
    pw_p = fk.pack_weights_paired(field, spec32, dev)
    rows_p = {
        "deformed": variant_check(
            "tile_kernel_paired", tk, (spec32, spec16), pw, pw_p, args, kw,
            base_row=tile_row, base_row32=tile_rows["float32"]),
        "static": variant_check(
            "tile_kernel_paired_static", tk, (spec32, spec16), pw, pw_p,
            args_s, kw_s, limit_db=TILE_BF16_DB_STATIC,
            base_row=rows_c["static"], base_row32=rows_c32["static"]),
        "cut": variant_check(
            "tile_kernel_paired_cut", tk, (spec32, spec16), pw, pw_p, args_b,
            kw_b, base_row=rows_c["cut"], base_row32=rows_c32["cut"])}

    # ---- block_tiles: B = 4, and the first odd B that does not divide the
    # slot count (the bench's 1,248 slots take 5, the cut pass's 3),
    # against B = 1, in one mode per width
    def odd_b(n_slots):
        return next(b for b in (3, 5, 7) if n_slots % b)
    rows_b = {}
    for B in (4, odd_b(args[0].shape[0])):
        rows_b[64, B] = variant_check(
            "tile_kernel_block", tk, (spec32, spec16), pw, pw, args, kw,
            block_tiles=B, base_row=tile_row, base_row32=tile_rows["float32"])
    for B in (4, odd_b(args_b[0].shape[0])):
        # on the embedded checkpoint, where tile_check holds the wide f32
        # rule (a filled pack can flip a ray's T_thresh test against the
        # plain version's summation order)
        rows_b[128, B] = variant_check(
            "tile_kernel_block_w128", tk, (spec32_w, spec16_w), pw_w, pw_w,
            args_b, kw_b, block_tiles=B, base_row=rows_c["cut_w128"])
    # both at once
    variant_check("tile_kernel_paired_block", tk, (spec32, spec16), pw, pw_p,
                  args, kw, block_tiles=4, base_row=tile_row)

    # ---- the bench frame through each schedule: frame 0 is the default
    # frame bit for bit, counters included
    _, drops0_p, pframe_launches, pframe_info = chained(
        "paired_frame", ist, pw_p, "tile_deformed_paired", n_reps=1,
        n_prof=2)
    _, drops0_b, bframe_launches, bframe_info = chained(
        "block_frame", ist._replace(block_tiles=4), pw,
        "tile_deformed_w64_block", n_reps=1, n_prof=2)
    for name, d0, info in (("paired_frame", drops0_p, pframe_info),
                           ("block_frame", drops0_b, bframe_info)):
        equal = bool(torch.equal(info["img0"], frame_info["img0"]))
        emit(name, frame0=d0, frame0_equals_default=equal,
             ms_per_frame=info["ms_per_frame"],
             default_ms_per_frame=frame_info["ms_per_frame"],
             tile_kernel_ms=info["tile_kernel_ms"],
             default_tile_kernel_ms=frame_info["tile_kernel_ms"])
        assert d0 == drops0 and equal, (name, d0, drops0)

    # main path 2 with the paired pack: the cache pass (paired static) and
    # 10 chained cut frames (paired cut), frame 0 equal to the default's
    reset_counts()
    cache_p = interactive.render_static_cache(ist_c, pw_p, pose, intr_c, Hc,
                                              Wc, cb)
    state = rest_c
    for fi in range(10):
        state, out = cut_frame(state, fi, cache_p, ist_c, pw_p)
        if fi == 0:
            cut0_p = {k: int(out[k]) for k in cut0_w}
            cut_equal = bool(torch.equal(out["tiles_image"], cut_img0))
        assert bool(torch.isfinite(out["tiles_image"]).all()), fi
    torch.cuda.synchronize()
    pcut_launches = read_counts()
    emit("paired_cut_frame", frame0=cut0_p, frame0_equals_default=cut_equal,
         launches=pcut_launches)
    assert pcut_launches == only(tile_static_paired=1, tile_cut_paired=10), \
        pcut_launches
    assert cut_equal and all(cut0_p[k] == cut0[k] for k in cut0_p)

    # ---- the row-fetch probes as the tool runs them (B = 65,536 rows of
    # 512 bytes; tables of 2^11, 2^13 and 2^19 rows): every arm equals
    # table[idx] or the tool raises
    PROBE_ROWS, PROBE_T = 1 << 16, 1 << 13
    reset_counts()
    probe = gather_probe.run(dev, PROBE_ROWS, [1 << 11, PROBE_T, 1 << 19],
                             seed=0, reps=20)
    torch.cuda.synchronize()
    probe_launches = read_counts()
    assert probe_launches == only(**{f"fetch_{n}": probe_launches[
        f"fetch_{n}"] for n in pk.FETCHES}), probe_launches
    # the kernels line reads each fetch at T = 2^13: error against the
    # plain version, the plain version's ms, the bytes this run's indices
    # need (the rows they name read once, the output written once)
    rng_p = np.random.RandomState(0)
    table = torch.as_tensor(rng_p.standard_normal(
        (PROBE_T, pk.ROW)).astype(np.float32), device=dev)
    idx = torch.as_tensor(rng_p.randint(0, PROBE_T, PROBE_ROWS).astype(
        np.int32), device=dev)
    ref = pk.fetch_plain(table, idx)
    fetch_plain_ms = ms_per_call(lambda: pk.fetch_plain(table, idx), dev, 20)
    fetch_bytes = (int(torch.unique(idx).numel()) * pk.ROW * 4
                   + PROBE_ROWS * 4 + PROBE_ROWS * pk.ROW * 4)
    fetch_rows = {}
    for n, arm in zip(pk.FETCHES, ("A_onehot", "D_dma", "E_take",
                                   "B_dynslice")):
        out_n = pk.FETCH_FNS[n](table, idx)
        fetch_rows[n] = dict(
            max_abs_err=float((out_n - ref).abs().max()),
            equal=bool(torch.equal(out_n, ref)),
            ms=probe[f"{arm}_T{PROBE_T}"]["ms_per_call"],
            plain_ms=fetch_plain_ms,
            bound_ms=fetch_bytes / PEAK_BYTES * 1e3, bound_by="bytes",
            library_ms=probe[f"C_index_select_T{PROBE_T}"]["ms_per_call"])
        assert fetch_rows[n]["equal"], n
    # the one-hot arm's own mechanism: three bf16 parts of the table, each
    # a dense [B, T] . [T, 128] product on the tensor cores
    oh_ms = fetch_rows["onehot"]["ms"]
    oh_bound = 3 * 2.0 * PROBE_ROWS * PROBE_T * pk.ROW / PEAK_BF16 * 1e3
    onehot_ops = dict(ops_bound_ms=oh_bound, ops_bound_by="operations",
                      share_of_bf16_peak=oh_bound / oh_ms,
                      vs_library=oh_ms / fetch_rows["onehot"]["library_ms"])
    for n in ("dma", "dynslice"):
        fetch_rows[n]["vs_library"] = (fetch_rows[n]["ms"]
                                       / fetch_rows[n]["library_ms"])
    probe_bounds = {
        T: (u * pk.ROW * 4 + PROBE_ROWS * 4 + PROBE_ROWS * pk.ROW * 4)
        / PEAK_BYTES * 1e3 for T, u in probe.pop("unique_rows").items()}
    # a bulk copy takes only 16-byte-aligned addresses: the wrapper refuses
    # a table that starts off that boundary, before any launch
    try:
        pk.dma_fetch(table.view(-1)[1:1 + 512 * pk.ROW].view(512, pk.ROW),
                     idx[:512] % 512)
        raise AssertionError("dma_fetch took a table off 16 bytes")
    except ValueError as e:
        if "16-byte" not in str(e):
            raise
    emit("gather_probe", rows=PROBE_ROWS, row_bytes=pk.ROW * 4, arms=probe,
         onehot_T8192=onehot_ops,
         bound_ms_by_table=probe_bounds,
         bound_g_rows_per_s_read_only=PEAK_BYTES / (pk.ROW * 4) / 1e9,
         bound_g_rows_per_s_read_write=PEAK_BYTES / (2 * pk.ROW * 4) / 1e9,
         launches=probe_launches, kernels_line_T=PROBE_T,
         fetch_plain_ms=fetch_plain_ms)

    # ---- the tile kernel's shell: six arms at A = 1248 as the tool runs
    # them (all slots inactive), then with some slots active
    SHELL_A, SHELL_B, SHELL_BS, SHELL_P = 1248, 4, 134, 256
    reset_counts()
    floor_ms = micro_floor.run(dev, SHELL_A, SHELL_B, SHELL_BS, SHELL_P,
                               reps=50)
    torch.cuda.synchronize()
    floor_launches = read_counts()
    assert floor_launches == only(floor_shell=floor_launches["floor_shell"])
    sc_act = torch.zeros((SHELL_A, 8), device=dev)
    sc_act[:, 2] = torch.as_tensor(
        rng_p.randint(0, 2, SHELL_A).astype(np.float32), device=dev)
    shell_ref = pk.floor_shell_plain(sc_act)
    shell_err = 0.0
    for arm in micro_floor.ARMS:
        out_a = pk.floor_shell(*micro_floor.arm_inputs(
            arm, sc_act, SHELL_BS, SHELL_P), block_tiles=SHELL_B)
        assert torch.equal(out_a, shell_ref), arm
        shell_err = max(shell_err, float((out_a - shell_ref).abs().max()))
    assert float(shell_ref.sum()) == 256.0 * float(sc_act[:, 2].sum()) > 0
    shell_bytes = SHELL_A * (8 * 4 + SHELL_BS * 4 + 8 * 256 * 4
                             + SHELL_P * 16 * 4 + 8 * 256 * 4)
    shell_row = dict(
        max_abs_err=shell_err, ms=floor_ms["full"],
        plain_ms=ms_per_call(lambda: pk.floor_shell_plain(sc_act), dev, 20),
        bound_ms=shell_bytes / PEAK_BYTES * 1e3, bound_by="bytes")
    emit("micro_floor", tiles=SHELL_A, block_tiles=SHELL_B, ms=floor_ms,
         launches=floor_launches, plain_ms=shell_row["plain_ms"],
         bound_ms=shell_row["bound_ms"])

    # ---- the large-scene simulator: the pinned sphere at a sim_dx that
    # puts it above the dense-operator threshold, so the chunked operator
    # runs; init through the cache (a miss, then a hit)
    import shutil
    dx_big = 0.036
    cb_ = np.arange(-r0, r0 + 1e-6, dx_big)
    xb, yb, zb = np.meshgrid(cb_, cb_, cb_, indexing="ij")
    pts_big = np.stack([xb.ravel(), yb.ravel(), zb.ravel()], 1)
    pts_big = pts_big[np.linalg.norm(pts_big, axis=1) <= r0]
    nb = pts_big.shape[0]
    pin_big = pts_big[:, 2] < -0.3
    big_args = (pts_big, np.full(nb, 0.1), np.full(nb, 1e5),
                np.full(nb, 1e5), pin_big)
    big_kw = dict(dt=1e-2, iters=10, bbox=np.array([2.0, 2.0, 2.0]), kres=7,
                  dx=dx_big, gravity=(0.0, 0.0, 0.0), stiff=1e5,
                  base=np.array([-1.0, -1.0, -1.0]))
    cache_dir = os.path.join(ROOT, "build", "smoke_sim_cache")
    shutil.rmtree(cache_dir, ignore_errors=True)
    t0 = time.perf_counter()
    consts_b, rest_b, aux_b = sim.sim_init_cached(
        *big_args, cache_dir=cache_dir, device=dev, **big_kw)
    miss_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    consts_h, _, aux_h = sim.sim_init_cached(
        *big_args, cache_dir=cache_dir, device=dev, **big_kw)
    hit_s = time.perf_counter() - t0
    n_ip_b = int(aux_b["n_ip"])
    assert 6500 <= n_ip_b <= 10000 and consts_b.B is None, n_ip_b
    assert len(os.listdir(cache_dir)) == 1 and int(aux_h["n_ip"]) == n_ip_b
    for name in sim.SimConstants._fields:
        a_, b_ = getattr(consts_b, name), getattr(consts_h, name)
        assert (torch.equal(a_, b_) if isinstance(a_, torch.Tensor)
                else a_ == b_), name
    t0 = time.perf_counter()
    consts_d, rest_d, _ = sim.sim_init(*big_args, device=dev,
                                       dense_operator=True, **big_kw)
    dense_init_s = time.perf_counter() - t0
    vid_b = int(np.argmax(consts_b.ip_pos[:, 2].cpu().numpy()))

    def spring_b(st, fi):
        p_ip = consts_b.ip_pos[vid_b] + torch.einsum(
            "ia,iad->d", consts_b.IP_Nx[vid_b],
            st.ddof[consts_b.IP_kernel[vid_b]])
        ang = torch.tensor(0.25 * fi, device=dev)
        target = consts_b.ip_pos[vid_b] + 0.25 * torch.stack(
            [torch.cos(ang), torch.sin(ang), torch.zeros((), device=dev)])
        return torch.clamp(1e5 * (target - p_ip), -5e5, 5e5)

    # 20 spring-drag steps on the chunked operator; the dense operator
    # follows the same forces; every chunked step runs twice from the same
    # state (the node scatter is deterministic)
    st_c, st_d = rest_b, rest_d
    dense_err = 0.0
    for fi in range(20):
        f = spring_b(st_c, fi)
        st_in = sim.update_force(consts_b, st_c, vid_b, f)
        st_c = sim.sim_step(consts_b, st_in)
        assert torch.equal(sim.sim_step(consts_b, st_in).ddof, st_c.ddof), fi
        st_d = sim.sim_step(consts_d, sim.update_force(consts_d, st_d, vid_b,
                                                       f))
        dense_err = max(dense_err, float(
            (st_d.ddof - st_c.ddof).abs().max() / st_c.ddof.abs().max()))
    assert bool(torch.isfinite(st_c.ddof).all())
    pts_def = sim.point_positions(consts_b, st_c).cpu().numpy()
    pin_move = float(np.abs(pts_def[pin_big] - pts_big[pin_big]).max())
    free_move = float(np.abs(pts_def - pts_big).max())

    def step_ms(consts, st):
        sim.sim_step(consts, st)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            st = sim.sim_step(consts, st)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(st.ddof).all())
        return (time.perf_counter() - t0) / 5 * 1e3
    consts_bf = sim.cast_B_bf16(consts_b)
    ms_chunked = [step_ms(consts_b, st_c)]
    ms_dense = [step_ms(consts_d, st_d), step_ms(consts_d, st_d)]
    ms_chunked.append(step_ms(consts_b, st_c))
    ms_bf16 = step_ms(consts_bf, st_c)
    st_bf = sim.sim_step(consts_bf, st_c)
    bf16_err = float((st_bf.ddof - sim.sim_step(consts_b, st_c).ddof).abs()
                     .max() / st_c.ddof.abs().max())
    # the long drag: LONG_DRAG_STEPS spring steps from rest under bf16
    # storage beside the f32 trajectory, each dragged by its own spring
    st32, st16, drift = rest_b, rest_b, []
    t0 = time.perf_counter()
    for fi in range(LONG_DRAG_STEPS):
        st32 = sim.sim_step(consts_b, sim.update_force(
            consts_b, st32, vid_b, spring_b(st32, fi)))
        st16 = sim.sim_step(consts_bf, sim.update_force(
            consts_bf, st16, vid_b, spring_b(st16, fi)))
        if (fi + 1) % LONG_DRAG_EVERY == 0:
            assert bool(torch.isfinite(st16.ddof).all()), fi
            drift.append(float((st16.ddof - st32.ddof).abs().max()
                               / st32.ddof.abs().max()))
    long_drag = dict(steps=LONG_DRAG_STEPS, every=LONG_DRAG_EVERY,
                     drift_rel=drift,
                     finite=True, seconds=time.perf_counter() - t0)
    # one coupled frame on it, through the tile kernel
    ist_big = ist._replace(bend=bst._replace(ip_dx=1.05 * dx_big))
    reset_counts()
    st_f, out_big = pipeline.interactive_frame_step(
        ist_big, consts_b, st_c, pw, pose, intr, H, W, 1.0, vid_b,
        spring_b(st_c, 20))
    torch.cuda.synchronize()
    big_launches = read_counts()
    t0 = time.perf_counter()
    pipeline.interactive_frame_step(ist_big, consts_b, st_f, pw, pose, intr,
                                    H, W, 1.0, vid_b, spring_b(st_f, 21))
    torch.cuda.synchronize()
    big_frame_ms = (time.perf_counter() - t0) * 1e3
    emit("big_sim", sim_dx=dx_big, n_ip=n_ip_b, n_k=int(aux_b["n_k"]),
         chunks=list(consts_b.chunk_mu.shape),
         node_gather=list(consts_b.node_gather.shape),
         init_miss_s=miss_s, init_hit_s=hit_s, dense_init_s=dense_init_s,
         steps=20, pinned_max_move=pin_move, max_move=free_move,
         deterministic=True, dense_vs_chunked_rel=dense_err, limit=2e-5,
         ms_per_step_chunked=ms_chunked, ms_per_step_dense=ms_dense,
         ms_per_step_bf16=ms_bf16, bf16_step_rel=bf16_err,
         bf16_step_rel_jax=BF16_STEP_REL_JAX,
         bf16_step_rel_tol=BF16_STEP_REL_TOL, long_drag=long_drag,
         frame=dict(n_active=int(out_big["n_active"]),
                    dropped_beam=int(out_big["dropped_beam"]),
                    dropped_window=int(out_big["dropped_window"]),
                    ms=big_frame_ms), launches=big_launches)
    assert dense_err <= 2e-5, dense_err
    assert pin_move <= 1e-2 < free_move, (pin_move, free_move)
    assert abs(bf16_err / BF16_STEP_REL_JAX - 1.0) <= BF16_STEP_REL_TOL, \
        bf16_err
    assert bool(torch.isfinite(out_big["tiles_image"]).all())
    assert int(out_big["n_active"]) > 0
    assert big_launches == only(tile_deformed_w64=1), big_launches

    # ---- the port's main_gui as a user runs it: fused, --cut, at its
    # default Newton depth (max_iter_num 100, num_seek_IP 1), and on the
    # 128-wide checkpoint
    fused_flags = ["--max_iter_num", "1", "--num_seek_IP", "3"]

    def main_gui(phase, extra, workspace="runs/quality_mlp_800"):
        out_dir = os.path.join(ROOT, "build", f"smoke_{phase}_frames")
        # the sim cache of a workspace goes under build/ or is off
        cache = [] if workspace.startswith("build") else ["--sim_cache", "0"]
        cmd = [sys.executable, "-m", "pienerf_tpu_torch.main_gui",
               "--workspace", workspace, "--exp_name", "cube",
               "--backbone", "mlp", "--sim_dx", "0.2", "--bound", "0.5",
               "--W", "400", "--H", "400", "--radius", "2.5", "--frames",
               "3", "--out_dir", out_dir, "--kres", "4",
               "--timing_on"] + cache + extra
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
        return json.loads(re.findall(r"kernel launches: (\{.*\})",
                                     res.stdout)[-1])

    # its default dtype is f32 (no -O): the tile kernel's f32 launches
    cut_flags = ["--cut", "--cut_bounds", "0.0", "0.5", "-0.5", "0.5",
                 "-0.5", "0.5"]
    gui_launches = {
        "main_gui": main_gui("main_gui", fused_flags),
        "main_gui_cut": main_gui("main_gui_cut", fused_flags + cut_flags)}
    main_gui("main_gui_newton", [])
    for phase, extra in (("main_gui_w128", fused_flags),
                         ("main_gui_w128_cut", fused_flags + cut_flags)):
        gui_launches[phase] = main_gui(
            phase, extra, workspace=os.path.relpath(wide_ws, ROOT))
    gui_f32 = {}
    for got in gui_launches.values():
        for k_, v in got.items():
            if k_.startswith("tile_") and k_.endswith("_default_float32"):
                name = k_[:-len("_default_float32")]
                gui_f32[name] = gui_f32.get(name, 0) + v
    emit("main_gui_f32_launches", launches=gui_f32)
    assert all(gui_f32.get(f"tile_{m}_w{wd}", 0) > 0 for m in
               ("deformed", "static", "cut") for wd in (64, 128)), gui_f32

    # ---- main_sim as a user runs it, on a written PLY (the cube of the
    # verify recipe: pinned on one side, sagging under gravity)
    g = np.linspace(0.3, 0.7, 8) - 0.5
    gx, gy, gz = np.meshgrid(g, g, g, indexing="ij")
    cube = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], 1)
    ncube = len(cube)
    cube_ply = os.path.join(ROOT, "build", "smoke_cube.ply")
    write_ply(cube_ply, cube, vp=np.full(ncube, 1e-3),
              pin=(cube[:, 1] > 0.15).astype(float), lam=np.full(ncube, 1e4),
              mu=np.full(ncube, 1e4), mass=np.full(ncube, 0.1))
    sim_out = os.path.join(ROOT, "build", "smoke_sim_out")
    shutil.rmtree(sim_out, ignore_errors=True)
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "pienerf_tpu_torch.main_sim", "--ply",
         cube_ply, "--steps", "30", "--sim_dx", "0.2", "--kres", "4",
         "--bound", "0.5", "--out_dir", sim_out],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    plys = sorted(os.listdir(sim_out)) if os.path.isdir(sim_out) else []
    emit("main_sim", rc=res.returncode, seconds=time.perf_counter() - t0,
         plys=plys, tail=res.stdout.strip().splitlines()[-2:])
    assert res.returncode == 0, res.stderr[-4000:]
    assert plys == [f"pnt_{i:05d}.ply" for i in range(0, 30, 10)], plys
    last = read_ply(os.path.join(sim_out, plys[-1]))
    last = np.stack([last[k] for k in ("x", "y", "z")], 1)
    assert np.isfinite(last).all() and last.shape == cube.shape
    assert (last[cube[:, 1] <= 0.15, 1] - cube[cube[:, 1] <= 0.15, 1]
            ).mean() < 0.0

    # ---- main path 3: the non-fused render paths
    render_launches = main_path_3(path3)

    # ---- main path 4: train -> distill -> serve
    path4 = types.SimpleNamespace(dev=dev, tk=tk, reset_counts=reset_counts,
                                  read_counts=read_counts,
                                  read_f32_counts=read_f32_counts, only=only)
    train_launches = main_path_4(path4)

    # ---- main path 5: the point cloud and the live viewer
    viewer_launches = main_path_5(path4, train_launches)

    # ---- the last modules: LPIPS, CLIP, the asset chain, the sharded paths
    last_launches = main_path_6(path4, train_launches)

    # ---- every (kernel, mode, width) with its launches on its main path:
    # field kernel, the Newton frame (Wd 64) and the wide fidelity oracle
    # (Wd 128); tile kernel, main path 1 (deformed) and main path 2 (the
    # cache pass and the cut frames), at each width
    def row(name, source, replaces, launches, reading, **extra):
        """One entry of the kernels line; ``library_ms`` only where one
        PyTorch call computes the same function; ``before_ms`` where the
        baseline's kernel was timed in turns. Every number is this run's;
        the earlier commits' times are on the prior_ms line."""
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": reading.get("max_abs_err",
                                           reading.get("rgb_max_abs")),
                "ms": reading["ms"], "plain_ms": reading["plain_ms"],
                "bound_ms": reading["bound_ms"],
                "bound_by": reading.get("bound_by", "operations"),
                "library_ms": reading.get("library_ms"),
                **{k: reading[k] for k in ("before_ms",) if k in reading},
                **extra}

    def bf16_field(wd):
        """The field rows' bf16 reading (the rows themselves are f32) and
        the bf16 kernel's launches in the Newton frame under -O; at Wd 64
        also the f32 kernel's launches in main_render's frame."""
        r = field_rows[wd]["bfloat16"]
        extra = ({"main_render_launches": render_launches["w64_float32"]}
                 if wd == 64 else {})
        if "before_ms" in r:
            extra["bf16_before_ms"] = r["before_ms"]
        return dict(bf16_launches=newton16_launches[wd], bf16_ms=r["ms"],
                    bf16_max_abs_err=r["rgb_max_abs"],
                    bf16_bound_ms=r["bound_ms"], **extra)

    def p5(key):
        """Main path 5's launches of a tile row (the viewers, the
        distill_table smoke), beside the row's own main-path count."""
        n = viewer_launches.get(key, 0)
        assert n > 0, (key, viewer_launches)
        return {"viewer_path_launches": n}

    def p6(**fields):
        """This slice's launches of a row (``asset_chain_launches``: the
        hash-grid chain; ``sharded_path_launches``: rank 0 of the sharded
        dryrun), beside the row's own main-path count; a key ending in
        "*" sums the paired keys it begins."""
        out = {}
        for name, (phase, key) in fields.items():
            got = last_launches[phase]
            n = (sum(v for k_, v in got.items() if k_.startswith(key[:-1])
                     and "_paired" in k_)
                 if key.endswith("*") else printed(got, key))
            assert n > 0, (name, key, got)
            out[name] = n
        return out

    def f32_tile(r32, **by_path):
        """A tile row's f32 reading (the row itself is the bf16 one): ms,
        the baseline's ms when one was built, plain ms, bound and error on
        the same inputs, and its f32 launches by main path."""
        out = {f"f32_{k}": r32[k] for k in (
            "ms", "before_ms", "plain_ms", "bound_ms", "bound_by",
            "max_abs_err", "executed_segments") if k in r32}
        out.update(f32_launches=sum(by_path.values()),
                   f32_launches_by_path=by_path)
        return out

    fsrc = ("pienerf_tpu_torch/csrc/field_kernel.cu",
            "pienerf_tpu/ops/pallas/field_kernel.py:134")
    tsrc = ("pienerf_tpu_torch/csrc/tile_kernel.cu",
            "pienerf_tpu/ops/pallas/tile_kernel.py:238")
    tpsrc = ("pienerf_tpu_torch/csrc/tile_kernel_paired.cu", tsrc[1])
    psrc = "pienerf_tpu_torch/csrc/probe_kernels.cu"
    probe_lines = {"onehot": 83, "dma": 127, "take": 187, "dynslice": 217}
    kernels = [
        row("field_kernel", *fsrc, newton_launches["field_w64"],
            field_rows[64]["float32"], **bf16_field(64),
            **p6(sharded_path_launches=("sharded", "field_w64_float32"))),
        row("tile_kernel", *tsrc, frame_launches["tile_deformed_w64"],
            tile_row, **p6(
                asset_chain_launches=("asset_chain", "tile_deformed_w64"),
                sharded_path_launches=("sharded",
                                       "tile_deformed_w64_default")),
            **f32_tile(tile_rows["float32"], frame_f32=f32frame_info[
                "f32_launches"]["tile_deformed_w64"],
                fidelity=fid_f32["tile_deformed_w64"],
                main_gui=gui_f32["tile_deformed_w64"])),
        row("tile_kernel_static", *tsrc, cut_launches["tile_static_w64"],
            rows_c["static"], **p5("tile_static_w64"),
            **p6(asset_chain_launches=("asset_chain", "tile_static_w64")),
            **f32_tile(rows_c32["static"],
                       main_gui=gui_f32["tile_static_w64"])),
        row("tile_kernel_cut", *tsrc, cut_launches["tile_cut_w64"],
            rows_c["cut"], **f32_tile(
                rows_c32["cut"], fidelity=cfid_f32["tile_cut_w64"],
                main_gui=gui_f32["tile_cut_w64"])),
        row("field_kernel_w128", *fsrc, wfid_launches["field_w128"],
            field_rows[128]["float32"], **bf16_field(128),
            train_path_launches=train_launches["field_w128"]),
        row("tile_kernel_w128", *tsrc, wframe_launches["tile_deformed_w128"],
            tile_row_w, **p5("tile_deformed_w128"),
            **f32_tile(tile_rows_w["float32"],
                       fidelity=wfid_f32["tile_deformed_w128"],
                       main_gui=gui_f32["tile_deformed_w128"])),
        row("tile_kernel_static_w128", *tsrc,
            wcut_launches["tile_static_w128"], rows_c["static_w128"],
            train_path_launches=train_launches["tile_static_w128"],
            **p5("tile_static_w128"), **f32_tile(
                rows_c32["static_w128"],
                train=train_launches["tile_static_w128_f32"],
                main_gui=gui_f32["tile_static_w128"])),
        row("tile_kernel_cut_w128", *tsrc, wcut_launches["tile_cut_w128"],
            rows_c["cut_w128"], **p5("tile_cut_w128"),
            **f32_tile(rows_c32["cut_w128"],
                       main_gui=gui_f32["tile_cut_w128"])),
        # the schedules: the paired deformed mode and block_tiles on their
        # bench frames; the paired static and cut modes on a cut frame run
        # below with the paired pack; their f32 readings on the checks'
        # inputs (no main path runs them in f32)
        row("tile_kernel_paired", *tpsrc,
            pframe_launches["tile_deformed_paired"], rows_p["deformed"],
            **p6(sharded_path_launches=("sharded", "tile_deformed_*")),
            **f32_tile(rows_p["deformed"]["f32"])),
        row("tile_kernel_paired_static", *tpsrc,
            pcut_launches["tile_static_paired"], rows_p["static"],
            **f32_tile(rows_p["static"]["f32"])),
        row("tile_kernel_paired_cut", *tpsrc,
            pcut_launches["tile_cut_paired"], rows_p["cut"],
            **f32_tile(rows_p["cut"]["f32"])),
        row("tile_kernel_block",
            "pienerf_tpu_torch/csrc/tile_kernel_block.cu", tsrc[1],
            bframe_launches["tile_deformed_w64_block"], rows_b[64, 4],
            **f32_tile(rows_b[64, 4]["f32"])),
    ] + [
        # torch-ngp's hash-grid net: f32 rows; its launches on main path 1
        # (deformed), the others on the checks' passes
        row(f"tile_kernel_hashgrid_{m}",
            "pienerf_tpu_torch/csrc/tile_kernel_grid.cu", "none",
            grid_launches["tile_deformed_hashgrid"] if m == "deformed"
            else 1, grid_rows[m], counters_ms=grid_rows[m]["counters_ms"],
            counters_cost=grid_rows[m]["counters_cost"],
            rows_per_sample=grid_rows[m]["rows_per_sample"],
            frame_ms=grid_info["ms_per_frame"] if m == "deformed" else None)
        for m in ("deformed", "static", "cut")
    ] + [
        row(f"{n}_fetch", psrc,
            f"tools/pallas_gather_probe.py:{probe_lines[n]}",
            probe_launches[f"fetch_{n}"], fetch_rows[n],
            **(onehot_ops if n == "onehot" else
               {"vs_library": fetch_rows[n]["vs_library"]}
               if n in ("dma", "dynslice") else {}))
        for n in pk.FETCHES
    ] + [
        row("floor_shell", psrc, "tools/micro_floor.py:56",
            floor_launches["floor_shell"], shell_row),
    ]
    assert all(k["launches"] > 0 for k in kernels), kernels
    # the earlier commits' times, constants of this file and not this
    # run's readings, on their own line beside the kernels line
    emit("prior_ms", pr4_ms=PRIOR_MS, pr4_field_bf16_ms=PRIOR_FIELD_BF16_MS,
         pr5_ms=PR5_MS, pr6_ms=PR6_MS, pr7_ms=PR7_MS, pr13_ms=PR13_MS)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
