"""Configuration for the full pipeline.

Mirrors the reference flag surface (reference: get_opts.py:1-123) as a typed
dataclass instead of an argparse Namespace threaded through **kwargs. Derived
values and dataset presets (reference: get_opts.py:96-120) are applied by
`finalize()`.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class PieNeRFConfig:
    # paths / bookkeeping
    path: Optional[str] = None
    O: bool = False  # noqa: E741 — matches the reference's `-O` preset flag
    test: bool = False
    workspace: str = "workspace"
    seed: int = 0

    # training
    iters: int = 30000
    lr: float = 1e-2
    # TPU extra (default = reference behavior): final lr = lr * lr_decay_rate
    # after `iters` steps (reference main_train.py:69-74 hardcodes 0.1).
    lr_decay_rate: float = 0.1
    # TPU extra (default off): from this global step on, train in float32
    # instead of cfg.compute_dtype. Counters coherent Adam drift at the
    # bf16 output-quantization floor (PERF_TPU_HISTORY.md "Training
    # quality at scale").
    precision_tail_start: Optional[int] = None
    ckpt: str = "latest"
    num_rays: int = 4096
    cuda_ray: bool = False  # kept for CLI parity; selects the occupancy-grid path
    max_steps: int = 1024
    num_steps: int = 512
    upsample_steps: int = 0
    update_extra_interval: int = 16
    max_ray_batch: int = 4096
    patch_size: int = 1
    T_thresh: float = 1e-2

    # backbone
    fp16: bool = False  # on TPU this selects bfloat16 compute for the MLPs
    ff: bool = False
    tcnn: bool = False

    # dataset
    color_space: str = "srgb"
    preload: bool = False
    bound: float = 2.0
    scale: float = 0.33
    offset: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])
    dt_gamma: float = 1.0 / 128.0
    min_near: float = 0.2
    density_thresh: float = 10.0
    bg_radius: float = -1.0

    # GUI
    gui: bool = False
    W: int = 1920
    H: int = 1080
    radius: float = 5.0
    fovy: float = 50.0
    max_spp: int = 64

    # experimental
    error_map: bool = False
    clip_text: str = ""
    rand_pose: int = -1

    # model / sampling identifiers
    exp_name: str = "exp"
    ckpt_path: Optional[str] = None
    vres: int = 96
    con: int = 1
    dataset_type: str = ""

    # sampling
    density_threshold: float = 0.05
    sub_coeff: float = 0.1
    sub_res: int = 20
    cut: bool = False
    cut_bounds: List[float] = field(
        default_factory=lambda: [0.0, 2.0, -2.0, 1.0, -1.42, 0.92]
    )

    # deformed rendering
    num_seek_IP: int = 1
    timing_on: bool = False
    output_ply: bool = False
    max_iter_num: int = 100

    # simulator
    sim_dt: float = 1e-2
    sim_dx: float = 0.05
    sim_iters: int = 10
    sim_stiff: float = 1e5
    # TPU-build extra: advance the sim sim_substeps times per frame at
    # dt = sim_dt / sim_substeps (finer time resolution for fast dynamics;
    # measured envelope in tools/diverge_probe.py). 1 = reference behavior.
    sim_substeps: int = 1
    # TPU-build extra: crop each tile's march range to its bend-candidate
    # span before sampling (lossless in deformed non-cut mode, auto-disabled
    # in cut mode; concentrates quadrature on the object —
    # PERF_TPU_HISTORY.md "Sampling density"). Default-on since round 3:
    # +0.6 dB at -6% FPS on the trained-field frontier.
    tighten_sampling: bool = True
    # TPU-build extra: depth samples per ray in the interactive tile path —
    # the quality/rate slider. Default 128 since round 3: on a TRAINED
    # field the frontier is shallow in FPS (the kernel is not sample-bound;
    # PERF_TPU_HISTORY.md trained-field table: K=32 -> 81 FPS/27.8
    # dB-vs-dense, K=128+tighten -> 59 FPS/34.9 dB), so fidelity is bought with K
    # directly instead of adaptive sample placement.
    render_samples: int = 128
    # TPU-build extra: cache the one-time f64 sim precompute per scene
    # (content-addressed npz under <workspace>/sim_cache; 140-410 s at 24k
    # IPs -> seconds on a warm start). 0 disables.
    sim_cache: int = 1
    # TPU-build extra: store the sim's B assembly operator in bfloat16
    # (f32 accumulation) — halves its HBM traffic for >25k-IP scenes
    # (PERF_TPU_HISTORY.md sim-scaling; trajectory-verified in
    # tests/test_solver.py).
    sim_bf16_b: bool = False

    # derived (set by finalize)
    hash_grid_size: float = 0.0

    # --- TPU-specific knobs (no reference equivalent) ---
    # samples evaluated per render round per ray (static shape)
    render_chunk_samples: int = 16
    # max compacted samples per training ray
    train_max_samples: int = 64
    # rays per render batch (tiles the image; static shape)
    render_ray_chunk: int = 65536
    # max IP candidates gathered per spatial-hash cell in the bending search
    bend_max_per_cell: int = 16
    # compute dtype for network matmuls: "float32" or "bfloat16"
    compute_dtype: str = "float32"
    # field backbone: "hashgrid" (reference-compatible) or "mlp"
    # (TPU-native gather-free flagship; see PERF_TPU_HISTORY.md)
    backbone: str = "hashgrid"

    def finalize(self) -> "PieNeRFConfig":
        """Apply derived values and dataset presets (get_opts.py:96-120)."""
        self.hash_grid_size = 1.2 * self.sim_dx
        self.num_seek_IP = max(min(3, self.num_seek_IP), 1)

        if self.dataset_type == "synthetic":
            self.scale = 0.8
            self.bound = 1.0
            self.dt_gamma = 0.0
            self.W = 800
            self.H = 800

        if self.O:
            self.fp16 = True
            self.cuda_ray = True
            self.preload = True

        if self.fp16:
            self.compute_dtype = "bfloat16"

        if self.patch_size > 1:
            self.error_map = False
            assert self.num_rays % (self.patch_size**2) == 0

        return self

    @property
    def cascade(self) -> int:
        import math

        return 1 + math.ceil(math.log2(max(self.bound, 1.0)))

    @property
    def grid_size(self) -> int:
        return 128


_BOOL_FLAGS = {
    "O", "test", "cuda_ray", "fp16", "ff", "tcnn", "preload", "gui",
    "error_map", "cut", "timing_on", "output_ply", "tighten_sampling",
    "sim_bf16_b",
}


def get_shared_opts(parser: Optional[argparse.ArgumentParser] = None,
                    args: Optional[List[str]] = None) -> PieNeRFConfig:
    """argparse bridge with the same flag names as the reference CLI."""
    if parser is None:
        parser = argparse.ArgumentParser()
    defaults = PieNeRFConfig()
    for f in dataclasses.fields(PieNeRFConfig):
        if f.name == "hash_grid_size":
            continue
        flag = f"--{f.name}" if f.name != "O" else "-O"
        if f.name in _BOOL_FLAGS:
            parser.add_argument(flag, action="store_true")
        elif f.name in ("offset", "cut_bounds"):
            nargs = 6 if f.name == "cut_bounds" else "*"
            parser.add_argument(flag, nargs=nargs, type=float,
                                default=getattr(defaults, f.name))
        else:
            typ = type(getattr(defaults, f.name)) if getattr(defaults, f.name) is not None else str
            parser.add_argument(flag, type=typ, default=getattr(defaults, f.name))
    ns = parser.parse_args(args)
    cfg = PieNeRFConfig(**{k: v for k, v in vars(ns).items()
                           if k in {f.name for f in dataclasses.fields(PieNeRFConfig)}})
    return cfg.finalize()
