"""The correctness check's control on the card, at a size a test run
holds: the program passes each cell's limits, and the plain reference put
in its place with its f32 products in TF32 (the nearest precision below
the configuration's true f32) fails them; and the hash-grid configuration's
stand-in field, fitted and rendered by the reference at its full size.

    python -m pytest benchmark/tests -q -m card      # on a CUDA machine
"""

import hashlib
import json
import math
import time

import numpy as np
import pytest
import torch

from benchmark import cell, check, work
from benchmark.reference import fit

# a quarter of each cell's pixels, the rest as the cell states
SMALL = {"bench_w128_f32.orbit": {"render": {"H": 400, "W": 400,
                                             "focal": 480.0}},
         "trex_w64_f32.cut_orbit": {"render": {"H": 368, "W": 496,
                                               "focal": 340.2}}}


@pytest.mark.card
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_program_passes_and_control_fails(workload, card, tmp_path):
    import pienerf_tpu_torch  # noqa: F401
    w = cell.workload(workload)
    limits = cell.load("limits", workload)
    inp = cell.make_inputs(w["config"], w["traffic"], 2 ** 33 + 21,
                           SMALL[workload])
    prog = cell.Program(inp, card, cache_dir=str(tmp_path))
    items = []
    for k in range(0, len(inp.poses), 4):
        img, ctr, _ = prog.frame(k)
        items.append((k, img, ctr))
    ddof, pack = prog.state.ddof.cpu().numpy(), prog.pack.cpu().numpy()
    ref = check.Reference(inp, card)
    sound = check.verdict(check.compare(ref, ddof, pack, items), limits)
    assert sound["correct"], sound["checks"]
    ctl = check.Reference(inp, card, tf32_sim=True, tf32_render=True)
    c_items = [(k,) + ctl.frame(k) for k, _, _ in items]
    control = check.verdict(check.compare(
        ref, ctl.ddof.cpu().numpy(), ctl.pack.cpu().numpy(), c_items),
        limits)
    assert not control["correct"], control["checks"]


def _psnr(a, b) -> float:
    mse = float(((np.asarray(a, np.float64) - b) ** 2).mean())
    return -10.0 * math.log10(max(mse, 1e-30))


@pytest.mark.card
def test_hashgrid_stand_in_fits_and_renders_like_the_committed_field(
        card, tmp_path, capfd, monkeypatch):
    """``ngp_hashgrid_f32`` at its published widths: two fits in fresh
    caches give the same table (SHA-256); the reference
    renders 2 orbit poses of the fitted field at the cell's full size, at
    30 dB or more against the committed field's frames there, with
    evaluated samples within 15% of ``bench_w128_f32``'s. Prints one JSON
    line of its readings (run with ``-s``), the fit's seconds among them:
    the fit is paced by the host's launches, so its time is a reading of
    the machine and not asserted."""
    cfg = cell.load("configs", "ngp_hashgrid_f32")
    fc, bound = cfg["field"], cfg["render"]["bound"]
    builds = []
    for i in range(2):
        t0 = time.perf_counter()
        layers = cell.fitted_field(fc, bound, cache_dir=str(tmp_path / str(i)))
        wall = time.perf_counter() - t0
        child = json.loads([ln for ln in capfd.readouterr().err.splitlines()
                            if "table_sha256" in ln][-1])
        sha = hashlib.sha256(layers["encoder"][0].tobytes()).hexdigest()
        assert sha == child["table_sha256"]
        builds.append({"wall_s": wall, **child})
    assert builds[0]["table_sha256"] == builds[1]["table_sha256"]

    monkeypatch.setattr(cell, "FIT_CACHE", str(tmp_path / "0"))
    seed = 2 ** 33 + 77
    sigma_in = cell._checkpoint(fc["fit"]["teacher"])["sigma_net"][0].shape[0]
    teacher = {"backbone": "mlp", "checkpoint": fc["fit"]["teacher"],
               "width": 64, "n_freqs": fit.teacher_n_freqs(sigma_in)}
    inps = {"hashgrid": cell.make_inputs("ngp_hashgrid_f32", "orbit", seed),
            "committed": cell.make_inputs("ngp_hashgrid_f32", "orbit", seed,
                                          {"field": teacher}),
            "bench": cell.make_inputs("bench_w128_f32", "orbit", seed)}
    torch.cuda.reset_peak_memory_stats(card)
    frames, passes = {}, {}
    for name, inp in inps.items():
        ref = check.Reference(inp, card)
        passes[name] = []
        frames[name] = [ref.frame(k, passes[name])[0] for k in (0, 12)]
        del ref
    peak = torch.cuda.max_memory_allocated(card)
    psnr = [_psnr(h, c) for h, c in zip(frames["hashgrid"],
                                        frames["committed"])]
    samples = {k: sum(p.samples for p in v) for k, v in passes.items()}
    hg = passes["hashgrid"]
    macs = check.ref_render.macs_per_sample(
        [inps["hashgrid"].layers[k] for k in ("sigma_net", "color_net")])
    assert macs == 9344
    grid_bytes = sum(p.grid_bytes for p in hg)
    readings = {
        "builds": builds, "memory_peak_bytes": peak, "psnr_db": psnr,
        "samples": samples,
        "samples_vs_bench": samples["hashgrid"] / samples["bench"],
        "grid_bytes": grid_bytes, "grid_flops": sum(p.grid_flops for p in hg),
        "grid_bytes_s": grid_bytes / work.PEAK_BYTES,
        "mlp_op_s": work.mlp_flops(hg, macs) / work.PEAK_F32,
        "least_s": work.least_seconds(hg, macs, 3, "float32")}
    print("hashgrid_card " + json.dumps(readings), flush=True)
    assert min(psnr) >= 30.0, readings
    assert abs(readings["samples_vs_bench"] - 1.0) <= 0.15, readings
