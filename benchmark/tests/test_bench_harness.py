"""The benchmark's files, its reference against the program's plain path,
its work count, and what a run may import."""

import ast
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import cell, check, work
from benchmark.reference import render as ref_render
from benchmark.run import read_metric

ROOT = cell.REPO
SPEC = cell.benchmark_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_json_keeps_to_its_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        names.add(c["name"])
    cells = [w["name"] for w in SPEC["workloads"]]
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_every_cell_finds_its_files_by_name(w):
    cfg = cell.load("configs", w["config"])
    assert cfg["name"] == w["config"] and cfg["dtype"] == "float32"
    tr = cell.load("traffic", w["traffic"])
    assert tr["orbit"]["poses"] * tr["orbit"]["step_deg"] == 360.0
    limits = cell.load("limits", w["name"])
    assert set(limits) == {"image_rmse", "flip_pixels", "counters_diff",
                           "window_drop_diff", "ddof_rel", "pack_rel"}
    for name in cell.per_layer_names(SPEC, w["name"]):
        assert read_metric(name, {}) is None     # nothing to read: nothing


def test_seeds_draw_the_same_frames_in_another_order():
    a = cell.make_inputs("bench_w128_f32", "orbit", 2 ** 33 + 5)
    b = cell.make_inputs("bench_w128_f32", "orbit", 17)
    key = lambda p: tuple(np.round(p[:3, 3], 5))        # noqa: E731
    assert sorted(map(key, a.poses)) == sorted(map(key, b.poses))
    assert [key(p) for p in a.poses] != [key(p) for p in b.poses]
    assert a.spring == b.spring
    assert np.array_equal(a.points, b.points)
    for k in ("sigma_net", "color_net"):
        for x, y in zip(a.layers[k], b.layers[k]):
            assert np.array_equal(x, y)


def test_wide_field_embeds_the_committed_one():
    """At Wd 128 the trained rows and columns are the checkpoint's, and
    every other weight is small and nonzero."""
    narrow = cell._layers({"field": {
        "checkpoint": "runs/quality_mlp_800/checkpoints/ngp_ep0015.npz",
        "width": 64}})
    wide = cell.make_inputs("bench_w128_f32", "orbit", 3).layers
    rows = np.concatenate([21 * a + np.r_[0, 1:9, 11:19] for a in range(3)])
    assert np.array_equal(wide["sigma_net"][0][rows, :64],
                          narrow["sigma_net"][0])
    assert np.array_equal(wide["color_net"][2][:64], narrow["color_net"][2])
    for w in wide["sigma_net"] + wide["color_net"]:
        assert np.all(w != 0.0)


def _agree(inp, tmp_path):
    """The program's frames on the CPU (its tile kernel takes the plain
    version there) against the frozen reference's: the numbers."""
    prog = cell.Program(inp, torch.device("cpu"), cache_dir=str(tmp_path))
    items = []
    for k in (0, 5, 11):
        img, ctr, _ = prog.frame(k)
        items.append((k, img, ctr))
        assert ctr[0] > 0                               # tiles were active
    ref = check.Reference(inp, torch.device("cpu"))
    assert float(np.abs(ref.ddof.numpy()).max()) > 1e-3   # it was dragged
    return check.compare(ref, prog.state.ddof.numpy(), prog.pack.numpy(),
                         items)


@pytest.mark.parametrize("workload,dtype", [
    ("bench_w128_f32.orbit", "float32"), ("trex_w64_f32.cut_orbit", "float32"),
    ("bench_w128_f32.orbit", "bfloat16")])
def test_reference_agrees_with_the_program_plain_path(workload, dtype, tiny,
                                                      tmp_path):
    """The frozen reference gives the program's frames, state and pack, in
    the configuration's field dtype."""
    w = cell.workload(workload)
    inp = cell.make_inputs(w["config"], w["traffic"], 2 ** 32 + 9,
                           {**tiny, "dtype": dtype})
    nums = _agree(inp, tmp_path)
    assert nums["counters_diff"] == 0.0 and nums["window_drop_diff"] == 0.0
    assert nums["ddof_rel"] <= 1e-6 and nums["pack_rel"] <= 1e-6
    assert nums["image_rmse"] <= 1e-6


@pytest.mark.parametrize("workload", ["bench_w128_f32.orbit",
                                      "trex_w64_f32.cut_orbit"])
def test_a_frame_needs_fewer_samples_than_its_live_tiles_march(workload,
                                                               tiny):
    """Every pass of a tiny frame needs some samples, no more than its
    slots' rays march, and a bending pass some window rows."""
    w = cell.workload(workload)
    inp = cell.make_inputs(w["config"], w["traffic"], 7, tiny)
    passes = []
    check.Reference(inp, torch.device("cpu")).frame(0, passes)
    assert {p.mode for p in passes} == (
        {"cut", "static"} if inp.cfg["render"]["cut"] else {"deformed"})
    for p in passes:
        assert 0 < p.samples < p.slots * 256 * tiny["render"]["K"], p
        assert (p.bend_rows > 0) == (p.mode != "static"), p


def _static_pass(T_thresh, miss_rays):
    """A static pass of one active and one idle tile, the rays along +z
    through the box from t = 1 to 3 (the first ``miss_rays`` along +x,
    past the box), 16 samples, zero weights (sigma = 1 everywhere)."""
    st = ref_render.Settings(
        samples=16, num_seek=1, ip_dx=0.05, ips_per_tile=64, bend_window=64,
        active_frac=1.0, tile_chunk=1, min_near=0.05, T_thresh=T_thresh,
        tighten=False, cut=False, bound=1.0, cut_static_frac=1.0, n_freqs=8)
    layers = ([torch.zeros(s) for s in ((51, 64), (64, 64), (64, 64),
                                        (64, 16))],
              [torch.zeros(s) for s in ((31, 64), (64, 64), (64, 3))])
    tile_sc = torch.tensor([[1.0, 3.0, 1.0] + [0.0] * 5, [0.0] * 8])
    params = torch.zeros(24)
    params[0:3] = torch.tensor([0.0, 0.0, -2.0])
    params[3:6], params[6:9] = -1.0, 1.0
    params[9], params[10], params[12], params[19] = T_thresh, 1.0, 0.05, 0.5
    dirs = torch.zeros((2, 8, 256))
    dirs[:, 2] = 1.0
    dirs[:, 2, :miss_rays], dirs[:, 0, :miss_rays] = 0.0, 1.0
    w = {"samples": 0, "bend_rows": 0}
    out = ref_render.render_tiles(st, layers, tile_sc, None, params, dirs,
                                  None, deformed=False, cut=False, work=w)
    return w, out, layers


@pytest.mark.parametrize("T_thresh,miss_rays,samples,t_end", [
    # the transmittance ends at e^-2 > T_thresh: all 256 rays take all 16
    # samples, the idle tile none
    (1e-2, 0, 256 * 16, np.exp(-2.0)),
    # T before sample k is e^-k/8, at or above 0.3 for k <= 9: each ray
    # that hits the box needs 10 samples; the 128 that miss it keep the
    # tile alive to the end and need none
    (0.3, 128, 128 * 10, np.exp(-10 / 8))])
def test_work_count_matches_a_hand_count(T_thresh, miss_rays, samples,
                                         t_end):
    w, out, _ = _static_pass(T_thresh, miss_rays)
    assert w == {"samples": samples, "bend_rows": 0}
    ws = torch.full((256,), 1.0 - t_end)
    ws[:miss_rays] = 0.0
    assert torch.allclose(out[0, 4], ws, atol=1e-6)


def test_least_time_and_flops_from_a_pass():
    macs = ref_render.macs_per_sample(_static_pass(1e-2, 0)[2])
    assert macs == 18752
    p = ref_render.Pass(mode="static", slots=2, samples=4096, bend_rows=0,
                        bytes=1000)
    assert work.mlp_flops([p], macs) == 2 * 18752 * 4096
    assert work.least_seconds([p], macs, 1, "float32") == pytest.approx(
        2 * 18752 * 4096 / 67e12)
    bent = p._replace(mode="deformed", bend_rows=10 ** 6)
    assert work.least_seconds([bent], macs, 3, "float32") == pytest.approx(
        (2 * 18752 * 4096 + 11 * 10 ** 6) / 67e12)
    heavy = p._replace(bytes=10 ** 10)
    assert work.least_seconds([heavy], macs, 1, "float32") == pytest.approx(
        1e10 / 3.35e12)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _relative_levels(path):
    tree = ast.parse(open(path).read())
    return [node.level for node in ast.walk(tree)
            if isinstance(node, ast.ImportFrom) and node.level > 0]


def test_nothing_imports_jax_and_the_reference_nothing_of_the_program():
    bench = os.path.join(ROOT, "benchmark")
    for dirpath, _, files in os.walk(bench):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            tops = {m.split(".")[0] for m in _imports(path)}
            assert not tops & {"jax", "jaxlib", "flax", "pienerf_tpu"}, path
            if os.sep + "reference" + os.sep in path:
                assert tops <= {"__future__", "math", "typing", "numpy",
                                "torch"}, (path, tops)
                # a relative import reaches only the reference's own files
                assert set(_relative_levels(path)) <= {1}, path


def test_a_run_loads_no_jax_module():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark import run, cell, check, trace, work\n"
            "import pienerf_tpu_torch.web_viewer\n"
            "import pienerf_tpu_torch.render.interactive\n"
            "print(run.forbidden_modules())\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_without_a_card_a_run_prints_no_result():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "bench_w128_f32.orbit", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout == ""
