"""The hash-grid cell ``ngp_hashgrid_f32.orbit``: its two per-layer
readers on fixed counters, and a whole run of the cell on the CPU at a
tiny size (the port's plain tile path against the plain reference)."""

import pytest

from benchmark import cell
from benchmark import run as bench_run
from benchmark.run import read_metric

SEED = 2 ** 31 + 4321
# the published net's 16 levels x 2 features over a small table (levels
# 0-1 dense, 2-15 hashed into 128 rows), fitted for a few steps
TINY_FIELD = {"grid": {"num_levels": 16, "level_dim": 2,
                       "base_resolution": 2, "log2_hashmap_size": 7,
                       "desired_resolution": 65536},
              "fit": {"teacher": "runs/quality_mlp_800/checkpoints/"
                                 "ngp_ep0015.npz",
                      "seed": 3, "steps": 12, "batch": 2048}}
COUNTS = {"encode_cycles": 300, "tile_cycles": 1200, "samples": 50,
          "rows": 5120}


@pytest.fixture
def counters(monkeypatch):
    """The program's counters read as ``COUNTS`` (or what the test sets)."""
    from pienerf_tpu_torch.kernels import tile
    box = {"c": dict(COUNTS)}
    monkeypatch.setattr(tile, "read_grid_counters", lambda: box["c"])
    return box


def test_readers_on_fixed_counters(counters):
    ctx = {"tile_kernel_ms": 8.0}
    assert read_metric("grid_encode_ms", ctx) == pytest.approx(2.0)
    assert read_metric("grid_rows_per_sample", ctx) == pytest.approx(102.4)
    # nothing traced, or nothing encoded: nothing to read
    for name in ("grid_encode_ms", "grid_rows_per_sample"):
        assert read_metric(name, {}) is None
        assert read_metric(name, {"tile_kernel_ms": None}) is None
    counters["c"] = dict.fromkeys(COUNTS, 0)
    for name in ("grid_encode_ms", "grid_rows_per_sample"):
        assert read_metric(name, ctx) is None


def test_readers_read_nothing_from_a_program_without_counters(monkeypatch):
    """A program that keeps no hash-grid counters (a parent commit) gives
    no reading, and no error."""
    from pienerf_tpu_torch.kernels import tile
    monkeypatch.delattr(tile, "read_grid_counters")
    for name in ("grid_encode_ms", "grid_rows_per_sample"):
        assert read_metric(name, {"tile_kernel_ms": 8.0}) is None


def test_the_cell_lists_its_readers():
    spec = cell.benchmark_spec()
    names = cell.per_layer_names(spec, "ngp_hashgrid_f32.orbit")
    assert {"grid_encode_ms", "grid_rows_per_sample", "tile_roofline",
            "tile_kernel_ms"} <= set(names)
    for other in ("bench_w128_f32.orbit", "trex_w64_f32.cut_orbit"):
        assert "grid_encode_ms" not in cell.per_layer_names(spec, other)
    layers = {m["layer"] for m in spec["per_layer"]
              if m["name"].startswith("grid_")}
    assert layers == {"hash-grid encode (csrc/tile_kernel.cuh)"}


def test_sound_tiny_run_of_the_cell_is_correct(tiny, tmp_path, monkeypatch):
    monkeypatch.setattr(cell, "FIT_CACHE", str(tmp_path / "fit"))
    res = bench_run.run("ngp_hashgrid_f32.orbit", SEED, 0.2, False, "cpu",
                        overrides={**tiny, "field": TINY_FIELD},
                        cache_dir=str(tmp_path / "sim"))
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"frame_ms", "frame_p95_ms", "setup_s"}
    assert res["attempted"] >= 24 and res["attempted"] % 24 == 0
    # the frames agree with the reference's to rounding
    assert res["checks"]["image_rmse"]["value"] <= 1e-6
    assert res["checks"]["counters_diff"]["value"] == 0.0
