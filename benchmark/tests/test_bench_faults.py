"""A run with the timed path broken underneath it must come out not
correct: the whole run is driven on the CPU at a tiny size (the card's
look skipped), once sound and once for each fault a paused-orbit cell can
have. One chip, so no exchange between chips to leave out."""

import pytest

from benchmark import run as bench_run

SEED = 2 ** 31 + 12345


def _run(tiny, tmp_path, workload="bench_w128_f32.orbit"):
    return bench_run.run(workload, SEED, 0.2, False, "cpu", overrides=tiny,
                         cache_dir=str(tmp_path))


@pytest.mark.parametrize("workload", ["bench_w128_f32.orbit",
                                      "trex_w64_f32.cut_orbit"])
def test_sound_run_is_correct(workload, tiny, tmp_path):
    res = _run(tiny, tmp_path, workload)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"frame_ms", "frame_p95_ms", "setup_s"}
    assert res["attempted"] >= 24 and res["attempted"] % 24 == 0


def _tile_fault(kind):
    from pienerf_tpu_torch.kernels import tile

    real = tile.render_tiles

    def broken(spec, packed_w, tile_sc, *a, **kw):
        out = real(spec, packed_w, tile_sc, *a, **kw)
        if kind == "half_batch":            # every other active slot never
            act = (tile_sc[:, 2] > 0).nonzero()[:, 0]      # rendered
            out[act[1::2]] = 0.0
        else:                               # one answer altered where made
            out[0, 0, :] += 0.25
        return out
    return broken


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
def test_broken_timed_path_is_not_correct(fault, tiny, tmp_path,
                                          monkeypatch):
    if fault == "state_unchanged":
        from pienerf_tpu_torch.sim import solver
        monkeypatch.setattr(solver, "sim_step",
                            lambda consts, state, reduce=None: state)
    else:
        from pienerf_tpu_torch.kernels import tile
        monkeypatch.setattr(tile, "render_tiles", _tile_fault(fault))
    res = _run(tiny, tmp_path)
    assert res["correct"] is False
    failed = {k for k, c in res["checks"].items()
              if c["value"] is None or c["value"] > c["limit"]}
    assert failed, res["checks"]
