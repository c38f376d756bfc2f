"""The correctness check's control on the card, at a size a test run
holds: the program passes each cell's limits, and the plain reference put
in its place with its f32 products in TF32 (the nearest precision below
the configuration's true f32) fails them.

    python -m pytest benchmark/tests -q -m card      # on a CUDA machine
"""

import pytest

from benchmark import cell, check

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
