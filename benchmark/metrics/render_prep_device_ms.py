"""render_prep_device_ms (ms): device time a frame of the kernels launched
in the ``bench.render`` range other than the tile kernel: tile activity,
the candidate gate, compaction and the cut split
(``render/interactive.py``), ``kernels/tile.py:prep_candidates``, the
frame's scatter."""


def read(ctx):
    v = ctx.get("span_device_ms", {}).get("bench.render")
    return v if v else None
