"""The hash-grid tile kernel's device counters of a traced run, for the
per-layer readers ``metrics/grid_encode_ms.py`` and
``metrics/grid_rows_per_sample.py``.

The program keeps them (``pienerf_tpu_torch/kernels/tile.py``:
``read_grid_counters``), summed over the hash-grid launches it made while
``torch.profiler`` recorded, so over a run's traced loops alone: warp
cycles in the encode stage, warp cycles of the whole tile, samples encoded
and table rows read (``csrc/grid_encode.cuh``). A program without them
(a parent commit) gives nothing, and neither does a run that reduced no
trace with a tile kernel in it.
"""

from __future__ import annotations

from typing import Dict, Optional


def read(ctx: dict) -> Optional[Dict[str, int]]:
    """The counters, or None where there are none to read."""
    if not ctx.get("tile_kernel_ms"):
        return None
    try:
        from pienerf_tpu_torch.kernels import tile
    except ImportError:
        return None
    fn = getattr(tile, "read_grid_counters", None)
    if fn is None:
        return None
    c = fn()
    return c if c.get("samples") and c.get("tile_cycles") else None
