"""grid_encode_ms (ms): device time a frame of the hash-grid tile kernel's
encode stage (``csrc/grid_encode.cuh`` in ``csrc/tile_kernel.cuh``):
``tile_kernel_ms`` times the encode stage's share of the kernel's warp
cycles in the traced loops (``gridcount.read``: encode cycles over whole
tile cycles, summed over warps). None where the program keeps no such
counters."""

from benchmark import gridcount


def read(ctx):
    c = gridcount.read(ctx)
    if c is None:
        return None
    return ctx["tile_kernel_ms"] * c["encode_cycles"] / c["tile_cycles"]
