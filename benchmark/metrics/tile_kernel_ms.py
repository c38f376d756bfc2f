"""tile_kernel_ms (ms): device time a frame of every launch of the tile
kernel (``kernels/tile.py`` + ``csrc/tile_kernel.cuh``), read by kernel
name (``render_tiles_kernel*``) from the device trace."""


def read(ctx):
    return ctx.get("tile_kernel_ms")
