"""tile_roofline (%): the least time the card could render a frame's tile
passes in, over ``tile_kernel_ms``. The least time sums, over the passes,
the larger of the pass's operations over the peak and its bytes over the
bandwidth (``work.least_seconds``), from the work the reference counts at
the traced frames' poses; a frame averages over the orbit's poses, as the
traced loops do."""


def read(ctx):
    tile_ms = ctx.get("tile_kernel_ms")
    least = ctx.get("least_ms")
    if not tile_ms or not least:
        return None
    return 100.0 * least / tile_ms
