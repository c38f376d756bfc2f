"""grid_rows_per_sample (count): hash-grid table rows the tile kernel read
per sample it encoded in the traced loops (``gridcount.read``): 16 levels
x 8 corners for a sample inside the grid's box, none outside, so at most
128; a kernel that merged corners' loads would read fewer. None where the
program keeps no such counters."""

from benchmark import gridcount


def read(ctx):
    c = gridcount.read(ctx)
    return None if c is None else c["rows"] / c["samples"]
