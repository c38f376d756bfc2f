"""render_issue_ms (ms): host time a frame inside the program's
``frame.render`` span (``render/interactive.py:render_frame_fused``) less
the sync calls inside it: the render path's own Python and launches.
None where the program opens no ``frame.*`` span."""

from benchmark import spans


def read(ctx):
    r = spans.attach(ctx)
    return None if r is None else r["render_issue_ms"]
