"""host_ms (ms): the viewer loop's paused branch as the benchmark drives
it, host side: the mean host time of an untraced frame from its start
until the fetch is issued (the pose upload, the pack's and the render's
launches, and any host sync inside them)."""


def read(ctx):
    v = ctx.get("host_ms")
    return sum(v) / len(v) if v else None
