"""device_idle_share (%): the share of a frame in which no kernel, copy or
set runs on the device: 1 - the device's busy time a frame (the union of
its spans in the traced loops, over their frames) over the untraced
frame's wall time. The profiler slows the host, so the traced window's
own idle share (``busy_s`` over ``window_s``) reads higher."""


def read(ctx):
    busy, frames, ms = ctx.get("busy_s"), ctx.get("frames"), ctx.get(
        "frame_ms")
    if not busy or not frames or not ms:
        return None
    return 100.0 * (1.0 - 1e3 * busy / frames / ms)
